"""Worklist nearest-hit trace (port of ``pathtracerap_tpu/pallas/trace.py``).

The per-ray-tile block worklists are built in plain torch
(:func:`_tile_block_lists`), sorted front to back and padded with -1; the
nearest-hit sweep over them is kernel 1, ``csrc/trace_list.cu``, which
replaces the TPU kernel ``pallas/trace.py::_fused_list_kernel``.

:func:`nearest_hit_fused` is the kernel's wrapper: on a CUDA tensor it
launches the kernel (and counts the launch), on a CPU tensor it runs the
plain version :func:`nearest_hit_fused_plain`, which sweeps every real
block instead of the worklist.  The worklist contract (never drop a block
a live ray can hit; exact-t ties to the lowest baked index) makes the two
return the same (t, idx).
"""

from __future__ import annotations

import ctypes

import torch

from pathtracerap_tpu import constants

from ..ops.intersect import HitRecord
from ..ops.math import cross3, normalize
from ..ops.plucker import hit_record
from ..scene.types import WorldTriangles
from . import _build

F_MAX = constants.FLOAT_MAX
EPS = constants.EPSILON

RAY_TILE = 512
# Above this many worklist units the per-ray slab pass would build
# (N, nb, 3) temporaries of gigabytes; a per-tile frustum test is used.
FRUSTUM_LIST_THRESHOLD = 48
PLAIN_CHUNK = 8192  # rays per chunk of the plain versions' products


def _slab_margin(block_aabb: torch.Tensor) -> torch.Tensor:
    """Scale-relative conservative slab-test margin (0-d tensor): covers
    the reference's tiny-negative-t accepts (``t >= -EPS``) and f32 slab
    arithmetic error, which grows with coordinate magnitude."""
    box = block_aabb[:, 0:6].abs()
    scale = torch.where(box < F_MAX, box, 0.0).amax()
    return EPS + 1e-5 * scale


def _tile_block_lists(block_aabb, ro, rd_n, alive, ray_tile: int, margin=None):
    """(nt, nb) int32 worklists: per ray tile, the boxes any live ray's slab
    test can reach, sorted by the tile's min entry distance, -1 padded.

    Two branches with one contract (conservative: never drops a box a live
    ray could hit): exact per-ray slab tests at ``nb <= 48``; above that a
    per-tile interval-arithmetic frustum test.  NaN boxes (padding) are
    rejected by both: NaN compares false."""
    if margin is None:
        margin = _slab_margin(block_aabb)
    nb = block_aabb.shape[0]
    nt = ro.shape[0] // ray_tile
    bmin = block_aabb[:, 0:3]
    bmax = block_aabb[:, 3:6]
    small = rd_n.abs() < 1e-12
    inv_d = 1.0 / torch.where(small, torch.where(rd_n < 0.0, -1e-12, 1e-12), rd_n)

    if nb <= FRUSTUM_LIST_THRESHOLD:
        lo = (bmin[None, :, :] - ro[:, None, :]) * inv_d[:, None, :]  # (N, nb, 3)
        hi = (bmax[None, :, :] - ro[:, None, :]) * inv_d[:, None, :]
        tmin = torch.minimum(lo, hi).amax(dim=-1)  # (N, nb)
        tmax = torch.maximum(lo, hi).amin(dim=-1)
        del lo, hi
        hit = (tmax >= -margin) & (tmin <= tmax + margin) & (alive > 0.0)
        key = torch.where(hit, tmin, torch.inf).reshape(nt, ray_tile, nb).amin(dim=1)
    else:
        # live-ray-only tile summaries (dead lanes would blow up the boxes)
        live = (alive > 0.0).reshape(nt, ray_tile, 1)
        ro_t = ro.reshape(nt, ray_tile, 3)
        iv_t = inv_d.reshape(nt, ray_tile, 3)
        o_lo = torch.where(live, ro_t, torch.inf).amin(dim=1)  # (nt, 3)
        o_hi = torch.where(live, ro_t, -torch.inf).amax(dim=1)
        i_lo = torch.where(live, iv_t, torch.inf).amin(dim=1)
        i_hi = torch.where(live, iv_t, -torch.inf).amax(dim=1)
        any_live = live.any(dim=1)  # (nt, 1)

        # interval products t = (b - o) * inv_d over o in [o_lo, o_hi] and
        # inv_d in [i_lo, i_hi]: all 4 corner products per bound; an axis
        # whose inv_d interval spans +-inf yields [-inf, +inf]
        def minmax(b):  # (nb, 3) -> 2 x (nt, nb, 3)
            d = b[None, :, :, None] - torch.stack([o_lo, o_hi], -1)[:, None, :, :]
            iv = torch.stack([i_lo, i_hi], -1)[:, None, :, :]
            c = (d[..., :, None] * iv[..., None, :]).reshape(nt, nb, 3, 4)
            # 0 * inf = NaN: replace it by +-inf on the safe side
            nan = torch.isnan(c)
            return (
                torch.where(nan, -torch.inf, c).amin(dim=-1),
                torch.where(nan, torch.inf, c).amax(dim=-1),
            )

        lo_n_lo, lo_n_hi = minmax(bmin)
        hi_n_lo, hi_n_hi = minmax(bmax)
        near_lo = torch.minimum(lo_n_lo, hi_n_lo)  # (nt, nb, 3)
        far_hi = torch.maximum(lo_n_hi, hi_n_hi)
        tmin_lb = near_lo.amax(dim=-1)  # (nt, nb)
        tmax_ub = far_hi.amin(dim=-1)
        hit = (tmax_ub >= -margin) & (tmin_lb <= tmax_ub + margin) & any_live
        # the NaN corners were replaced above, so NaN padding boxes must be
        # excluded explicitly here
        hit = hit & ~torch.isnan(block_aabb[:, 0])[None, :]
        key = torch.where(hit, tmin_lb, torch.inf)

    order = torch.argsort(key, dim=1, stable=True)
    skey = torch.gather(key, 1, order)
    return torch.where(torch.isfinite(skey), order, -1).to(torch.int32)


def _group_sub_lists(lists: torch.Tensor, group: int) -> torch.Tensor:
    """Regroup (nt, nsb) tmin-sorted worklists into visit groups of
    ``group`` entries: a group is live iff its first entry is >= 0 (live
    groups are a prefix of each row), ids ascend inside a live group, and
    short groups repeat their first id.

    This is the layout of the TPU kernel's sub-block visits; the CUDA
    kernels read the raw sorted lists and do not need it."""
    nt, nsb = lists.shape
    pad = (-nsb) % group
    if pad:
        lists = torch.cat([lists, lists.new_full((nt, pad), -1)], dim=1)
    g = lists.reshape(nt, -1, group)
    big = 2**30
    g = torch.where(g < 0, big, g).sort(dim=2).values  # ascending, pads last
    first = g[:, :, 0:1]
    g = torch.where(g >= big, first, g)  # repeat the first id over the pad tail
    g = torch.where(first >= big, -1, g)  # fully-dead group -> all -1
    return g.reshape(nt, -1)


def accept_nearest(s: torch.Tensor, tri_block: int):
    """Epsilon-guarded Moeller-Trumbore accept and nearest hit from the
    side/plane products ``s`` (R, nb * 4 * TB) of ``nb`` consecutive blocks
    starting at block 0.  Returns (t (R,), idx (R,) int64, -1 on a miss);
    exact-t ties go to the lowest index."""
    r = s.shape[0]
    s = s.reshape(r, -1, 4, tri_block)
    s_ab, s_bc, s_ca, num = s[:, :, 0], s[:, :, 1], s[:, :, 2], s[:, :, 3]
    det = s_ab + s_bc + s_ca
    # det == 0 gives inf/NaN in u, v, t, which every range test rejects
    inv_det = 1.0 / det
    t = num * inv_det
    u = s_ca * inv_det
    v = s_ab * inv_det
    accept = (
        (u >= -EPS) & (v >= -EPS) & (t >= -EPS) & (u <= 1.0 + EPS) & (u + v <= 1.0 + EPS)
    )
    best, arg = torch.where(accept, t, F_MAX).reshape(r, -1).min(dim=1)
    return best, torch.where(best < F_MAX, arg, -1)


def nearest_hit_fused_plain(w: torch.Tensor, fused_ops: torch.Tensor, n_blocks: int, tri_block: int):
    """Plain version of kernel 1: every real block, every ray.  Returns
    (t (N,) f32, idx (N,) int32)."""
    nearest_hit_fused_plain.calls += 1
    ops = fused_ops[:, : n_blocks * 4 * tri_block]
    ts, idxs = [], []
    for s0 in range(0, w.shape[0], PLAIN_CHUNK):
        t, idx = accept_nearest(w[s0:s0 + PLAIN_CHUNK] @ ops, tri_block)
        ts.append(t)
        idxs.append(idx.to(torch.int32))
    return torch.cat(ts), torch.cat(idxs)


nearest_hit_fused_plain.calls = 0


def _check(x: torch.Tensor, name: str, dtype, shape, device):
    if x.dtype != dtype or tuple(x.shape) != tuple(shape) or x.device != device:
        raise ValueError(
            f"{name}: expected {dtype} {tuple(shape)} on {device}, "
            f"got {x.dtype} {tuple(x.shape)} on {x.device}"
        )
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def nearest_hit_fused(
    w: torch.Tensor,  # (N, 16) [dir, orig x dir, orig, -1, alive, 0...]
    fused_ops: torch.Tensor,  # (16, 4*T) block-grouped operand pack
    block_list: torch.Tensor,  # (nt, nb) int32 worklists
    ray_tile: int,
    tri_block: int,
):
    """Returns (t (N,), idx (N,) int32, -1 on a miss): the nearest accepted
    triangle per ray.  Launches kernel 1 for CUDA tensors (counted in
    ``nearest_hit_fused.launches``), runs the plain version for CPU ones."""
    n = w.shape[0]
    nt, nb = block_list.shape
    if n != nt * ray_tile:
        raise ValueError(f"{n} rays do not fill {nt} tiles of {ray_tile}")
    if w.device.type == "cpu":
        return nearest_hit_fused_plain(w, fused_ops, nb, tri_block)
    if w.device.type != "cuda":
        raise ValueError(f"no kernel for device {w.device}")
    if not 32 <= ray_tile <= 1024 or ray_tile % 32:
        raise ValueError(f"ray_tile must be a multiple of 32 in [32, 1024], got {ray_tile}")
    dev = w.device
    _check(w, "w", torch.float32, (n, 16), dev)
    _check(fused_ops, "fused_ops", torch.float32, (16, fused_ops.shape[1]), dev)
    _check(block_list, "block_list", torch.int32, (nt, nb), dev)
    if fused_ops.shape[1] < nb * 4 * tri_block:
        raise ValueError("fused_ops holds fewer blocks than the worklists")
    t = torch.empty(n, dtype=torch.float32, device=dev)
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    err = _build.library().ptt_trace_list(
        ctypes.c_void_p(w.data_ptr()),
        ctypes.c_void_p(fused_ops.data_ptr()),
        ctypes.c_int(fused_ops.shape[1]),
        ctypes.c_void_p(block_list.data_ptr()),
        ctypes.c_int(nt),
        ctypes.c_int(nb),
        ctypes.c_int(ray_tile),
        ctypes.c_int(tri_block),
        ctypes.c_void_p(t.data_ptr()),
        ctypes.c_void_p(idx.data_ptr()),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    _build.check(err, "ptt_trace_list")
    nearest_hit_fused.launches += 1
    return t, idx


nearest_hit_fused.launches = 0


def primary_inputs(world: WorldTriangles, ro, rd, alive=None):
    """The ray vectors and worklists kernel 1 takes: rays padded to a
    multiple of ``RAY_TILE`` (padding lanes dead), ``w16`` (N, 16) and the
    (nt, nb) block worklists.  ``alive`` (N,) bool keeps dead lanes out of
    the worklists."""
    n = ro.shape[0]
    dev = ro.device
    rd_n = normalize(rd)
    if alive is None:
        alive_f = torch.ones((n, 1), dtype=torch.float32, device=dev)
    else:
        alive_f = alive.to(torch.float32)[:, None]
    pad = (-n) % RAY_TILE
    if pad:
        ro = torch.cat([ro, ro.new_zeros(pad, 3)])
        rd_n = torch.cat([rd_n, rd_n.new_ones(pad, 3)])
        alive_f = torch.cat([alive_f, alive_f.new_zeros(pad, 1)])
    n_pad = ro.shape[0]
    w16 = torch.cat(
        [
            rd_n, cross3(ro, rd_n), ro,
            torch.full((n_pad, 1), -1.0, device=dev), alive_f,
            torch.zeros((n_pad, 5), device=dev),
        ],
        dim=-1,
    )
    margin = _slab_margin(world.block_aabb)
    block_list = _tile_block_lists(world.block_aabb, ro, rd_n, alive_f, RAY_TILE, margin)
    return w16, block_list


def trace_pallas(world: WorldTriangles, ro, rd, alive=None, return_idx: bool = False):
    """Full-scene nearest hit through the worklist kernel; the same result
    contract as :func:`..ops.plucker.trace_mxu`.  With ``return_idx`` it
    returns ``(HitRecord, idx)``, idx (N,) int32 the hit triangle's baked
    index (0 on a miss)."""
    if world.fused_ops is None:
        raise NotImplementedError(
            "the dense no-pack tracer is not ported yet (ROADMAP B5)"
        )
    n = ro.shape[0]
    w16, block_list = primary_inputs(world, ro, rd, alive)
    t, idx = nearest_hit_fused(w16, world.fused_ops, block_list, RAY_TILE, world.tri_block)
    idx = torch.clamp(idx[:n], min=0)
    rec = hit_record(world, t[:n], idx.long())
    return (rec, idx) if return_idx else rec
