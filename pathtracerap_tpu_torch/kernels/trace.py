"""Nearest-hit traces (port of ``pathtracerap_tpu/pallas/trace.py``).

**Worklist trace.** The per-ray-tile block worklists are built in plain
torch (:func:`_tile_block_lists`), sorted front to back and padded with
-1; the nearest-hit sweep over them is kernel 1, ``csrc/trace_list.cu``,
which replaces the TPU kernel ``pallas/trace.py::_fused_list_kernel``.
It stages the bake's triangle-major pack ``ops_tri`` from device memory
at any block count, so it also stands in for that kernel's streamed mode
above 313 blocks, and splits each tile's list into chunks of
``TRACE_LIST_CHUNK`` entries swept by thread blocks of their own.

**Dense trace.** A world without a fused pack (above the bake's pack
budget, or traced with ``cull=False``) is swept whole by kernel 5,
``csrc/nearest_hit.cu``, which replaces ``_nearest_hit_kernel``: every
ray tile walks every real 128-triangle cluster in index order and skips
the clusters no live ray's slab test (:func:`slab_reaches`) can reach with
a better t, testing the union box of each ``CLUSTER_GROUP`` clusters
(the world's ``group_aabb``) before its members.

:func:`nearest_hit_fused` and :func:`nearest_hit` are the kernels'
wrappers: on a CUDA tensor they launch the kernel (and count the launch),
on a CPU tensor they run the plain versions
:func:`nearest_hit_fused_plain` and :func:`nearest_hit_plain`, which sweep
every real triangle.  The culling contract (never skip a block a live ray
can hit with a better t; exact-t ties to the lowest baked index) makes
kernel and plain version return the same (t, idx).
"""

from __future__ import annotations

import ctypes

import torch

from .. import constants
from ..ops.math import cross3, normalize
from ..ops.plucker import CLUSTER_GROUP, dense_runs, hit_record
from ..scene.types import WorldTriangles
from ..utils.debug import resolve_debug
from . import _build

F_MAX = constants.FLOAT_MAX
EPS = constants.EPSILON

RAY_TILE = 512
# Above this many worklist units the per-ray slab pass would build
# (N, nb, 3) temporaries of gigabytes; a per-tile frustum test is used.
FRUSTUM_LIST_THRESHOLD = 48
PLAIN_CHUNK = 8192  # rays per chunk of the plain versions' products
# Kernel 1's plain version sweeps the pack in chunks of this many blocks,
# and of as many rays as keep a (rays x columns) temporary within
# PLAIN_ELEMS values.
PLAIN_BLOCK_CHUNK = 64
PLAIN_ELEMS = 1 << 24
SWEEP_RUN = 128  # triangles kernels 1 to 4 stage per shared-memory run
# Kernel 1 (csrc/trace_list.cu kRays, kChunk): rays a thread sweeps, and
# worklist entries a thread block sweeps; chosen on the card (PERF.md).
TRACE_LIST_RAYS = 2
TRACE_LIST_CHUNK = 1
DENSE_TILE = 256  # rays per thread block of kernel 5
DENSE_RUN = 128  # triangles per run of kernel 5 == the bake's cluster width
# Kernel 5 (csrc/nearest_hit.cu kRays): rays a thread sweeps, chosen on the
# card (PERF.md); the clusters a group box unites are CLUSTER_GROUP.
DENSE_RAYS = 2
DENSE_TRI_CHUNK = 8192  # triangles per chunk of kernel 5's plain version


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


def accept_nearest(s: torch.Tensor, tri_block: int, debug: bool = False):
    """Epsilon-guarded Moeller-Trumbore accept and nearest hit from the
    side/plane products ``s`` (R, nb * 4 * TB) of ``nb`` consecutive blocks
    starting at block 0.  Returns (t (R,), idx (R,) int64, -1 on a miss);
    exact-t ties go to the lowest index.  ``debug`` is the explicit-mask
    form of ``PTAP_DEBUG=1`` (:mod:`..utils.debug`): it masks ``det == 0``
    where the fast form lets inf/NaN fail the range tests; both accept the
    same triangles."""
    r = s.shape[0]
    s = s.reshape(r, -1, 4, tri_block)
    s_ab, s_bc, s_ca, num = s[:, :, 0], s[:, :, 1], s[:, :, 2], s[:, :, 3]
    det = s_ab + s_bc + s_ca
    if debug:
        parallel = det == 0.0
        inv_det = 1.0 / torch.where(parallel, 1.0, det)
    else:
        # det == 0 gives inf/NaN in u, v, t, which every range test rejects
        inv_det = 1.0 / det
    t = num * inv_det
    u = s_ca * inv_det
    v = s_ab * inv_det
    accept = (
        (u >= -EPS) & (v >= -EPS) & (t >= -EPS) & (u <= 1.0 + EPS) & (u + v <= 1.0 + EPS)
    )
    if debug:
        accept = accept & ~parallel
    best, arg = torch.where(accept, t, F_MAX).reshape(r, -1).min(dim=1)
    return best, torch.where(best < F_MAX, arg, -1)


def nearest_hit_fused_plain(w: torch.Tensor, fused_ops: torch.Tensor, n_blocks: int, tri_block: int,
                            debug: bool = False):
    """Plain version of kernel 1: every real block, every ray.  Returns
    (t (N,) f32, idx (N,) int32).  The blocks are swept in chunks in index
    order, a chunk's best replacing the running one only on a strictly
    smaller t: the result of one sweep over all of them.  ``debug``: the
    explicit-mask accept chain (:func:`accept_nearest`)."""
    nearest_hit_fused_plain.calls += 1
    cols = 4 * tri_block
    chunk_cols = min(n_blocks, PLAIN_BLOCK_CHUNK) * cols
    rows = max(1, min(PLAIN_CHUNK, PLAIN_ELEMS // chunk_cols))
    ts, idxs = [], []
    for s0 in range(0, w.shape[0], rows):
        wr = w[s0:s0 + rows]
        best = torch.full((wr.shape[0],), F_MAX, device=w.device)
        best_idx = torch.full((wr.shape[0],), -1, dtype=torch.int64, device=w.device)
        for b0 in range(0, n_blocks, PLAIN_BLOCK_CHUNK):
            b1 = min(b0 + PLAIN_BLOCK_CHUNK, n_blocks)
            t, idx = accept_nearest(wr @ fused_ops[:, b0 * cols:b1 * cols], tri_block, debug)
            better = t < best
            best_idx = torch.where(better, idx + b0 * tri_block, best_idx)
            best = torch.where(better, t, best)
        ts.append(best)
        idxs.append(best_idx.to(torch.int32))
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


def sweep_operands(world: WorldTriangles):
    """What kernels 1 to 4 stage: ``(ops_tri, n_tris)``, the world's
    (T, 24) triangle-major pack, checked, and the count of real
    triangles the sweep stops at (padding is never accepted)."""
    ops = world.ops_tri
    if ops is None:
        raise ValueError("world.ops_tri is None: kernels 1 to 4 stage the triangle-major "
                         "pack that bake_world_triangles stores beside fused_ops")
    if ops.dtype != torch.float32 or ops.dim() != 2 or ops.shape[1] != 24:
        raise ValueError(f"ops_tri: expected float32 (T, 24), got {ops.dtype} {tuple(ops.shape)}")
    if not ops.is_contiguous():
        raise ValueError("ops_tri must be contiguous")
    if ops.data_ptr() % 16:
        raise ValueError("ops_tri must be 16-byte aligned: the kernels stage it with 16-byte copies")
    t = ops.shape[0]
    return ops, min(world.n_valid or t, t)


def nearest_hit_fused(
    w: torch.Tensor,  # (N, 16) [dir, orig x dir, orig, -1, alive, 0...]
    world: WorldTriangles,  # with its fused pack (and, on the card, ops_tri)
    block_list: torch.Tensor,  # (nt, nb) int32 worklists of world.tri_block-triangle blocks
    ray_tile: int,
    debug: bool = None,
):
    """Returns (t (N,), idx (N,) int32, -1 on a miss): the nearest accepted
    triangle per ray over its tile's worklist (every ray of a tile is
    traced, live or not).  ``debug`` selects the explicit-mask accept chain
    (None: the ``PTAP_DEBUG`` environment variable).  Launches kernel 1 for
    CUDA tensors (counted in ``nearest_hit_fused.launches``), runs the
    plain version for CPU ones."""
    debug = resolve_debug(debug)
    n = w.shape[0]
    nt, nb = block_list.shape
    tb = world.tri_block
    if n != nt * ray_tile:
        raise ValueError(f"{n} rays do not fill {nt} tiles of {ray_tile}")
    if w.device.type == "cpu":
        return nearest_hit_fused_plain(w, world.fused_ops, nb, tb, debug)
    if w.device.type != "cuda":
        raise ValueError(f"no kernel for device {w.device}")
    step = 32 * TRACE_LIST_RAYS  # whole warps of threads that sweep R rays each
    if not step <= ray_tile <= 1024 or ray_tile % step:
        raise ValueError(f"ray_tile must be a multiple of {step} in [{step}, 1024], got {ray_tile}")
    if tb % SWEEP_RUN:
        raise ValueError(f"tri_block {tb} is not a multiple of {SWEEP_RUN}")
    dev = w.device
    ops, n_tris = sweep_operands(world)
    _check(w, "w", torch.float32, (n, 16), dev)
    _check(ops, "ops_tri", torch.float32, tuple(ops.shape), dev)
    _check(block_list, "block_list", torch.int32, (nt, nb), dev)
    if ops.shape[0] < nb * tb:
        raise ValueError("ops_tri holds fewer blocks than the worklists")
    if w.data_ptr() % 16:
        raise ValueError("w must be 16-byte aligned: the kernel loads its rows as float4")
    t = torch.empty(n, dtype=torch.float32, device=dev)
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    # per-ray merge keys and per-tile counts, for tiles whose lists span chunks
    merge = torch.zeros(n + nt, dtype=torch.int64, device=dev) if nb > TRACE_LIST_CHUNK else None
    err = _build.library().ptt_trace_list(
        ctypes.c_void_p(w.data_ptr()),
        ctypes.c_void_p(block_list.data_ptr()),
        ctypes.c_int(nt),
        ctypes.c_int(nb),
        ctypes.c_int(tb),
        ctypes.c_int(ray_tile),
        ctypes.c_void_p(ops.data_ptr()),
        ctypes.c_int(n_tris),
        ctypes.c_void_p(t.data_ptr()),
        ctypes.c_void_p(idx.data_ptr()),
        ctypes.c_void_p(merge.data_ptr() if merge is not None else None),
        ctypes.c_int(int(debug)),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    _build.check(err, "ptt_trace_list")
    nearest_hit_fused.launches += 1
    return t, idx


nearest_hit_fused.launches = 0


def _cluster_margin(cluster_aabb: torch.Tensor) -> torch.Tensor:
    """The dense kernel's cull margin (0-d tensor): ``EPS + 1e-5`` times
    the largest finite coordinate of the cluster table, as
    ``_nearest_hit_kernel`` computes it (``pallas/trace.py:106-108``)."""
    a = cluster_aabb.abs()
    return EPS + 1e-5 * torch.where(a < F_MAX, a, 0.0).amax()


def slab_reaches(box: torch.Tensor, ro: torch.Tensor, d: torch.Tensor, margin, best):
    """Kernel 5's gate in torch, operation by operation (``csrc/nearest_hit.cu``
    ``slab_of`` and ``reaches``): whether each ray (origin ``ro`` (N, 3),
    direction ``d`` (N, 3)) reaches each box ``box`` (6, M) ``[min; max]``
    with a t that can beat its ``best`` (N,); (N, M) bool.  The cluster
    boxes and the group boxes of :func:`..ops.plucker.cluster_group_aabb` both go
    through it, with ``margin`` :func:`_cluster_margin` of the clusters."""
    d = torch.where(d.abs() < 1e-12, torch.where(d < 0, -1e-12, 1e-12), d)
    inv = 1.0 / d
    tmin = tmax = None
    for a in range(3):
        lo = (box[a][None, :] - ro[:, a, None]) * inv[:, a, None]
        hi = (box[3 + a][None, :] - ro[:, a, None]) * inv[:, a, None]
        near, far = torch.fmin(lo, hi), torch.fmax(lo, hi)
        tmin = near if a == 0 else torch.fmax(tmin, near)
        tmax = far if a == 0 else torch.fmin(tmax, far)
    return (tmax >= -margin) & (tmin <= tmax + margin) & (tmin - margin <= best[:, None])


def nearest_hit_plain(w, wo, edge_mat, plane_mat, n_valid: int = 0):
    """Plain version of kernel 5: every ray against every real triangle,
    with ``_nearest_hit_kernel``'s arithmetic (three side products and
    ``num = o . n - d``, an explicit ``det == 0`` mask, ``t = -num / det``,
    the five epsilon tests).  Rays and triangles go in chunks; a chunk's
    first minimum replaces the running best only on a strictly smaller t,
    so exact ties go to the lowest index.  Returns (t (N,) f32, idx (N,)
    int32, -1 on a miss)."""
    nearest_hit_plain.calls += 1
    n_tris = dense_runs(plane_mat.shape[1], n_valid) * DENSE_RUN
    ts, idxs = [], []
    for s0 in range(0, w.shape[0], PLAIN_CHUNK):
        wr, wor = w[s0:s0 + PLAIN_CHUNK], wo[s0:s0 + PLAIN_CHUNK]
        best = torch.full((wr.shape[0],), F_MAX, device=w.device)
        best_idx = torch.full((wr.shape[0],), -1, dtype=torch.int64, device=w.device)
        for c0 in range(0, n_tris, DENSE_TRI_CHUNK):
            c1 = min(c0 + DENSE_TRI_CHUNK, n_tris)
            s_ab, s_bc, s_ca = (wr @ edge_mat[e, :, c0:c1] for e in range(3))
            num = wor @ plane_mat[:, c0:c1]
            det = s_ab + s_bc + s_ca
            parallel = det == 0.0
            inv_det = 1.0 / torch.where(parallel, 1.0, det)
            t = -num * inv_det
            u = s_ca * inv_det
            v = s_ab * inv_det
            m_lo = torch.minimum(torch.minimum(u, v), t)
            m_hi = torch.maximum(u, u + v)
            accept = ~parallel & (m_lo >= -EPS) & (m_hi <= 1.0 + EPS)
            blk_min, blk_arg = torch.where(accept, t, F_MAX).min(dim=1)
            better = blk_min < best
            best_idx = torch.where(better, blk_arg + c0, best_idx)
            best = torch.where(better, blk_min, best)
        ts.append(best)
        idxs.append(best_idx.to(torch.int32))
    return torch.cat(ts), torch.cat(idxs)


nearest_hit_plain.calls = 0


def nearest_hit(
    w: torch.Tensor,  # (N, 8) [dir, orig x dir, 0, 0]
    wo: torch.Tensor,  # (N, 8) [orig, -1, alive, 0, 0, 0]
    edge_mat: torch.Tensor,  # (3, 8, T)
    plane_mat: torch.Tensor,  # (8, T)
    cluster_aabb: torch.Tensor,  # (8, T / 128)
    cull: bool = True,
    n_valid: int = 0,
    swept: torch.Tensor = None,
    *,
    group_aabb: torch.Tensor,  # (8, ceil(runs / CLUSTER_GROUP))
    tests: torch.Tensor = None,
):
    """Dense nearest hit (JAX ``pallas/trace.py::nearest_hit``): returns
    (t (N,), idx (N,) int32, -1 on a miss), N a multiple of ``DENSE_TILE``.
    With ``cull`` a live ray skips the clusters its slab test cannot reach
    with a better t; ``n_valid`` cuts the sweep to the runs that hold real
    triangles.  A dead ray's result is unspecified.  Launches kernel 5 for
    CUDA tensors (counted in ``nearest_hit.launches``), runs the plain
    version for CPU ones.  ``group_aabb`` is the world's union boxes of the
    runs' clusters (the bake's, :func:`..ops.plucker.cluster_group_aabb`).
    ``swept``, an int32 (N / DENSE_TILE,) CUDA tensor,
    receives each thread block's count of swept runs; ``tests``, an int32
    (N / DENSE_TILE, 2) one, its counts of group and cluster box tests
    (each made by every live ray of the tile); a tile with no live ray
    counts none."""
    n = w.shape[0]
    t_tris = plane_mat.shape[1]
    if n % DENSE_TILE:
        raise ValueError(f"{n} rays do not fill tiles of {DENSE_TILE}")
    if w.device.type == "cpu":
        return nearest_hit_plain(w, wo, edge_mat, plane_mat, n_valid)
    if w.device.type != "cuda":
        raise ValueError(f"no kernel for device {w.device}")
    dev = w.device
    runs = dense_runs(t_tris, n_valid)
    nt = n // DENSE_TILE
    _check(w, "w", torch.float32, (n, 8), dev)
    _check(wo, "wo", torch.float32, (n, 8), dev)
    _check(edge_mat, "edge_mat", torch.float32, (3, 8, t_tris), dev)
    _check(plane_mat, "plane_mat", torch.float32, (8, t_tris), dev)
    _check(cluster_aabb, "cluster_aabb", torch.float32, (8, t_tris // DENSE_RUN), dev)
    _check(group_aabb, "group_aabb", torch.float32, (8, -(-runs // CLUSTER_GROUP)), dev)
    if swept is not None:
        _check(swept, "swept", torch.int32, (nt,), dev)
    if tests is not None:
        _check(tests, "tests", torch.int32, (nt, 2), dev)
    margin = _cluster_margin(cluster_aabb).reshape(1)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    err = _build.library().ptt_nearest_hit(
        ctypes.c_void_p(w.data_ptr()),
        ctypes.c_void_p(wo.data_ptr()),
        ctypes.c_void_p(edge_mat.data_ptr()),
        ctypes.c_void_p(plane_mat.data_ptr()),
        ctypes.c_int(t_tris),
        ctypes.c_void_p(cluster_aabb.data_ptr()),
        ctypes.c_void_p(group_aabb.data_ptr()),
        ctypes.c_void_p(margin.data_ptr()),
        ctypes.c_int(runs),
        ctypes.c_int(nt),
        ctypes.c_int(int(cull)),
        ctypes.c_void_p(t.data_ptr()),
        ctypes.c_void_p(idx.data_ptr()),
        ctypes.c_void_p(swept.data_ptr() if swept is not None else None),
        ctypes.c_void_p(tests.data_ptr() if tests is not None else None),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    _build.check(err, "ptt_nearest_hit")
    nearest_hit.launches += 1
    return t, idx


nearest_hit.launches = 0


def ray_vectors(ro: torch.Tensor, rd_n: torch.Tensor, alive_f=None) -> torch.Tensor:
    """The (N, 16) ray vectors ``[d, orig x d, orig, -1, alive, 0...]`` the
    traversal kernels take, of normalized directions; ``alive_f`` (N, 1)
    f32 defaults to ones."""
    n = ro.shape[0]
    dev = ro.device
    if alive_f is None:
        alive_f = torch.ones((n, 1), device=dev)
    return torch.cat(
        [rd_n, cross3(ro, rd_n), ro, torch.full((n, 1), -1.0, device=dev), alive_f,
         torch.zeros((n, 5), device=dev)],
        dim=-1,
    )


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
    w16 = ray_vectors(ro, rd_n, alive_f)
    margin = _slab_margin(world.block_aabb)
    block_list = _tile_block_lists(world.block_aabb, ro, rd_n, alive_f, RAY_TILE, margin)
    return w16, block_list


def dense_inputs(ro, rd, alive=None):
    """The ray vectors kernel 5 takes, rays padded to a multiple of
    ``RAY_TILE`` (padding lanes dead): ``w`` (N, 8) ``[d, o x d, 0, 0]``
    and ``wo`` (N, 8) ``[o, -1, alive, 0, 0, 0]`` of normalized
    directions."""
    n = ro.shape[0]
    dev = ro.device
    rd_n = normalize(rd)
    alive_f = (torch.ones((n, 1), device=dev) if alive is None
               else alive.to(torch.float32)[:, None])
    pad = (-n) % RAY_TILE
    if pad:
        ro = torch.cat([ro, ro.new_zeros(pad, 3)])
        rd_n = torch.cat([rd_n, rd_n.new_ones(pad, 3)])
        alive_f = torch.cat([alive_f, alive_f.new_zeros(pad, 1)])
    m = ro.shape[0]
    w = torch.cat([rd_n, cross3(ro, rd_n), torch.zeros((m, 2), device=dev)], dim=-1)
    wo = torch.cat([ro, torch.full((m, 1), -1.0, device=dev), alive_f,
                    torch.zeros((m, 3), device=dev)], dim=-1)
    return w, wo


def trace_pallas(world: WorldTriangles, ro, rd, alive=None, cull: bool = True,
                 return_idx: bool = False, debug: bool = None):
    """Full-scene nearest hit; the same result contract as
    :func:`..ops.plucker.trace_mxu`.  A world with a fused pack is traced
    through its worklists (kernel 1) when ``cull``; a world without one,
    or ``cull=False``, through the dense sweep (kernel 5).  ``alive`` (N,)
    bool keeps dead lanes out of the culling.  With ``return_idx`` it
    returns ``(HitRecord, idx)``, idx (N,) int32 the hit triangle's baked
    index (0 on a miss).  ``debug`` switches kernel 1 to the explicit-mask
    accept chain (None: ``PTAP_DEBUG``; kernel 5 has no debug form, as in
    JAX)."""
    n = ro.shape[0]
    if cull and world.fused_ops is not None:
        w16, block_list = primary_inputs(world, ro, rd, alive)
        t, idx = nearest_hit_fused(w16, world, block_list, RAY_TILE, debug)
    else:
        w, wo = dense_inputs(ro, rd, alive)
        t, idx = nearest_hit(w, wo, world.edge_mat, world.plane_mat, world.cluster_aabb,
                             cull=cull, n_valid=world.n_valid, group_aabb=world.group_aabb)
    idx = torch.clamp(idx[:n], min=0)
    rec = hit_record(world, t[:n], idx.long())
    return (rec, idx) if return_idx else rec
