"""Binned wavefront engine (port of the binned half of
``pathtracerap_tpu/pallas/megakernel.py``).

Per bounce the wavefront is re-sorted by (direction octant, origin
Morton), per-tile worklists of 128-triangle sub-blocks are built in plain
torch, and kernel 2, ``csrc/bounce.cu``, traces and shades one bounce.  It
replaces the TPU kernel ``pallas/megakernel.py::_bounce_kernel``.

:func:`bounce` is the kernel's wrapper: on a CUDA tensor it launches the
kernel (counted in ``bounce.launches``), on a CPU tensor it runs the plain
version :func:`bounce_plain`, which traces every real block (the worklist
contract makes the hit identical) and shades with the kernel's math.
"""

from __future__ import annotations

import ctypes

import torch

from pathtracerap_tpu import constants

from ..ops.intersect import HitRecord
from ..ops.math import cross3, normalize, normalize_rsqrt
from ..ops.plucker import _morton3
from ..ops.rng import RNG_TILE, chunk_uniforms
from ..render.shade import RayState, shade
from ..scene.types import WorldTriangles
from . import _build
from .trace import _check, _slab_margin, _tile_block_lists, nearest_hit_fused_plain, trace_pallas

F_MAX = constants.FLOAT_MAX

SUB_BLOCK = 128  # sub-block width == the bake's cluster size
# Above this many 512-triangle blocks the per-ray slab pass over 4x as many
# sub-blocks costs more than the finer culling saves: use block worklists.
SUB_MAX_BLOCKS = 64
SMALL_TILE_MAX_UNITS = 32  # worklist tile of 256 rays up to this many units
BINNED_SAMPLE_BATCH = 4  # samples sorted together as one wavefront
BINNED_SLAB_TILES = 16  # facade slab, in 8192-ray RNG tiles
STATE_COLS = 10  # [orig(0:3), dir(3:6), color(6:9), remaining(9)]


def use_sub_blocks(world: WorldTriangles) -> bool:
    """Whether the binned worklists cull at sub-block (128-triangle)
    granularity: one predicate for the engine, its tile choice and the
    kernel launch."""
    return (
        world.sub_aabb is not None
        and world.block_aabb.shape[0] <= SUB_MAX_BLOCKS
        and world.tri_block > SUB_BLOCK
        and world.tri_block % SUB_BLOCK == 0
    )


def binned_ray_tile(world: WorldTriangles) -> int:
    """Rays per worklist tile: 256 when the scene culls over at most 32
    units (sub-blocks or blocks), else 512."""
    units = world.sub_aabb.shape[0] if use_sub_blocks(world) else world.block_aabb.shape[0]
    return 256 if units <= SMALL_TILE_MAX_UNITS else 512


def scene_morton_bounds(block_aabb: torch.Tensor):
    """(lo, hi) world bounds for the wavefront sort's Morton quantization,
    ignoring NaN / inverted padding rows."""
    finite = block_aabb[:, 0:6].abs() < F_MAX
    lo = torch.where(finite[:, 0:3], block_aabb[:, 0:3], F_MAX).amin(dim=0)
    hi = torch.where(finite[:, 3:6], block_aabb[:, 3:6], -F_MAX).amax(dim=0)
    return lo, hi


def _sort_keys(pack: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(N,) int32 sort key: 3-bit direction octant (major), 21-bit origin
    Morton (minor); dead rays sink to the end."""
    d = pack[:, 3:6]
    morton = _morton3(pack[:, 0:3], lo, hi) >> 9
    dirk = (
        (d[:, 0] < 0).to(torch.int32) * 4
        + (d[:, 1] < 0).to(torch.int32) * 2
        + (d[:, 2] < 0).to(torch.int32)
    )
    key = (dirk << 21) | morton
    return torch.where(pack[:, 9] > 0.0, key, 1 << 30)


def _attr_hits(world: WorldTriangles, t: torch.Tensor, idx: torch.Tensor) -> HitRecord:
    """The winner's attribute rows, as the kernel reads them (zeros on a
    miss: attr rows [shade_n, mat_type, rgb, geom_n, idx+1, ri, 0...])."""
    a = torch.where((idx >= 0)[:, None], world.attr_rows[:, idx.clamp(min=0).long()].T, 0.0)
    return HitRecord(
        t=t, normal=a[:, 0:3], mat_type=a[:, 3], mat_color=a[:, 4:7],
        geom_normal=a[:, 7:10], mat_ri=a[:, 11],
    )


def bounce_plain(pack: torch.Tensor, u: torch.Tensor, world: WorldTriangles, parity: bool):
    """Plain version of kernel 2: one bounce of a (N, 10) ray-state pack
    with its (N, 4) uniforms.  Traces every real block, gathers the
    winner's attribute rows and shades with the kernel's math (rsqrt
    normalization, as the TPU kernel's ``_shade_inkernel_t``).  Returns
    (new state, hit triangle index or -1)."""
    bounce_plain.calls += 1
    n = pack.shape[0]
    orig, dirn, remaining = pack[:, 0:3], pack[:, 3:6], pack[:, 9]
    d_n = normalize_rsqrt(dirn)
    w16 = torch.cat(
        [
            d_n, cross3(orig, d_n), orig,
            torch.full((n, 1), -1.0, device=pack.device),
            (remaining > 0.0).to(torch.float32)[:, None],
            torch.zeros((n, 5), device=pack.device),
        ],
        dim=1,
    )
    t, idx = nearest_hit_fused_plain(w16, world.fused_ops, world.block_aabb.shape[0], world.tri_block)
    state = RayState(orig=orig, dir=dirn, color=pack[:, 6:9], remaining=remaining)
    s = shade(state, _attr_hits(world, t, idx), u, parity=parity, norm=normalize_rsqrt)
    return torch.cat([s.orig, s.dir, s.color, s.remaining[:, None]], dim=1), idx


bounce_plain.calls = 0


def bounce(
    pack: torch.Tensor,  # (N, 10) ray state, N = nt * ray_tile
    u: torch.Tensor,  # (N, 4) this bounce's uniforms
    lists: torch.Tensor,  # (nt, w) int32 tmin-sorted worklists of `unit`-triangle runs
    unit: int,  # worklist granularity: SUB_BLOCK, or world.tri_block
    world: WorldTriangles,
    ray_tile: int,
    parity: bool,
):
    """One binned bounce: nearest hit over each tile's worklist, then
    shading.  Returns (new state, hit triangle index or -1; -1 as well
    for the rays of a tile with no live ray).  Launches kernel 2 for CUDA
    tensors (counted in ``bounce.launches``), runs the plain version for
    CPU ones."""
    n = pack.shape[0]
    nt, lw = lists.shape
    if n != nt * ray_tile:
        raise ValueError(f"{n} rays do not fill {nt} tiles of {ray_tile}")
    if pack.device.type == "cpu":
        return bounce_plain(pack, u, world, parity)
    if pack.device.type != "cuda":
        raise ValueError(f"no kernel for device {pack.device}")
    if not 32 <= ray_tile <= 1024 or ray_tile % 32:
        raise ValueError(f"ray_tile must be a multiple of 32 in [32, 1024], got {ray_tile}")
    if world.tri_block % unit:
        raise ValueError(f"unit {unit} does not divide tri_block {world.tri_block}")
    dev = pack.device
    ops, attr = world.fused_ops, world.attr_rows
    _check(pack, "pack", torch.float32, (n, STATE_COLS), dev)
    _check(u, "u", torch.float32, (n, 4), dev)
    _check(lists, "lists", torch.int32, (nt, lw), dev)
    _check(ops, "fused_ops", torch.float32, (16, ops.shape[1]), dev)
    _check(attr, "attr_rows", torch.float32, (16, ops.shape[1] // 4), dev)
    out = torch.empty_like(pack)
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    err = _build.library().ptt_bounce(
        ctypes.c_void_p(pack.data_ptr()),
        ctypes.c_void_p(u.data_ptr()),
        ctypes.c_void_p(lists.data_ptr()),
        ctypes.c_int(nt),
        ctypes.c_int(lw),
        ctypes.c_int(unit),
        ctypes.c_int(ray_tile),
        ctypes.c_void_p(ops.data_ptr()),
        ctypes.c_void_p(attr.data_ptr()),
        ctypes.c_int(attr.shape[1]),
        ctypes.c_int(world.tri_block),
        ctypes.c_int(int(parity)),
        ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(idx.data_ptr()),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    _build.check(err, "ptt_bounce")
    bounce.launches += 1
    return out, idx


bounce.launches = 0


def bounce_lists(world: WorldTriangles, margin, pack: torch.Tensor, ray_tile: int):
    """Worklists of a sorted wavefront: (lists (nt, w) int32, unit)."""
    d_n = normalize_rsqrt(pack[:, 3:6])
    alive_f = (pack[:, 9:10] > 0.0).to(torch.float32)
    if use_sub_blocks(world):
        boxes, unit = world.sub_aabb, SUB_BLOCK
    else:
        boxes, unit = world.block_aabb, world.tri_block
    return _tile_block_lists(boxes, pack[:, 0:3], d_n, alive_f, ray_tile, margin), unit


def first_wavefront(world, ro_p, rd_p, hits0, key, s0: int, ns: int, n: int, max_bounces: int,
                    parity: bool, tile_base: int):
    """Samples ``s0 .. s0 + ns`` as one wavefront after bounce 0: the
    (ns * n_pad, 10) state pack and its (ns * n_pad, 4 * max_bounces)
    uniforms, rows in (sample, ray) order."""
    n_pad = ro_p.shape[0]
    u_flat = chunk_uniforms(key, range(s0, s0 + ns), max_bounces, n, n_pad, tile_base)

    def big(x):
        return x.repeat((ns,) + (1,) * (x.dim() - 1))

    state = RayState.primary(big(ro_p), big(rd_p), max_bounces)
    hits = HitRecord(**{f: big(getattr(hits0, f)) for f in HitRecord.__dataclass_fields__})
    state = shade(state, hits, u_flat[:, 0:4], parity=parity)
    pack = torch.cat(
        [state.orig, state.dir, state.color, state.remaining.to(torch.float32)[:, None]], dim=1
    )
    return pack, u_flat


def sort_wavefront(pack, pix, lo, hi):
    """Stable sort of the wavefront rows (and their original ids) by key."""
    perm = torch.argsort(_sort_keys(pack, lo, hi), stable=True)
    return pack[perm], pix[perm]


def render_samples_binned(
    world: WorldTriangles,
    ro: torch.Tensor,
    rd: torch.Tensor,
    key: torch.Tensor,
    n_samples: int,
    max_bounces: int,
    parity: bool = True,
    tile_base: int = 0,
) -> torch.Tensor:
    """Accumulate samples ``0 .. n_samples`` with per-bounce ray binning;
    returns the (N, 3) contribution sums.  Parity camera only: the primary
    hits are traced once and shared by every sample.

    Samples go in groups of ``BINNED_SAMPLE_BATCH``, each group sorted as
    one wavefront; every ray keeps its own (sample, pixel) uniform stream
    through ``pix``, so grouping changes no bit of the result."""
    ray_tile = binned_ray_tile(world)
    n = ro.shape[0]
    dev = ro.device
    rd_n = normalize(rd)
    pad = (-n) % ray_tile
    if pad:
        ro_p = torch.cat([ro, ro.new_zeros(pad, 3)])
        rd_p = torch.cat([rd_n, rd_n.new_ones(pad, 3)])
    else:
        ro_p, rd_p = ro, rd_n
    n_pad = ro_p.shape[0]
    margin = _slab_margin(world.block_aabb)
    hits0 = trace_pallas(world, ro_p, rd_p)
    lo, hi = scene_morton_bounds(world.block_aabb)

    # full groups of BINNED_SAMPLE_BATCH, then the remainder one by one:
    # the reference's order of summation into the accumulator
    n_full = n_samples - n_samples % BINNED_SAMPLE_BATCH
    group_sizes = [BINNED_SAMPLE_BATCH] * (n_full // BINNED_SAMPLE_BATCH) + [1] * (n_samples - n_full)
    acc = torch.zeros((n_pad, 3), dtype=torch.float32, device=dev)
    s0 = 0
    for ns in group_sizes:
        pack, u_flat = first_wavefront(
            world, ro_p, rd_p, hits0, key, s0, ns, n, max_bounces, parity, tile_base
        )
        pix = torch.arange(ns * n_pad, device=dev)
        for b in range(1, max_bounces):
            pack, pix = sort_wavefront(pack, pix, lo, hi)
            lists, unit = bounce_lists(world, margin, pack, ray_tile)
            pack, _ = bounce(pack, u_flat[:, 4 * b:4 * b + 4][pix], lists, unit, world, ray_tile, parity)
        contrib = torch.sqrt(torch.clamp(pack[:, 6:9], min=0.0))
        # un-permute through the inverse permutation
        inv = torch.empty_like(pix)
        inv[pix] = torch.arange(pix.shape[0], device=dev)
        acc = acc + contrib[inv].reshape(ns, n_pad, 3).sum(dim=0)
        s0 += ns
    return acc[:n]


def render_accumulate_binned(world, ro, rd, key, n_samples, max_bounces, parity=True):
    """The facade's binned loop: ``BINNED_SLAB_TILES`` RNG tiles of rays per
    call, with the global RNG tile numbering ``tile_base = s0 // 8192``."""
    slab = BINNED_SLAB_TILES * RNG_TILE
    parts = [
        render_samples_binned(
            world, ro[s0:s0 + slab], rd[s0:s0 + slab], key, n_samples, max_bounces,
            parity=parity, tile_base=s0 // RNG_TILE,
        )
        for s0 in range(0, ro.shape[0], slab)
    ]
    return torch.cat(parts)
