"""The megakernel engines (port of ``pathtracerap_tpu/pallas/megakernel.py``).

**Binned.** Per bounce the wavefront is re-sorted by (direction octant,
origin Morton), per-tile worklists of 128-triangle sub-blocks are built in
plain torch, and kernel 2, ``csrc/bounce.cu``, traces and shades one
bounce.  It replaces the TPU kernel ``_bounce_kernel``.  The
differentiable forward (:mod:`..diff.fast`) defers the shading instead:
kernel 3, ``csrc/bounce_trace.cu``, only traces (it replaces
``_bounce_trace_kernel``) and :func:`defer_shade_apply` shades: kernel S1,
``csrc/defer_shade.cu``, on the card (as it shades the binned loops'
bounce 0, :func:`first_wavefront`).

**Fused.** Kernel 4, ``csrc/megakernel.cu``, runs a whole sample, every
bounce of it, in one launch and sweeps every real block per bounce: it
replaces ``_megakernel``.  :func:`render_samples_fused` drives it for
single-block scenes and the jittered quality camera, and the
differentiable forward of single-block scenes reads its per-bounce index
stream (``emit_idx``).

:func:`bounce`, :func:`bounce_trace` and :func:`sample_fused` are the
kernels' wrappers: on a CUDA tensor they launch the kernel (counted in
``.launches``), on a CPU tensor they run the plain versions
:func:`bounce_plain`, :func:`bounce_trace_plain` and
:func:`sample_fused_plain`, which trace every real block (the worklist
contract makes the hit identical) and shade with the kernels' math.
"""

from __future__ import annotations

import ctypes

import torch

from .. import constants
from ..ops.intersect import HitRecord
from ..ops.math import normalize, normalize_rsqrt
from ..ops.plucker import _morton3
from ..ops.rng import RNG_TILE, chunk_jitter_uniforms, chunk_uniforms
from ..render.shade import RayState, shade
from ..scene.types import WorldTriangles
from ..utils.debug import resolve_debug
from ..utils.profiling import annotate
from . import _build
from . import defer_shade as KS
from .trace import (
    RAY_TILE, SWEEP_RUN, _check, _slab_margin, _tile_block_lists, nearest_hit_fused_plain,
    ray_vectors, sweep_operands, trace_pallas,
)

F_MAX = constants.FLOAT_MAX

SUB_BLOCK = 128  # sub-block width == the bake's cluster size
# Above this many 512-triangle blocks the per-ray slab pass over 4x as many
# sub-blocks costs more than the finer culling saves: use block worklists.
SUB_MAX_BLOCKS = 64
SMALL_TILE_MAX_UNITS = 32  # worklist tile of 256 rays up to this many units
BINNED_SAMPLE_BATCH = 4  # samples sorted together as one wavefront
BINNED_SLAB_TILES = 16  # facade slab, in 8192-ray RNG tiles
STATE_COLS = 10  # [orig(0:3), dir(3:6), color(6:9), remaining(9)]
SAMPLE_BATCH = 8  # samples per fused launch, parity camera
FUSED_SLAB_TILES = 64  # fused facade slab, in 8192-ray RNG tiles
GATE_BLOCKS = 8  # the fused sweep gates blocks on their AABB above this many
FUSED_TILE = 256  # rays per thread block of kernel 4 (csrc/megakernel.cu kFusedTile)
# Rays each thread of kernels 2 and 3 carries through the sweep
# (csrc/bounce.cu and csrc/bounce_trace.cu kRays): one triangle's operands,
# loaded from shared memory once, serve them all.  Kernel 4 sweeps one ray
# a thread.
BOUNCE_RAYS_PER_THREAD = 2
BOUNCE_TRACE_RAYS_PER_THREAD = 2
# Kernel 2 cuts each tile's worklist into chunks of about BOUNCE_CHUNK_TRIS
# triangles, each swept by its own thread block, and enqueues at most
# BOUNCE_MAX_BLOCKS thread blocks a launch (those of chunks past a list's
# end return at once, about 1.5 ns each); both chosen on the card (bounce_chunk,
# PERF.md).  The cap is under CUDA's 65,535 chunks a tile (gridDim.y).
BOUNCE_CHUNK_TRIS = 512
BOUNCE_MAX_BLOCKS = 1 << 15


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


def _ray_vectors(pack: torch.Tensor) -> torch.Tensor:
    """The (N, 16) ray vectors of a state pack, with the kernels' rsqrt
    normalization."""
    alive_f = (pack[:, 9] > 0.0).to(torch.float32)[:, None]
    return ray_vectors(pack[:, 0:3], normalize_rsqrt(pack[:, 3:6]), alive_f)


def _shade_pack(pack: torch.Tensor, hits: HitRecord, u: torch.Tensor, parity: bool):
    """One shading step of a (N, 10) state pack with the kernels' math
    (rsqrt normalization, as the TPU kernels' ``_shade_inkernel``)."""
    state = RayState(orig=pack[:, 0:3], dir=pack[:, 3:6], color=pack[:, 6:9], remaining=pack[:, 9])
    s = shade(state, hits, u, parity=parity, norm=normalize_rsqrt)
    return torch.cat([s.orig, s.dir, s.color, s.remaining[:, None]], dim=1)


def bounce_plain(pack: torch.Tensor, u: torch.Tensor, world: WorldTriangles, parity: bool,
                 debug: bool = False):
    """Plain version of kernel 2: one bounce of a (N, 10) ray-state pack
    with its (N, 4) uniforms.  Traces every real block, gathers the
    winner's attribute rows and shades with the kernel's math (rsqrt
    normalization, as the TPU kernel's ``_shade_inkernel_t``).  Returns
    (new state, hit triangle index or -1).  ``debug``: the explicit-mask
    accept chain."""
    bounce_plain.calls += 1
    t, idx = nearest_hit_fused_plain(
        _ray_vectors(pack), world.fused_ops, world.block_aabb.shape[0], world.tri_block, debug
    )
    return _shade_pack(pack, _attr_hits(world, t, idx), u, parity), idx


bounce_plain.calls = 0


def bounce_chunk(unit: int, lw: int, nt: int) -> int:
    """Worklist entries each thread block of kernel 2 sweeps, from the
    launch's shapes alone: ``unit`` triangles an entry, lists ``lw``
    entries wide, ``nt`` tiles.  Lists are cut into chunks of about
    ``BOUNCE_CHUNK_TRIS`` triangles, so that a bounce whose live tiles are
    fewer than the SMs still spreads their sweeps over the card, and into
    fewer where ``nt`` tiles of that many chunks would enqueue more than
    ``BOUNCE_MAX_BLOCKS`` thread blocks."""
    chunks = max(1, min(-(-lw * unit // BOUNCE_CHUNK_TRIS), BOUNCE_MAX_BLOCKS // max(nt, 1)))
    return max(1, -(-lw // chunks))


def bounce(
    pack: torch.Tensor,  # (N, 10) ray state, N = nt * ray_tile
    u: torch.Tensor,  # (N, 4) this bounce's uniforms
    lists: torch.Tensor,  # (nt, w) int32 tmin-sorted worklists of `unit`-triangle runs
    unit: int,  # worklist granularity: SUB_BLOCK, or world.tri_block
    world: WorldTriangles,
    ray_tile: int,
    parity: bool,
    debug: bool = None,
):
    """One binned bounce: nearest hit over each tile's worklist, then
    shading.  Returns (new state, hit triangle index or -1; -1 as well
    for a dead ray).  ``debug`` selects the explicit-mask accept chain
    (None: ``PTAP_DEBUG``).  Launches kernel 2 for CUDA tensors (counted
    in ``bounce.launches``; its worklists cut into chunks of
    :func:`bounce_chunk` entries, the launches that split a list counted
    in ``bounce.split_launches`` and their thread blocks in
    ``bounce.split_blocks``), runs the plain version for CPU ones."""
    debug = resolve_debug(debug)
    n = pack.shape[0]
    nt, lw = lists.shape
    if n != nt * ray_tile:
        raise ValueError(f"{n} rays do not fill {nt} tiles of {ray_tile}")
    if pack.device.type == "cpu":
        return bounce_plain(pack, u, world, parity, debug)
    if pack.device.type != "cuda":
        raise ValueError(f"no kernel for device {pack.device}")
    return _bounce_kernel(pack, u, lists, unit, world, ray_tile, parity, debug,
                          bounce_chunk(unit, lw, nt))


def _bounce_kernel(pack, u, lists, unit, world, ray_tile, parity, debug, chunk):
    """Kernel 2 on CUDA tensors with worklist chunks of ``chunk`` entries
    (``bounce`` passes :func:`bounce_chunk`'s; the card's tests and probe
    also pass a whole list, the unsplit launch, to compare against)."""
    n = pack.shape[0]
    nt, lw = lists.shape
    step = 32 * BOUNCE_RAYS_PER_THREAD  # whole warps of threads that own R rays each
    if not step <= ray_tile <= 1024 or ray_tile % step:
        raise ValueError(f"ray_tile must be a multiple of {step} in [{step}, 1024], got {ray_tile}")
    if world.tri_block % unit or unit % SWEEP_RUN:
        raise ValueError(f"unit {unit} must divide tri_block {world.tri_block} and be a "
                         f"multiple of {SWEEP_RUN}")
    split = 0 < chunk < lw  # a list may span chunks; ptt_bounce refuses a chunk under 1
    dev = pack.device
    ops, n_tris = sweep_operands(world)
    attr = world.attr_rows
    _check(pack, "pack", torch.float32, (n, STATE_COLS), dev)
    _check(u, "u", torch.float32, (n, 4), dev)
    _check(lists, "lists", torch.int32, (nt, lw), dev)
    _check(ops, "ops_tri", torch.float32, (ops.shape[0], 24), dev)
    _check(attr, "attr_rows", torch.float32, (16, ops.shape[0]), dev)
    out = torch.empty_like(pack)
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    # per-ray merge keys and per-tile counts, for tiles whose lists span chunks
    merge = torch.zeros(n + nt, dtype=torch.int64, device=dev) if split else None
    err = _build.library().ptt_bounce(
        ctypes.c_void_p(pack.data_ptr()),
        ctypes.c_void_p(u.data_ptr()),
        ctypes.c_void_p(lists.data_ptr()),
        ctypes.c_int(nt),
        ctypes.c_int(lw),
        ctypes.c_int(unit),
        ctypes.c_int(ray_tile),
        ctypes.c_int(chunk),
        ctypes.c_void_p(ops.data_ptr()),
        ctypes.c_int(n_tris),
        ctypes.c_void_p(attr.data_ptr()),
        ctypes.c_int(attr.shape[1]),
        ctypes.c_int(int(parity)),
        ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(idx.data_ptr()),
        ctypes.c_void_p(merge.data_ptr() if merge is not None else None),
        ctypes.c_int(int(debug)),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    _build.check(err, "ptt_bounce")
    bounce.launches += 1
    if split:
        bounce.split_launches += 1
        bounce.split_blocks += nt * -(-lw // chunk)
    return out, idx


bounce.launches = 0
bounce.split_launches = 0
bounce.split_blocks = 0


def bounce_lists(world: WorldTriangles, margin, pack: torch.Tensor, ray_tile: int):
    """Worklists of a sorted wavefront: (lists (nt, w) int32, unit)."""
    d_n = normalize_rsqrt(pack[:, 3:6])
    alive_f = (pack[:, 9:10] > 0.0).to(torch.float32)
    if use_sub_blocks(world):
        boxes, unit = world.sub_aabb, SUB_BLOCK
    else:
        boxes, unit = world.block_aabb, world.tri_block
    return _tile_block_lists(boxes, pack[:, 0:3], d_n, alive_f, ray_tile, margin), unit


def bounce_trace_plain(pack: torch.Tensor, world: WorldTriangles, ray_tile: int):
    """Plain version of kernel 3: every ray traced over every real block.
    Returns (t (N,) f32, column + 1 (N,) int32, 0 = miss); the rays of a
    tile with no live ray get (F_MAX, 0), as from the kernel."""
    bounce_trace_plain.calls += 1
    t, idx = nearest_hit_fused_plain(
        _ray_vectors(pack), world.fused_ops, world.block_aabb.shape[0], world.tri_block
    )
    live = (pack[:, 9] > 0.0).reshape(-1, ray_tile).any(dim=1).repeat_interleave(ray_tile)
    return torch.where(live, t, F_MAX), torch.where(live, idx + 1, 0)


bounce_trace_plain.calls = 0


def bounce_trace(
    pack: torch.Tensor,  # (N, 10) sorted ray state, N = nt * ray_tile
    lists: torch.Tensor,  # (nt, w) int32 tmin-sorted sub-block worklists
    unit: int,  # worklist granularity: SUB_BLOCK
    world: WorldTriangles,
    ray_tile: int,
):
    """The trace half of a deferred binned bounce: per ray the nearest
    accepted triangle over its tile's worklist (exact-t ties to the lowest
    baked index).  Returns (t (N,) f32, F_MAX on a miss; column + 1 (N,)
    int32, 0 on a miss and for the rays of a tile with no live ray).  A
    dead ray of a live tile gets an unspecified result.  Launches kernel 3
    for CUDA tensors (counted in ``bounce_trace.launches``; it stages the
    world's ``ops_tri``, and ``ray_tile`` must be a multiple of
    ``32 * BOUNCE_TRACE_RAYS_PER_THREAD``), runs the plain version for CPU
    ones."""
    n = pack.shape[0]
    nt, lw = lists.shape
    if n != nt * ray_tile:
        raise ValueError(f"{n} rays do not fill {nt} tiles of {ray_tile}")
    if not use_sub_blocks(world) or unit != SUB_BLOCK:
        raise ValueError("the deferred trace runs on sub-block worklists only")
    if pack.device.type == "cpu":
        return bounce_trace_plain(pack, world, ray_tile)
    if pack.device.type != "cuda":
        raise ValueError(f"no kernel for device {pack.device}")
    step = 32 * BOUNCE_TRACE_RAYS_PER_THREAD  # whole warps of threads that own R rays each
    if not step <= ray_tile <= 1024 or ray_tile % step:
        raise ValueError(f"ray_tile must be a multiple of {step} in [{step}, 1024], got {ray_tile}")
    dev = pack.device
    ops, n_tris = sweep_operands(world)
    _check(pack, "pack", torch.float32, (n, STATE_COLS), dev)
    _check(lists, "lists", torch.int32, (nt, lw), dev)
    _check(ops, "ops_tri", torch.float32, (ops.shape[0], 24), dev)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    col1 = torch.empty(n, dtype=torch.int32, device=dev)
    err = _build.library().ptt_bounce_trace(
        ctypes.c_void_p(pack.data_ptr()),
        ctypes.c_void_p(lists.data_ptr()),
        ctypes.c_int(nt),
        ctypes.c_int(lw),
        ctypes.c_int(unit),
        ctypes.c_int(ray_tile),
        ctypes.c_void_p(ops.data_ptr()),
        ctypes.c_int(n_tris),
        ctypes.c_void_p(t.data_ptr()),
        ctypes.c_void_p(col1.data_ptr()),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    _build.check(err, "ptt_bounce_trace")
    bounce_trace.launches += 1
    return t, col1


bounce_trace.launches = 0


def defer_shade_plain(world: WorldTriangles, pack: torch.Tensor, tg, u: torch.Tensor,
                      parity: bool):
    """Plain twin of kernel S1's deferred form: gather the winner's
    attribute rows for ``tg = (t, column + 1)`` and advance the (N, 10)
    state with this bounce's (N, 4) uniforms, in torch ops.  Shades with
    :func:`..render.shade.shade`'s default normalization: the JAX package
    shades the deferred bounce in XLA, not in the kernel."""
    defer_shade_plain.calls += 1
    t, col1 = tg
    hit = col1 > 0
    h3 = hit[:, None]
    a = world.attr_rows[:, torch.clamp(col1 - 1, min=0).long()].T  # (N, 16)
    rec = HitRecord(
        t=torch.where(hit, t, F_MAX),
        normal=torch.where(h3, a[:, 0:3], 0.0),
        mat_type=torch.where(hit, a[:, 3].to(torch.int32), 0),
        mat_color=torch.where(h3, a[:, 4:7], 0.0),
        geom_normal=torch.where(h3, a[:, 7:10], 0.0),
        mat_ri=torch.where(hit, a[:, 11], 1.5),
    )
    state = RayState(
        orig=pack[:, 0:3], dir=pack[:, 3:6], color=pack[:, 6:9],
        remaining=pack[:, 9].to(torch.int32),
    )
    s = shade(state, rec, u, parity=parity)
    return torch.cat([s.orig, s.dir, s.color, s.remaining.to(torch.float32)[:, None]], dim=1)


defer_shade_plain.calls = 0


def defer_shade_apply(world: WorldTriangles, pack: torch.Tensor, tg, u: torch.Tensor, parity: bool,
                      pix=None, b: int = 0):
    """The shading half of a deferred bounce: the next (N, 10) state of
    ``pack`` after the bounce whose winner kernel 3 found, ``tg = (t,
    column + 1)``.  ``u``: this bounce's (N, 4) uniforms, or with ``pix``
    the wavefront's (M, 4 * max_bounces) stream, of which ray i takes row
    ``pix[i]``, column block ``b``.  Kernel S1 (:func:`.defer_shade.defer_shade`,
    one launch) for tensors on the card, its plain twin
    :func:`defer_shade_plain` for CPU ones."""
    with annotate("ptap.shade"):
        if pack.device.type != "cpu":
            return KS.defer_shade(pack, tg[0], tg[1], world.attr_rows, u, parity, pix, b)
        if pix is not None:
            u = u[:, 4 * b:4 * b + 4][pix]
        return defer_shade_plain(world, pack, tg, u, parity)


def sample_groups(n_samples: int):
    """Sizes of the sample groups sorted as one wavefront: full groups of
    ``BINNED_SAMPLE_BATCH``, then the remainder one by one (the
    reference's order of summation)."""
    n_full = n_samples - n_samples % BINNED_SAMPLE_BATCH
    return [BINNED_SAMPLE_BATCH] * (n_full // BINNED_SAMPLE_BATCH) + [1] * (n_samples - n_full)


def inverse_permutation(pix: torch.Tensor) -> torch.Tensor:
    inv = torch.empty_like(pix)
    inv[pix] = torch.arange(pix.shape[0], device=pix.device)
    return inv


def primary_shade_plain(hits0, ro_p, rd_p, u_flat, max_bounces: int, parity: bool):
    """Plain twin of kernel S1's bounce 0: the (ns * n_pad, 10) state pack
    of ``ns = u_flat.shape[0] // n_pad`` samples of the primary rays, each
    shaded from its hit record ``hits0`` with its row of ``u_flat``'s
    first column block, in torch ops."""
    primary_shade_plain.calls += 1
    ns = u_flat.shape[0] // ro_p.shape[0]

    def big(x):
        return x.repeat((ns,) + (1,) * (x.dim() - 1))

    state = RayState.primary(big(ro_p), big(rd_p), max_bounces)
    hits = HitRecord(**{f: None if getattr(hits0, f) is None else big(getattr(hits0, f))
                        for f in HitRecord.__dataclass_fields__})
    state = shade(state, hits, u_flat[:, 0:4], parity=parity)
    return torch.cat(
        [state.orig, state.dir, state.color, state.remaining.to(torch.float32)[:, None]], dim=1
    )


primary_shade_plain.calls = 0


def first_wavefront(world, ro_p, rd_p, hits0, key, s0: int, ns: int, n: int, max_bounces: int,
                    parity: bool, tile_base: int):
    """Samples ``s0 .. s0 + ns`` as one wavefront after bounce 0: the
    (ns * n_pad, 10) state pack and its (ns * n_pad, 4 * max_bounces)
    uniforms, rows in (sample, ray) order.  Bounce 0 is shaded by kernel
    S1 (:func:`.defer_shade.defer_shade_primary`) for tensors on the card,
    by its plain twin :func:`primary_shade_plain` for CPU ones."""
    n_pad = ro_p.shape[0]
    with annotate("ptap.shade"):
        u_flat = chunk_uniforms(key, range(s0, s0 + ns), max_bounces, n, n_pad, tile_base)
        if ro_p.device.type != "cpu":
            pack = KS.defer_shade_primary(hits0, ro_p, rd_p, u_flat, max_bounces, parity)
        else:
            pack = primary_shade_plain(hits0, ro_p, rd_p, u_flat, max_bounces, parity)
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
    sample_offset: int = 0,
    parity: bool = True,
    tile_base: int = 0,
    debug: bool = None,
) -> torch.Tensor:
    """Accumulate samples ``sample_offset .. sample_offset + n_samples``
    with per-bounce ray binning; returns the (N, 3) contribution sums.
    Parity camera only: the primary hits are traced once and shared by
    every sample.

    Samples go in groups of ``BINNED_SAMPLE_BATCH`` from ``sample_offset``,
    each group sorted as one wavefront, then the remainder one by one (JAX
    ``megakernel.py:2208-2230``); every ray keeps its own (sample, pixel)
    uniform stream through ``pix``, so grouping changes no bit of the
    result.  ``debug``: kernels 1 and 2 in their explicit-mask form (None:
    ``PTAP_DEBUG``)."""
    debug = resolve_debug(debug)
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
    with annotate("ptap.trace_primary"):
        hits0 = trace_pallas(world, ro_p, rd_p, debug=debug)
    lo, hi = scene_morton_bounds(world.block_aabb)

    acc = torch.zeros((n_pad, 3), dtype=torch.float32, device=dev)
    s0 = sample_offset
    for ns in sample_groups(n_samples):
        pack, u_flat = first_wavefront(
            world, ro_p, rd_p, hits0, key, s0, ns, n, max_bounces, parity, tile_base
        )
        pix = torch.arange(ns * n_pad, device=dev)
        for b in range(1, max_bounces):
            with annotate("ptap.sort"):
                pack, pix = sort_wavefront(pack, pix, lo, hi)
            with annotate("ptap.worklists"):
                lists, unit = bounce_lists(world, margin, pack, ray_tile)
            with annotate("ptap.bounce"):
                pack, _ = bounce(pack, u_flat[:, 4 * b:4 * b + 4][pix], lists, unit, world,
                                 ray_tile, parity, debug)
        with annotate("ptap.accumulate"):
            contrib = torch.sqrt(torch.clamp(pack[:, 6:9], min=0.0))
            acc = acc + contrib[inverse_permutation(pix)].reshape(ns, n_pad, 3).sum(dim=0)
        s0 += ns
    return acc[:n]


def render_accumulate_binned(world, ro, rd, key, n_samples, max_bounces, sample_offset=0,
                             parity=True, debug=None, tile_base=0):
    """The facade's binned loop: ``BINNED_SLAB_TILES`` RNG tiles of rays per
    call, with the global RNG tile numbering ``tile_base + s0 // 8192``."""
    slab = BINNED_SLAB_TILES * RNG_TILE
    parts = [
        render_samples_binned(
            world, ro[s0:s0 + slab], rd[s0:s0 + slab], key, n_samples, max_bounces,
            sample_offset=sample_offset, parity=parity, tile_base=tile_base + s0 // RNG_TILE,
            debug=debug,
        )
        for s0 in range(0, ro.shape[0], slab)
    ]
    return torch.cat(parts)


# ---------------------------------------------------------------------------
# Fused whole-sample engine: kernel 4 runs every bounce of a sample.
# ---------------------------------------------------------------------------


def primary_pack(hits: HitRecord, idx1=None) -> torch.Tensor:
    """The (N, 16) primary-hit rows kernel 4 shades bounce 0 from:
    ``[t, shade_n, mat_type, rgb, geom_n, idx+1, ri, 0, 0, 0]``.  ``idx1``
    (N,) is the hit's index + 1 that the ``emit_idx`` stream repeats at
    bounce 0; the render leaves it 0."""
    n = hits.t.shape[0]
    dev = hits.t.device
    col11 = (
        torch.zeros((n, 1), device=dev) if idx1 is None else idx1.to(torch.float32)[:, None]
    )
    return torch.cat(
        [
            hits.t[:, None], hits.normal, hits.mat_type.to(torch.float32)[:, None],
            hits.mat_color, hits.geom_normal, col11, hits.mat_ri[:, None],
            torch.zeros((n, 3), device=dev),
        ],
        dim=1,
    )


def _sample_plain(w16, prim, u, world, max_bounces: int, parity: bool, use_primary: bool, live,
                  debug: bool):
    """One sample of kernel 4's plain version: (contribution (N, 3),
    index stream (N, max_bounces) int32)."""
    n = w16.shape[0]
    dev = w16.device
    pack = torch.cat(
        [w16[:, 6:9], w16[:, 0:3], torch.ones((n, 3), device=dev),
         torch.full((n, 1), float(max_bounces), device=dev)],
        dim=1,
    )
    cols = []
    for b in range(max_bounces):
        alive = pack[:, 9] > 0.0
        if live is not None:
            live.append(alive)
        if b == 0 and use_primary:
            hits = HitRecord(
                t=prim[:, 0], normal=prim[:, 1:4], mat_type=prim[:, 4], mat_color=prim[:, 5:8],
                geom_normal=prim[:, 8:11], mat_ri=prim[:, 12],
            )
            idx1 = prim[:, 11].to(torch.int32)
        else:
            t, idx = nearest_hit_fused_plain(
                _ray_vectors(pack), world.fused_ops, world.block_aabb.shape[0], world.tri_block,
                debug,
            )
            hits, idx1 = _attr_hits(world, t, idx), idx + 1
        cols.append(torch.where(alive, idx1, 0))
        pack = _shade_pack(pack, hits, u[:, 4 * b:4 * b + 4], parity)
    return torch.sqrt(torch.clamp(pack[:, 6:9], min=0.0)), torch.stack(cols, dim=1)


def sample_fused_plain(w16, prim, u, world, max_bounces: int, parity: bool, use_primary: bool,
                       emit_idx: bool = False, live=None, debug: bool = False):
    """Plain version of kernel 4.  Per sample: bounce 0 from the primary
    rows (``use_primary``) or traced, every later bounce traced over every
    real block, the winner's attribute rows gathered and shaded with the
    kernel's math.  Returns the (N, 3) contribution ``sqrt(max(color,
    0))``, summed in sample order when ``u`` is (ns, N, 4 * max_bounces);
    with ``emit_idx`` also the (N, max_bounces) int32 stream of index + 1
    where the ray was live and hit, else 0.  ``live``, a list, receives
    each (sample, bounce)'s (N,) bool mask of live rays.  ``debug``: the
    explicit-mask accept chain."""
    sample_fused_plain.calls += 1
    acc = idxs = None
    for us in (u if u.dim() == 3 else u[None]):
        c, idxs = _sample_plain(w16, prim, us, world, max_bounces, parity, use_primary, live, debug)
        acc = c if acc is None else acc + c
    return (acc, idxs) if emit_idx else acc


sample_fused_plain.calls = 0


def sample_fused(
    w16: torch.Tensor,  # (N, 16) ray vectors (fused_rays), N a multiple of RAY_TILE
    prim: torch.Tensor,  # (N, 16) primary-hit rows (primary_pack); read when use_primary
    u: torch.Tensor,  # (N, 4 * max_bounces) one sample's uniforms, or (ns, N, 4 * max_bounces)
    world: WorldTriangles,
    max_bounces: int,
    parity: bool,
    use_primary: bool,
    emit_idx: bool = False,
    debug: bool = None,
    pairs: torch.Tensor = None,
):
    """Whole samples through kernel 4: every bounce, every real block.
    Returns the (N, 3) contribution (summed over the samples of a batch),
    and with ``emit_idx`` (one sample only) the (N, max_bounces) int32
    index + 1 stream.  ``debug`` selects the explicit-mask accept chain
    (None: ``PTAP_DEBUG``).  Launches kernel 4 for CUDA tensors (counted
    in ``sample_fused.launches``), runs the plain version for CPU ones.
    ``pairs``, an int64 (N / FUSED_TILE, 2) CUDA tensor, receives each
    thread block's count of the (ray, triangle) pairs its sweeping warps
    issued (every lane of a warp that sweeps) and of those of live rays;
    the plain version counts nothing."""
    debug = resolve_debug(debug)
    n = w16.shape[0]
    batched = u.dim() == 3
    if n % RAY_TILE:
        raise ValueError(f"{n} rays are not a multiple of the {RAY_TILE}-ray tile")
    if emit_idx and batched:
        raise ValueError("emit_idx runs one sample per launch")
    if pairs is not None and pairs.device.type != "cuda":
        raise ValueError("pairs counts the kernel's sweep: it needs a CUDA tensor")
    if w16.device.type == "cpu":
        return sample_fused_plain(w16, prim, u, world, max_bounces, parity, use_primary, emit_idx,
                                  debug=debug)
    if w16.device.type != "cuda":
        raise ValueError(f"no kernel for device {w16.device}")
    tb = world.tri_block
    if tb % SWEEP_RUN:
        raise ValueError(f"tri_block {tb} is not a multiple of {SWEEP_RUN}")
    dev = w16.device
    ns = u.shape[0] if batched else 1
    ucols = 4 * max_bounces
    ops, n_tris = sweep_operands(world)
    attr, aabb = world.attr_rows, world.block_aabb
    nb = aabb.shape[0]
    _check(w16, "w16", torch.float32, (n, 16), dev)
    _check(prim, "prim", torch.float32, (n, 16), dev)
    _check(u, "u", torch.float32, (ns, n, ucols) if batched else (n, ucols), dev)
    _check(ops, "ops_tri", torch.float32, (ops.shape[0], 24), dev)
    _check(attr, "attr_rows", torch.float32, (16, ops.shape[0]), dev)
    _check(aabb, "block_aabb", torch.float32, (nb, 8), dev)
    if pairs is not None:
        _check(pairs, "pairs", torch.int64, (n // FUSED_TILE, 2), dev)
    if ops.shape[0] < nb * tb:
        raise ValueError("ops_tri holds fewer blocks than block_aabb")
    n_tris = min(n_tris, nb * tb)  # the real triangles of the swept blocks
    margin = _slab_margin(aabb).reshape(1)
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    idx = torch.empty((n, max_bounces), dtype=torch.int32, device=dev) if emit_idx else None
    err = _build.library().ptt_sample_fused(
        ctypes.c_void_p(w16.data_ptr()),
        ctypes.c_void_p(prim.data_ptr()),
        ctypes.c_void_p(u.data_ptr()),
        ctypes.c_int(n),
        ctypes.c_int(ns),
        ctypes.c_int(max_bounces),
        ctypes.c_void_p(ops.data_ptr()),
        ctypes.c_int(n_tris),
        ctypes.c_void_p(attr.data_ptr()),
        ctypes.c_int(attr.shape[1]),
        ctypes.c_void_p(aabb.data_ptr()),
        ctypes.c_void_p(margin.data_ptr()),
        ctypes.c_int(-(-n_tris // tb)),
        ctypes.c_int(tb),
        ctypes.c_int(int(parity)),
        ctypes.c_int(int(use_primary)),
        ctypes.c_int(int(nb > GATE_BLOCKS)),
        ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(idx.data_ptr() if emit_idx else None),
        ctypes.c_void_p(pairs.data_ptr() if pairs is not None else None),
        ctypes.c_int(int(debug)),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    _build.check(err, "ptt_sample_fused")
    sample_fused.launches += 1
    return (out, idx) if emit_idx else out


sample_fused.launches = 0


def render_samples_fused(
    world: WorldTriangles,
    ro: torch.Tensor,
    rd: torch.Tensor,
    key: torch.Tensor,
    n_samples: int,
    max_bounces: int,
    sample_offset: int = 0,
    parity: bool = True,
    tile_base: int = 0,
    jitter_step=None,
    debug: bool = None,
) -> torch.Tensor:
    """Accumulate samples ``sample_offset .. sample_offset + n_samples``
    through kernel 4; returns the (N, 3) contribution sums (JAX
    ``render_samples_fused``).

    Rays are padded to ``RAY_TILE``.  Without ``jitter_step`` the primary
    hits are traced once (kernel 1) and shared by every sample, which go
    in batches of ``SAMPLE_BATCH`` per launch from ``sample_offset``; the
    batch sums in sample order, then adds to the total.  With
    ``jitter_step`` (pixel steps of the quality camera) every sample moves
    the unnormalized directions by its jitter, normalizes them and traces
    its primaries in the kernel, one launch per sample.  ``debug``: kernels
    1 and 4 in their explicit-mask form (None: ``PTAP_DEBUG``)."""
    debug = resolve_debug(debug)
    n = ro.shape[0]
    dev = ro.device
    rd_n = normalize(rd)
    pad = (-n) % RAY_TILE
    if pad:
        ro_p = torch.cat([ro, ro.new_zeros(pad, 3)])
        rd_p = torch.cat([rd_n, rd_n.new_ones(pad, 3)])
        rd_raw = torch.cat([rd, rd.new_ones(pad, 3)])
    else:
        ro_p, rd_p, rd_raw = ro, rd_n, rd
    n_pad = ro_p.shape[0]
    acc = torch.zeros((n_pad, 3), dtype=torch.float32, device=dev)

    if jitter_step is None:
        with annotate("ptap.trace_primary"):
            prim = primary_pack(trace_pallas(world, ro_p, rd_p, debug=debug))
        w16 = ray_vectors(ro_p, rd_p)
        for s0 in range(sample_offset, sample_offset + n_samples, SAMPLE_BATCH):
            ns = min(SAMPLE_BATCH, sample_offset + n_samples - s0)
            u = chunk_uniforms(key, range(s0, s0 + ns), max_bounces, n, n_pad, tile_base)
            u = u.reshape(ns, n_pad, 4 * max_bounces)
            acc = acc + sample_fused(w16, prim, u, world, max_bounces, parity, True, debug=debug)
        return acc[:n]

    prim = torch.zeros((n_pad, 16), dtype=torch.float32, device=dev)
    zero = torch.zeros((n_pad, 1), dtype=torch.float32, device=dev)
    for s in range(sample_offset, sample_offset + n_samples):
        u = chunk_uniforms(key, s, max_bounces, n, n_pad, tile_base)
        ju = chunk_jitter_uniforms(key, s, n, n_pad, tile_base)
        # the jitter moves the unnormalized image-plane direction (pix - eye)
        rd_s = rd_raw + torch.cat([ju[:, 0:1] * jitter_step[0], ju[:, 1:2] * jitter_step[1], zero], 1)
        w = ray_vectors(ro_p, normalize(rd_s))
        acc = acc + sample_fused(w, prim, u, world, max_bounces, parity, False, debug=debug)
    return acc[:n]


def render_accumulate_fused(world, ro, rd, key, n_samples, max_bounces, sample_offset=0,
                            parity=True, jitter_step=None, debug=None, tile_base=0):
    """The facade's fused loop: ``FUSED_SLAB_TILES`` RNG tiles of rays per
    call, with the global RNG tile numbering ``tile_base + s0 // 8192``."""
    slab = FUSED_SLAB_TILES * RNG_TILE
    parts = [
        render_samples_fused(
            world, ro[s0:s0 + slab], rd[s0:s0 + slab], key, n_samples, max_bounces,
            sample_offset=sample_offset, parity=parity, tile_base=tile_base + s0 // RNG_TILE,
            jitter_step=jitter_step, debug=debug,
        )
        for s0 in range(0, ro.shape[0], slab)
    ]
    return torch.cat(parts)
