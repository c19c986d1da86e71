"""Differentiable render at the kernels' forward speed (port of
``pathtracerap_tpu/diff/fast.py``).

The per-bounce ``pallas`` diff engine traces each bounce through
:func:`trace_pallas_diff`: the kernel picks the triangle, and
:func:`hit_from_index` recomputes the hit differentiably.  The rest of
this module serves ``engine="fused"``.

The discrete part of traversal, which triangle each bounce hits, comes
from the kernels under ``torch.no_grad()`` on a detached world: the
primary hits from kernel 1, every later bounce from kernel 3 through the
binned deferred-trace forward (:func:`make_idxs_multi`), or on a
single-block scene from kernel 4's per-bounce index stream.  The continuous
part is replayed differentiably at those frozen indices with plain torch
ops (:func:`hit_from_index` + ``render.shade.shade`` per bounce, or
:func:`replay_color_only` when only material colors are trained), so
autograd's backward costs O(rays x bounces) and no kernel needs a
backward of its own.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from .. import constants
from ..kernels import megakernel as MK
from ..kernels.trace import RAY_TILE, _slab_margin, ray_vectors, trace_pallas
from ..ops.intersect import HitRecord, averaged_normal, normal_matrix
from ..ops.intersect import normalize as intersect_normalize
from ..ops.math import cross3, dot3, normalize, normalize_guarded
from ..ops.rng import chunk_uniforms
from ..render.shade import RayState, gather_contribution, shade
from ..scene.types import MaterialType, WorldTriangles
from ..utils.profiling import annotate

F_MAX = constants.FLOAT_MAX


def slot_color(mat_table: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """``mat_table[slot]`` (N, 3) as a one-hot product: its backward is a
    plain reduction over the rays (deterministic), where the gather's is a
    scatter-add (atomics on the card).  Written as an explicit sum over the
    slots, not a matmul: the forward has one nonzero term per ray and so
    equals ``mat_table[slot]`` bit for bit, whatever
    ``torch.backends.cuda.matmul.allow_tf32`` says (a TF32 matmul would
    round the albedo to a 10-bit mantissa)."""
    onehot = torch.nn.functional.one_hot(slot.long(), mat_table.shape[0]).to(mat_table.dtype)
    return (onehot[:, :, None] * mat_table[None, :, :]).sum(dim=1)


class _IndexAddGather(torch.autograd.Function):
    """``table[idx]`` whose backward sums the rows' cotangents with
    ``index_add_``.  The default backward of an index gather on the card is
    a deterministic kernel that walks each run of equal indices serially;
    the replay's indices repeat heavily (a wall triangle takes most of the
    rays of a bounce), and that kernel took 9.6 ms a call at 131,072 rays
    on an H100 80GB HBM3 (700 W).  ``index_add_`` adds with atomics there:
    fast, but the order of each row's sum, and so its last bits, varies
    from run to run.  On the CPU it sums in index order."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        return grad.new_zeros((ctx.rows, grad.shape[1])).index_add_(0, idx, grad), None


def hit_from_index(
    world: WorldTriangles, ro: torch.Tensor, rd_n: torch.Tensor, idx: torch.Tensor,
    hit: torch.Tensor,
) -> HitRecord:
    """Differentiable hit quantities at a frozen triangle index (N,) int64.

    Moeller-Trumbore with the triangle's (v0, e1, e2); ``hit`` masks lanes
    whose kernel trace missed (their values are the miss sentinels, whose
    gradient is zero by construction of the ``where``)."""
    geo = torch.cat([world.v0, world.e1, world.e2, world.shade_normal], dim=1)  # (T, 12)
    rows = _IndexAddGather.apply(geo, idx)
    v0, e1, e2, nsh = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9], rows[:, 9:12]
    pvec = cross3(rd_n, e2)
    det = dot3(e1, pvec)
    safe = torch.where(det == 0.0, 1.0, det)
    qvec = cross3(ro - v0, e1)
    t = dot3(e2, qvec) / safe
    h3 = hit[:, None]
    return HitRecord(
        t=torch.where(hit, t, F_MAX),
        normal=torch.where(h3, nsh, 0.0),
        mat_type=torch.where(hit, world.mat_type[idx], 0),
        mat_color=torch.where(h3, slot_color(world.mat_table, world.tri_model[idx]), 0.0),
        # geometric normal straight from positions: the quality-mode
        # cosine factor's vertex-gradient carrier (render/shade.py)
        geom_normal=torch.where(h3, normalize_guarded(cross3(e1, e2)), 0.0),
        mat_ri=torch.where(hit, world.mat_ri[idx], 1.5),
    )


def parity_hit_from_model(scene, rec: HitRecord, with_normal: bool) -> HitRecord:
    """The parity engine's hit record with its attributes gathered under
    autograd from the winner the trace froze (``rec.model``, ``rec.tri``;
    -1 where none): ``mat_color`` from the winning model's row, and with
    ``with_normal`` (quality mode, where the cosine factor reads it) the
    world normal, the winning model's normal matrix of ``model_to_world``
    applied to the averaged vertex normal of its triangle.  The values are
    the trace's, operation for operation (:func:`..ops.intersect.trace_parity`);
    lanes without a winner (or whose winner set no triangle, a NaN t) keep
    the trace's values and gather model 0 and a unit normal, so that no
    NaN of an unused branch reaches the gradient."""
    hit = rec.model >= 0
    h3 = hit[:, None]
    idx = rec.model.clamp(min=0).long()
    color = torch.where(h3, _IndexAddGather.apply(scene.mat_color, idx), rec.mat_color)
    normal = rec.normal
    if with_normal:
        nm = _IndexAddGather.apply(normal_matrix(scene.model_to_world).reshape(-1, 9), idx)
        nm = nm.reshape(-1, 3, 3)
        has_tri = rec.tri >= 0
        n_model = averaged_normal(scene.vertex_nrm, scene.tri_vidx[rec.tri.clamp(min=0)].long())
        n_model = torch.where(has_tri[:, None], n_model, n_model.new_tensor([1.0, 0.0, 0.0]))
        # intersect.mat3_apply with a matrix a ray
        acc = n_model[:, 0:1] * nm[:, :, 0]
        acc = torch.addcmul(acc, n_model[:, 1:2], nm[:, :, 1])
        world_n = intersect_normalize(torch.addcmul(acc, n_model[:, 2:3], nm[:, :, 2]))
        normal = torch.where(h3 & has_tri[:, None], world_n, rec.normal)
    return dataclasses.replace(rec, mat_color=color, normal=normal)


def replay(world, ro_p, rd_p, idxs, u, max_bounces: int, parity: bool) -> torch.Tensor:
    """Differentiable replay of one sample from its frozen (N, max_bounces)
    index stream (column + 1, 0 = miss) and its (N, 4 * max_bounces)
    uniforms; returns the (N, 3) contribution."""
    state = RayState.primary(ro_p, rd_p, max_bounces)
    for b in range(max_bounces):
        ib = idxs[:, b]
        hit = ib > 0
        rec = hit_from_index(
            world, state.orig, normalize(state.dir), torch.clamp(ib - 1, min=0).long(), hit
        )
        state = shade(state, rec, u[:, 4 * b:4 * b + 4], parity=parity)
    return gather_contribution(state)


def replay_color_only(world: WorldTriangles, idxs: torch.Tensor, max_bounces: int) -> torch.Tensor:
    """Differentiable replay of one sample's contribution from the frozen
    per-bounce hit topology, tracking only the throughput color.

    In parity mode the color is a pure product of surface albedos over the
    path (the reference dropped the cosine factor, Renderer.cpp:438), so
    when only material colors are trained the replay needs just (hit?,
    material type, material color) per bounce.  The mask algebra mirrors
    :func:`..render.shade.shade`; the values equal the full replay's."""
    n = idxs.shape[0]
    dev = idxs.device
    color = torch.ones((n, 3), dtype=torch.float32, device=dev)
    remaining = torch.full((n,), max_bounces, dtype=torch.int32, device=dev)
    M = MaterialType
    for b in range(max_bounces):
        ib = idxs[:, b]
        hit = ib > 0
        tri = torch.clamp(ib - 1, min=0).long()
        mt = world.mat_type[tri]
        mc = torch.where(hit[:, None], slot_color(world.mat_table, world.tri_model[tri]), 0.0)
        alive = remaining > 0
        scatters = (
            (mt == int(M.DIFFUSE)) | (mt == int(M.METAL)) | (mt == int(M.COAT))
            | (mt == int(M.REFLECTIVE))
        )
        is_emissive = mt == int(M.EMISSIVE)
        shaded = alive & hit
        upd_col = shaded & (scatters | is_emissive)
        color = torch.where(upd_col[:, None], color * mc, color)
        missed = alive & ~hit
        color = torch.where(missed[:, None], color * constants.MISS_ATTENUATION, color)
        kill = missed | (shaded & is_emissive)
        remaining = torch.where(
            kill, torch.zeros_like(remaining), torch.where(alive, remaining - 1, remaining)
        )
    return torch.sqrt(torch.clamp(color, min=0.0))


def trace_pallas_diff(world: WorldTriangles, ro: torch.Tensor, rd: torch.Tensor,
                      alive=None) -> HitRecord:
    """Differentiable tracer at the kernels' forward speed: the same result
    contract as :func:`..kernels.trace.trace_pallas`.  The kernel (kernel
    1's worklists, or kernel 5's dense sweep on a world without a pack)
    picks each ray's triangle on detached inputs; :func:`hit_from_index`
    recomputes the hit there, so gradients reach the world through it."""
    rd_n = normalize(rd)
    with torch.no_grad():
        rec, idx = trace_pallas(world.detached(), ro.detach(), rd_n.detach(), alive=alive,
                                return_idx=True)
    return hit_from_index(world, ro, rd_n, idx.long(), rec.t < F_MAX)


def binned_forward_active(world: WorldTriangles) -> bool:
    """True when :func:`render_samples_fused_diff` runs the binned
    deferred-trace forward for this world: sub-block worklists over two or
    more blocks."""
    return MK.use_sub_blocks(world) and world.block_aabb.shape[0] >= 2


def make_idxs_multi(world, ro_p, rd_p, hits0, idx_col0, key, s0: int, ns: int, n: int,
                    max_bounces: int, parity: bool, tile_base: int):
    """The frozen hit topology of samples ``s0 .. s0 + ns``, traced as one
    sorted wavefront: returns the (ns, n_pad, max_bounces) int32 index
    streams (column + 1, 0 = miss) and the (ns, n_pad, 4 * max_bounces)
    uniforms.  ``world`` is detached; call under ``torch.no_grad()``."""
    n_pad = ro_p.shape[0]
    pack, u_flat = MK.first_wavefront(
        world, ro_p, rd_p, hits0, key, s0, ns, n, max_bounces, parity, tile_base
    )
    ray_tile = MK.binned_ray_tile(world)
    margin = _slab_margin(world.block_aabb)
    lo, hi = MK.scene_morton_bounds(world.block_aabb)
    pix = torch.arange(ns * n_pad, device=pack.device)
    cols = [idx_col0.repeat(ns)]
    for b in range(1, max_bounces):
        with annotate("ptap.sort"):
            pack, pix = MK.sort_wavefront(pack, pix, lo, hi)
        with annotate("ptap.worklists"):
            lists, unit = MK.bounce_lists(world, margin, pack, ray_tile)
        tg = MK.bounce_trace(pack, lists, unit, world, ray_tile)
        cols.append(tg[1][MK.inverse_permutation(pix)])  # in the original ray order
        pack = MK.defer_shade_apply(world, pack, tg, u_flat[:, 4 * b:4 * b + 4][pix], parity)
    idxs = torch.stack(cols, dim=1).reshape(ns, n_pad, max_bounces)
    return idxs, u_flat.reshape(ns, n_pad, 4 * max_bounces)


def render_samples_fused_diff(
    world: WorldTriangles,
    ro: torch.Tensor,
    rd: torch.Tensor,
    key: torch.Tensor,
    n_samples: int,
    max_bounces: int,
    parity: bool = True,
    tile_base: int = 0,
    color_only: bool = False,
) -> torch.Tensor:
    """Differentiable (N, 3) contribution sums (pre-normalization) of
    samples ``0 .. n_samples``.

    The kernels run under ``torch.no_grad()`` on the detached world and
    record each sample's per-bounce winning index: the binned
    deferred-trace forward (:func:`make_idxs_multi`) where
    :func:`binned_forward_active`, else kernel 4's ``emit_idx`` stream
    (single-block scenes).  The replay then builds the only autograd
    graph: :func:`replay_color_only` when ``color_only`` (parity mode),
    else the full :func:`replay` under
    ``torch.utils.checkpoint``, which keeps (indices, uniforms) per sample
    and recomputes the replay in the backward instead of holding every
    bounce's shading intermediates for every sample.  The uniforms are the
    engines' own (``chunk_uniforms``), so values match the forward
    render's engine."""
    n = ro.shape[0]
    rd_n = normalize(rd)
    pad = (-n) % RAY_TILE  # the JAX diff forward's padding, not the binned tile
    if pad:
        ro_p = torch.cat([ro, ro.new_zeros(pad, 3)])
        rd_p = torch.cat([rd_n, rd_n.new_ones(pad, 3)])
    else:
        ro_p, rd_p = ro, rd_n
    n_pad = ro_p.shape[0]
    sworld = world.detached()
    ro_s, rd_s = ro_p.detach(), rd_p.detach()
    binned = binned_forward_active(sworld)
    with torch.no_grad(), annotate("ptap.train.index_forward"):
        with annotate("ptap.trace_primary"):
            hits0, idx0 = trace_pallas(sworld, ro_s, rd_s, return_idx=True)
        idx_col0 = torch.where(hits0.t < F_MAX, idx0 + 1, 0)
        if not binned:
            prim = MK.primary_pack(hits0, idx_col0)
            w16 = ray_vectors(ro_s, rd_s)

    def replay_any(idxs, u):
        # the n real rays only: a padding ray's color can be exactly 0, and
        # sqrt's backward there is 0 / 0 = NaN even under a zero cotangent
        # (the JAX forward replays the padding too; ROADMAP queue C)
        idxs, u = idxs[:n], u[:n]
        with annotate("ptap.train.replay"):
            if color_only and parity:
                return replay_color_only(world, idxs, max_bounces)
            return checkpoint(replay, world, ro, rd_n, idxs, u, max_bounces, parity,
                              use_reentrant=False)

    acc = torch.zeros((n, 3), dtype=torch.float32, device=ro.device)
    if not binned:
        # single-block scenes: kernel 4's emit_idx stream, one sample a launch
        for s in range(n_samples):
            with torch.no_grad(), annotate("ptap.train.index_forward"):
                u = chunk_uniforms(key, s, max_bounces, n, n_pad, tile_base)
                _, idxs = MK.sample_fused(w16, prim, u, sworld, max_bounces, parity,
                                          use_primary=True, emit_idx=True)
            acc = acc + replay_any(idxs, u)
        return acc

    s0 = 0
    for ns in MK.sample_groups(n_samples):
        with torch.no_grad(), annotate("ptap.train.index_forward"):
            idxs, u = make_idxs_multi(
                sworld, ro_s, rd_s, hits0, idx_col0, key, s0, ns, n, max_bounces, parity, tile_base
            )
        for j in range(ns):
            acc = acc + replay_any(idxs[j], u[j])
        s0 += ns
    return acc
