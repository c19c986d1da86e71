"""Differentiable rendering and inverse rendering (port of
``pathtracerap_tpu/diff/grad.py``).

Gradients reach material colors, vertex positions and model transforms
through the world bake, which runs inside the loss.  The discrete winner
of each bounce (argmin triangle, material branch) is frozen hit topology,
the detached-sampling estimator: gradients flow through throughput
products, hit points and normals, not through visibility changes.  The
image is the mean of per-sample ``sqrt`` tone-mapped throughputs.

Parameters are plain dicts of tensors (``extract_params``); a train step
is :func:`loss_and_grad` (``torch.autograd.grad``) and the update
``p - lr * g``; :func:`make_sharded_train_step` splits the rays over the
ranks of a ``torch.distributed`` group and sums the gradients.  Four diff
engines: ``pallas`` (the default), the
per-bounce engine of :mod:`..render.wavefront` tracing through
:func:`.fast.trace_pallas_diff`; ``mxu``, the same engine differentiated
straight through :func:`..ops.plucker.trace_mxu`; ``parity``, the same
engine on the grid DDA (kernel G1), whose material colour (and in quality
mode world normal) is gathered from the traced winner
(:func:`.fast.parity_hit_from_model`); and ``fused``, the binned
deferred-trace forward of :mod:`.fast` (or on single-block scenes its
fused ``emit_idx`` forward), which falls back to ``pallas`` on a world
without a fused pack.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from ..kernels.dda import grid_trace
from ..kernels.megakernel import BINNED_SLAB_TILES, FUSED_SLAB_TILES
from ..ops.plucker import bake_world_triangles, trace_mxu
from ..ops.rng import RNG_TILE
from ..parallel.sharding import all_reduce_sum, default_mesh, pad_share, rank_share
from ..render.camera import generate_rays
from ..render.wavefront import _make_tracer, _render_tile
from ..scene.types import SceneDevice
from ..utils.profiling import annotate
from .fast import (
    binned_forward_active, parity_hit_from_model, render_samples_fused_diff, trace_pallas_diff,
)

DEFAULT_PARAMS: Tuple[str, ...] = ("mat_color",)
DEFAULT_DIFF_ENGINE = "pallas"


def extract_params(scene: SceneDevice, names: Sequence[str] = DEFAULT_PARAMS) -> Dict:
    """Pull the optimizable tensors out of the scene."""
    return {n: getattr(scene, n) for n in names}


def apply_params(scene: SceneDevice, params: Dict) -> SceneDevice:
    return scene.replace(**params)


def render_for_params(
    params: Dict,
    scene: SceneDevice,
    key: torch.Tensor,
    camera,
    resolution,
    n_samples: int,
    max_bounces: int,
    tile_size: int = 2048,
    ro=None,
    rd=None,
    tile_base: int = 0,
    engine: str = DEFAULT_DIFF_ENGINE,
    parity: bool = True,
) -> torch.Tensor:
    """(N, 3) image (mean contribution) as a differentiable function of
    ``params``.  ``ro``/``rd`` may be passed for pre-split ray slices;
    ``tile_base`` is then their first RNG tile: of 8192 rays for
    ``fused``, of ``tile_size`` rays for the per-bounce ``pallas`` and
    ``mxu``.  ``parity=False`` enables the quality-mode cosine throughput
    factor, so color carries vertex gradients."""
    s = apply_params(scene, params)
    world = None if engine == "parity" else bake_world_triangles(s)
    if ro is None:
        ro, rd = generate_rays(camera, resolution, device=s.device)
    if engine == "fused" and world.fused_ops is None:
        # no fused pack (above the bake's budget): the per-bounce pallas
        # engine, as render/wavefront.effective_engine routes a render
        engine = "pallas"
    if engine != "fused":
        if engine == "pallas":
            def tracer(ro_, rd_, alive=None):
                return trace_pallas_diff(world, ro_, rd_, alive=alive)
        elif engine == "parity":
            # the grid DDA (kernel G1, or its plain version on the CPU)
            # freezes each bounce's winning model and triangle; the
            # attributes are gathered from them under autograd
            def tracer(ro_, rd_, alive=None):
                with torch.no_grad():
                    rec = grid_trace(s, ro_.contiguous(), rd_.contiguous(), alive=alive)
                return parity_hit_from_model(s, rec, with_normal=not parity)
        else:
            tracer = _make_tracer(s, engine, world=world)
        acc = _render_tile(tracer, ro, rd, tile_base, key, n_samples, max_bounces, parity,
                           tile_size=tile_size)
        return acc / n_samples
    # the binned forward's slabs, or the fused emit_idx forward's 64 tiles
    tiles = BINNED_SLAB_TILES if binned_forward_active(world) else FUSED_SLAB_TILES
    slab = tiles * RNG_TILE
    # parity training of material colors only never reads geometry in
    # the color path: the color-only replay skips the geometry gathers
    color_only = parity and set(params.keys()) <= {"mat_color"}
    parts = [
        render_samples_fused_diff(
            world, ro[s0:s0 + slab], rd[s0:s0 + slab], key, n_samples, max_bounces,
            parity=parity, tile_base=tile_base + s0 // RNG_TILE, color_only=color_only,
        )
        for s0 in range(0, ro.shape[0], slab)
    ]
    return torch.cat(parts) / n_samples


def image_loss(
    params: Dict,
    scene: SceneDevice,
    target: torch.Tensor,
    key: torch.Tensor,
    camera,
    resolution,
    n_samples: int,
    max_bounces: int,
    tile_size: int = 2048,
    ro=None,
    rd=None,
    tile_base: int = 0,
    reduce: str = "mean",
    engine: str = DEFAULT_DIFF_ENGINE,
    parity: bool = True,
    weight=None,
) -> torch.Tensor:
    """Squared pixel loss against an (N, 3) target.  ``weight`` ((N,) or
    (N, 1)) scales each ray's error, e.g. to zero padding rays."""
    img = render_for_params(
        params, scene, key, camera, resolution, n_samples, max_bounces,
        tile_size=tile_size, ro=ro, rd=rd, tile_base=tile_base, engine=engine, parity=parity,
    )
    err = (img - target) ** 2
    if weight is not None:
        err = err * (weight if weight.dim() == 2 else weight[:, None])
    return err.mean() if reduce == "mean" else err.sum()


def render_aovs(params: Dict, scene: SceneDevice, camera, resolution, ro=None, rd=None):
    """Differentiable first-hit AOVs: (depth (N,), normal (N, 3), hit (N,)),
    through the brute-force tracer; smooth in vertex positions via the
    Pluecker-plane hit distance."""
    s = apply_params(scene, params)
    world = bake_world_triangles(s)
    if ro is None:
        ro, rd = generate_rays(camera, resolution, device=s.device)
    hits = trace_mxu(world, ro, rd)
    return hits.t, hits.normal, hits.hit


def geometry_loss(
    params: Dict,
    scene: SceneDevice,
    target_depth: torch.Tensor,
    target_normal: torch.Tensor,
    camera,
    resolution,
    normal_weight: float = 1.0,
    ro=None,
    rd=None,
) -> torch.Tensor:
    """Depth + normal matching loss for inverse-geometry fitting; misses
    are masked out on both sides."""
    depth, normal, hit = render_aovs(params, scene, camera, resolution, ro=ro, rd=rd)
    w = (hit & (target_depth < 9999999.0)).to(torch.float32)
    denom = torch.clamp(w.sum(), min=1.0)
    d_err = (w * (depth - target_depth) ** 2).sum() / denom
    n_err = (w[:, None] * (normal - target_normal) ** 2).sum() / denom
    return d_err + normal_weight * n_err


def value_and_grad(loss_fn, params: Dict):
    """``jax.value_and_grad(loss_fn)(params)``: (loss, grads), both
    detached.  A parameter the loss does not reach (vertex positions under
    the parity per-bounce engines, whose color is a pure albedo product)
    gets a zero gradient, as in JAX."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = loss_fn(leaves)
    with annotate("ptap.train.backward"):
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss.detach(), {
        k: torch.zeros_like(p) if g is None else g for (k, p), g in zip(leaves.items(), grads)
    }


def loss_and_grad(params: Dict, *args, **kwargs):
    """``jax.value_and_grad(image_loss)``: (loss, grads), both detached;
    ``args`` and ``kwargs`` are :func:`image_loss`'s after ``params``."""
    return value_and_grad(lambda p: image_loss(p, *args, **kwargs), params)


def make_train_step(
    scene: SceneDevice,
    camera,
    resolution,
    n_samples: int,
    max_bounces: int,
    lr: float = 0.05,
    tile_size: int = 2048,
    engine: str = DEFAULT_DIFF_ENGINE,
    parity: bool = True,
):
    """Single-device SGD step on the pixel loss; returns
    ``step(params, target, key) -> (loss, new_params)``, both detached."""

    def step(params, target, key):
        with annotate("ptap.train.step"):
            loss, grads = loss_and_grad(
                params, scene, target, key, camera, resolution, n_samples, max_bounces,
                tile_size=tile_size, engine=engine, parity=parity,
            )
            return loss, {k: p.detach() - lr * grads[k] for k, p in params.items()}

    return step


def make_sharded_train_step(
    scene: SceneDevice,
    camera,
    resolution,
    n_samples: int,
    max_bounces: int,
    mesh=None,
    lr: float = 0.05,
    tile_size: int = 2048,
    engine: str = DEFAULT_DIFF_ENGINE,
    overlap_chunks: int = 1,
    parity: bool = True,
):
    """Data-parallel train step over the ranks of ``mesh`` (a
    :class:`..parallel.sharding.Mesh`; default: the default process group):
    the rays are padded and split as the data-parallel render splits them,
    the loss is the SUM over rays (padding rays weighted 0), and the loss
    and gradients are ``all_reduce``d with SUM, so every rank applies the
    same SGD update.  Ray ``r``'s RNG tile is ``r // tile_size`` for any
    world size, so the result does not depend on it, up to the order of the
    sums.

    ``overlap_chunks > 1`` splits a rank's rays into that many chunks; each
    chunk's loss and gradients are reduced asynchronously and waited on
    after the next chunk's backward (JAX's per-chunk ``psum`` inside the
    scan, ``pathtracerap_tpu/diff/grad.py:313-344``).

    Returns ``step(params, target_flat, key) -> (loss, new_params)`` where
    ``target_flat`` is the (N, 3) target in ray order."""
    if mesh is None:
        mesh = default_mesh(scene.device)
    if engine == "fused":
        # the fused diff path's RNG stream is tiled at 8192 rows: rank
        # slabs align to it so tile_base is in those units
        tile_size = RNG_TILE
    ro, rd = generate_rays(camera, resolution, device=scene.device)
    n = ro.shape[0]
    per = rank_share(n, mesh.world_size, tile_size * overlap_chunks)
    lo = mesh.rank * per
    ro_l, rd_l = pad_share(ro, rd, lo, per)
    # padding rays render scene content against a zero target: weight 0
    w_l = (torch.arange(lo, lo + per, device=scene.device) < n).to(torch.float32)[:, None]
    tile_base = mesh.rank * (per // tile_size)
    rays_per_chunk = per // overlap_chunks
    tiles_per_chunk = rays_per_chunk // tile_size

    def step(params, target_flat, key):
        with annotate("ptap.train.step"):
            target_l = target_flat[lo:lo + per]
            if target_l.shape[0] < per:
                target_l = torch.cat([target_l, target_l.new_zeros(per - target_l.shape[0], 3)])
            names = list(params)
            loss, grads, pending = None, None, []

            def merge(wait):
                nonlocal loss, grads
                flat = wait()
                parts = torch.split(flat[1:], [params[k].numel() for k in names])
                g = {k: p.reshape(params[k].shape) for k, p in zip(names, parts)}
                loss = flat[0] if loss is None else loss + flat[0]
                grads = g if grads is None else {k: grads[k] + g[k] for k in names}

            for c in range(overlap_chunks):
                rows = slice(c * rays_per_chunk, (c + 1) * rays_per_chunk)
                loss_c, g_c = loss_and_grad(
                    params, scene, target_l[rows], key, camera, resolution, n_samples,
                    max_bounces, tile_size=tile_size, ro=ro_l[rows], rd=rd_l[rows],
                    tile_base=tile_base + c * tiles_per_chunk, reduce="sum", engine=engine,
                    weight=w_l[rows], parity=parity,
                )
                flat = torch.cat([loss_c.reshape(1)] + [g_c[k].reshape(-1) for k in names])
                pending.append(all_reduce_sum(flat, mesh, async_op=True))
                if len(pending) > 1:  # the previous chunk's reduce ran beside this backward
                    merge(pending.pop(0))
            merge(pending.pop(0))
            return loss, {k: params[k].detach() - lr * grads[k] for k in names}

    return step
