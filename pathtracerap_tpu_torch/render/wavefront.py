"""The render facade (port of ``pathtracerap_tpu/render/wavefront.py``).

``Renderer(scene, config, device).render(seed)`` bakes the world once, then
accumulates the samples through :func:`render_accumulate` on one engine:

* the megakernel engines (:mod:`..kernels.megakernel`): ``binned`` (primary
  hits through kernel 1, each later bounce through kernel 2) for scenes of
  two or more blocks, or ``fused`` (kernel 4, whole samples) for
  single-block scenes and the jittered quality camera;
* the per-bounce engines, which trace and then shade in torch once per
  bounce: ``pallas`` (:func:`..kernels.trace.trace_pallas`: kernel 1's
  worklists, or kernel 5's dense sweep on a world without a fused pack,
  where ``fused`` and ``binned`` route too) and ``mxu`` (the brute-force
  :func:`..ops.plucker.trace_mxu`).

JAX scans the per-bounce engines over tiles of ``tile_size`` rays, one
after the other.  The port traces the whole image's wavefront in one
launch a bounce and keeps only the tiles' RNG numbering, so every pixel
draws JAX's stream.  The parity DDA engine raises ``NotImplementedError``
naming its ROADMAP item.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import RenderConfig
from ..io.bmp import quantize_image, write_bmp
from ..kernels.megakernel import render_accumulate_binned, render_accumulate_fused
from ..kernels.trace import trace_pallas
from ..ops.plucker import bake_world_triangles, trace_mxu
from ..ops.rng import chunk_jitter_uniforms, chunk_uniforms, prng_key
from ..scene.types import SceneDevice
from .camera import generate_rays, jitter_step
from .shade import RayState, gather_contribution, shade

DEFAULT_TILE = 8192
ENGINES = ("fused", "binned", "pallas", "mxu")
_MISSING = {"parity": "the parity DDA engine (ROADMAP A10)"}


def effective_engine(engine: str, world, jitter: bool) -> str:
    """Resolve the megakernel engine choice against the baked world:
    no fused pack -> ``pallas``; ``binned`` with the jittered camera ->
    ``fused``; ``fused`` on a scene of two or more blocks -> ``binned``."""
    if engine not in ("fused", "binned"):
        return engine
    if world is None or world.fused_ops is None:
        return "pallas"
    if engine == "binned" and jitter:
        return "fused"
    if engine == "fused" and not jitter and world.block_aabb.shape[0] >= 2:
        return "binned"
    return engine


def _make_tracer(scene: SceneDevice, engine: str, world=None):
    """Tracers take (ro, rd, alive=None); ``pallas`` culls on the lanes'
    liveness, ``mxu`` ignores it."""
    if engine in ("mxu", "pallas"):
        if world is None:
            world = bake_world_triangles(scene)
        if engine == "pallas":
            return lambda ro, rd, alive=None: trace_pallas(world, ro, rd, alive=alive)
        return lambda ro, rd, alive=None: trace_mxu(world, ro, rd)
    if engine in _MISSING:
        raise NotImplementedError(f"engine {engine!r}: {_MISSING[engine]}")
    raise ValueError(f"unknown engine: {engine!r}")


def render_sample(
    tracer,
    ro: torch.Tensor,
    rd: torch.Tensor,
    key: torch.Tensor,
    sample_index: int,
    max_bounces: int,
    parity: bool = True,
    primary_hits=None,
    tile_size: int = DEFAULT_TILE,
    tile_base: int = 0,
) -> torch.Tensor:
    """Path-trace one sample iteration of a wavefront with ``tracer`` (see
    :func:`_make_tracer`); returns (n, 3).  Every bounce traces the whole
    wavefront in one call; the uniforms are drawn per ``tile_size``-ray RNG
    tile, tiles numbered from ``tile_base``, as JAX draws them tile by
    tile."""
    n = ro.shape[0]
    u = chunk_uniforms(key, sample_index, max_bounces, n, n, tile_base, rng_tile=tile_size)
    state = RayState.primary(ro, rd, max_bounces)
    for b in range(max_bounces):
        if b == 0 and primary_hits is not None:
            hits = primary_hits
        else:
            hits = tracer(state.orig, state.dir, alive=state.remaining > 0)
        # column block b holds depth max_bounces - b (Renderer.cpp:435)
        state = shade(state, hits, u[:, 4 * b:4 * b + 4], parity=parity)
    return gather_contribution(state)


def _render_tile(
    tracer,
    ro: torch.Tensor,
    rd: torch.Tensor,
    tile_base: int,
    key: torch.Tensor,
    n_samples: int,
    max_bounces: int,
    parity: bool,
    jitter_step=None,
    tile_size: int = DEFAULT_TILE,
) -> torch.Tensor:
    """All samples of a wavefront whose RNG tiles start at ``tile_base``;
    returns the (n, 3) contribution sums.  It does the work of JAX's
    ``render_ray_array`` and ``_render_tile`` together, on the whole
    wavefront at once.  Without ``jitter_step`` the primary hits are traced
    once and shared (the reference's first-intersection cache,
    ``Renderer.cpp:594-613``); with the quality camera's (step_x, step_y)
    each sample moves every image-plane point by a sub-pixel uniform
    offset and traces its own primaries."""
    n = ro.shape[0]
    primary = tracer(ro, rd) if jitter_step is None else None
    acc = torch.zeros((n, 3), dtype=torch.float32, device=ro.device)
    for s in range(n_samples):
        rd_s = rd
        if jitter_step is not None:
            ju = chunk_jitter_uniforms(key, s, n, n, tile_base, rng_tile=tile_size)
            rd_s = rd + torch.stack(
                [ju[:, 0] * jitter_step[0], ju[:, 1] * jitter_step[1], torch.zeros_like(ju[:, 0])],
                dim=-1,
            )
        acc = acc + render_sample(
            tracer, ro, rd_s, key, s, max_bounces, parity=parity, primary_hits=primary,
            tile_size=tile_size, tile_base=tile_base,
        )
    return acc


def render_accumulate(
    scene: SceneDevice,
    key: torch.Tensor,
    camera,
    resolution,
    n_samples: int,
    max_bounces: int,
    engine: str = "mxu",
    parity: bool = True,
    world=None,
    tile_size: int = DEFAULT_TILE,
) -> torch.Tensor:
    """Accumulate ``n_samples`` sample iterations on the scene's device;
    returns the (N, 3) contribution sums.  ``world`` is an optional
    pre-baked :class:`..scene.types.WorldTriangles`; ``tile_size`` is the
    per-bounce engines' RNG tile."""
    ro, rd = generate_rays(camera, resolution, device=scene.device)
    step = jitter_step(camera, resolution)
    if engine in ("fused", "binned"):
        if world is None:
            world = bake_world_triangles(scene)
        engine = effective_engine(engine, world, step is not None)
    if engine == "binned":
        return render_accumulate_binned(world, ro, rd, key, n_samples, max_bounces, parity=parity)
    if engine == "fused":
        return render_accumulate_fused(
            world, ro, rd, key, n_samples, max_bounces, parity=parity, jitter_step=step
        )
    tracer = _make_tracer(scene, engine, world=world)
    return _render_tile(tracer, ro, rd, 0, key, n_samples, max_bounces, parity,
                        jitter_step=step, tile_size=tile_size)


class Renderer:
    """High-level facade: bake once per scene, render on ``device``."""

    def __init__(self, scene: SceneDevice, config: RenderConfig, device=None):
        if device is not None:
            want = torch.device(device)
            if want.type != scene.device.type or want.index not in (None, scene.device.index):
                raise ValueError(f"scene is on {scene.device}, renderer asked for {want}")
        self.device = scene.device
        self.scene = scene
        self.config = config
        self.world = bake_world_triangles(scene) if config.engine in ENGINES else None
        self.engine = effective_engine(config.engine, self.world, config.camera.jitter)
        if self.engine not in ENGINES:
            raise NotImplementedError(
                f"engine {config.engine!r} routes to {self.engine!r}: "
                + _MISSING.get(self.engine, "not an engine of this package")
            )

    def render(self, seed: Optional[int] = None) -> torch.Tensor:
        """Full render; returns the (H, W, 3) float image (accumulated
        contributions / n_samples, pre-quantization) on the device."""
        cfg = self.config
        seed = cfg.seed if seed is None else seed
        w, h = cfg.resolution
        acc = render_accumulate(
            self.scene, prng_key(seed, device=self.device), cfg.camera, cfg.resolution,
            cfg.samples_per_pixel, cfg.max_bounces, engine=self.engine, parity=cfg.parity,
            world=self.world,
        )
        return acc.reshape(h, w, 3) / cfg.samples_per_pixel

    def render_to_bmp(self, path: str, seed: Optional[int] = None) -> torch.Tensor:
        image = self.render(seed=seed)
        accum = image.cpu().numpy() * np.float32(self.config.samples_per_pixel)
        write_bmp(path, quantize_image(accum, self.config.samples_per_pixel))
        return image
