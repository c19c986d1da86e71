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
  where ``fused`` and ``binned`` route too), ``mxu`` (the brute-force
  :func:`..ops.plucker.trace_mxu`) and ``parity``, the reference's
  uniform-grid DDA (:func:`..kernels.dda.grid_trace`, kernel G1 on the
  card), which needs no world bake.

JAX scans the per-bounce engines over tiles of ``tile_size`` rays, one
after the other.  The port traces the whole image's wavefront in one
launch a bounce and keeps only the tiles' RNG numbering, so every pixel
draws JAX's stream.

``Renderer.render`` renders in chunks of ``samples_per_chunk`` samples
(``render_accumulate``'s ``sample_offset`` and ``init_accum``), saves a
checkpoint after each chunk and resumes from one bit for bit, reports to a
:class:`..utils.metrics.MetricsLogger`, and under ``PTAP_DEBUG=1`` checks
the kernels' invariants on a slice of primary rays first
(:func:`..utils.debug.checked_trace`).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..config import RenderConfig
from ..io.bmp import quantize_image, write_bmp
from ..kernels.dda import grid_trace
from ..kernels.megakernel import render_accumulate_binned, render_accumulate_fused
from ..kernels.trace import trace_pallas
from ..ops.plucker import bake_world_triangles, trace_mxu
from ..ops.rng import chunk_jitter_uniforms, chunk_uniforms, prng_key
from ..scene.types import SceneDevice
from ..utils.checkpoint import RenderCheckpoint, load_checkpoint, save_checkpoint
from ..utils.debug import checked_trace, debug_enabled
from ..utils.profiling import annotate
from .camera import generate_rays, jitter_step
from .shade import RayState, gather_contribution, shade

DEFAULT_TILE = 8192
ENGINES = ("fused", "binned", "pallas", "mxu", "parity")


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
    liveness and ``parity`` traces only the live rays (dead ones get the
    miss record, which shading leaves unread); ``mxu`` ignores it."""
    if engine == "parity":
        return lambda ro, rd, alive=None: grid_trace(scene, ro.contiguous(), rd.contiguous(),
                                                     alive=alive)
    if engine in ("mxu", "pallas"):
        if world is None:
            world = bake_world_triangles(scene)
        if engine == "pallas":
            return lambda ro, rd, alive=None: trace_pallas(world, ro, rd, alive=alive)
        return lambda ro, rd, alive=None: trace_mxu(world, ro, rd)
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
    with annotate("rng"):
        u = chunk_uniforms(key, sample_index, max_bounces, n, n, tile_base, rng_tile=tile_size)
    state = RayState.primary(ro, rd, max_bounces)
    for b in range(max_bounces):
        with annotate("trace" if b else "trace_primary"):
            if b == 0 and primary_hits is not None:
                hits = primary_hits
            else:
                hits = tracer(state.orig, state.dir, alive=state.remaining > 0)
        with annotate("shade"):
            # column block b holds depth max_bounces - b (Renderer.cpp:435)
            state = shade(state, hits, u[:, 4 * b:4 * b + 4], parity=parity)
    with annotate("accumulate"):
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
    sample_offset: int = 0,
) -> torch.Tensor:
    """Samples ``sample_offset .. sample_offset + n_samples`` of a
    wavefront whose RNG tiles start at ``tile_base``; returns the (n, 3)
    contribution sums.  It does the work of JAX's
    ``render_ray_array`` and ``_render_tile`` together, on the whole
    wavefront at once.  Without ``jitter_step`` the primary hits are traced
    once and shared (the reference's first-intersection cache,
    ``Renderer.cpp:594-613``); with the quality camera's (step_x, step_y)
    each sample moves every image-plane point by a sub-pixel uniform
    offset and traces its own primaries."""
    n = ro.shape[0]
    primary = tracer(ro, rd) if jitter_step is None else None
    acc = torch.zeros((n, 3), dtype=torch.float32, device=ro.device)
    for s in range(sample_offset, sample_offset + n_samples):
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
    sample_offset: int = 0,
    init_accum: Optional[torch.Tensor] = None,
    world=None,
    tile_size: int = DEFAULT_TILE,
) -> torch.Tensor:
    """Accumulate samples ``sample_offset .. sample_offset + n_samples`` on
    the scene's device; returns the (N, 3) contribution sums, plus
    ``init_accum`` when given (added after the chunk's sum, as JAX adds
    it, for checkpoint/resume chunking).  ``world`` is an optional
    pre-baked :class:`..scene.types.WorldTriangles`; ``tile_size`` is the
    per-bounce engines' RNG tile."""
    ro, rd = generate_rays(camera, resolution, device=scene.device)
    step = jitter_step(camera, resolution)
    if engine in ("fused", "binned"):
        if world is None:
            world = bake_world_triangles(scene)
        engine = effective_engine(engine, world, step is not None)
    if engine == "binned":
        acc = render_accumulate_binned(world, ro, rd, key, n_samples, max_bounces,
                                       sample_offset=sample_offset, parity=parity)
    elif engine == "fused":
        acc = render_accumulate_fused(world, ro, rd, key, n_samples, max_bounces,
                                      sample_offset=sample_offset, parity=parity,
                                      jitter_step=step)
    else:
        tracer = _make_tracer(scene, engine, world=world)
        acc = _render_tile(tracer, ro, rd, 0, key, n_samples, max_bounces, parity,
                           jitter_step=step, tile_size=tile_size, sample_offset=sample_offset)
    return acc if init_accum is None else acc + init_accum


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
        if config.engine not in ENGINES:
            raise ValueError(f"unknown engine: {config.engine!r}")
        # the parity DDA traces the scene's grids: no world bake
        self.world = bake_world_triangles(scene) if config.engine != "parity" else None
        self.engine = effective_engine(config.engine, self.world, config.camera.jitter)

    def render(
        self,
        seed: Optional[int] = None,
        checkpoint_path: Optional[str] = None,
        metrics=None,
    ) -> torch.Tensor:
        """Full render; returns the (H, W, 3) float image (accumulated
        contributions / n_samples, pre-quantization) on the device.

        The samples go in chunks of ``samples_per_chunk`` (all at once when
        0).  With ``checkpoint_path`` the accumulation is saved after every
        chunk (atomic writes) and a render with the same config and seed
        resumes from it; the stateless per-(sample, ray, depth) RNG makes
        the resumed image equal to an unbroken chunked render bit for bit.
        A checkpoint of another config or seed is refused (``ValueError``).
        ``metrics`` (a :class:`..utils.metrics.MetricsLogger`) receives the
        live-ray curve of a fresh render and each chunk's wall time."""
        cfg = self.config
        seed = cfg.seed if seed is None else seed
        key = prng_key(seed, device=self.device)
        w, h = cfg.resolution

        if debug_enabled() and self.world is not None and self.world.fused_ops is not None:
            # PTAP_DEBUG=1: check the kernel invariants on a slice of
            # primary rays before committing to the full render
            ro_d, rd_d = generate_rays(cfg.camera, cfg.resolution, device=self.device)
            checked_trace(self.world, ro_d[:8192], rd_d[:8192])
        chunk = cfg.samples_per_chunk or cfg.samples_per_pixel
        accum = None
        done = 0

        if checkpoint_path:
            ck = load_checkpoint(checkpoint_path)
            if ck is not None:
                if ck.config != cfg.to_dict() or ck.seed != seed:
                    raise ValueError(
                        f"checkpoint {checkpoint_path} was written by a "
                        "different render config/seed; refusing to resume"
                    )
                accum = torch.as_tensor(ck.accum, device=self.device)
                done = ck.samples_done

        if metrics is not None:
            metrics.device = self.device
        if metrics is not None and getattr(metrics, "enabled", True) and done == 0:
            from .diagnostics import live_ray_curve

            metrics.record_live_curve(live_ray_curve(self.scene, cfg, key))

        while done < cfg.samples_per_pixel:
            step = min(chunk, cfg.samples_per_pixel - done)
            t0 = time.perf_counter()
            accum = render_accumulate(
                self.scene, key, cfg.camera, cfg.resolution, step, cfg.max_bounces,
                engine=self.engine, parity=cfg.parity, sample_offset=done, init_accum=accum,
                world=self.world,
            )
            done += step
            if checkpoint_path or metrics:
                accum_host = accum.cpu().numpy()  # also syncs for timing
                if metrics:
                    metrics.chunk_done(step, time.perf_counter() - t0)
                if checkpoint_path:
                    save_checkpoint(
                        checkpoint_path,
                        RenderCheckpoint(accum=accum_host, samples_done=done, seed=seed,
                                         config=cfg.to_dict()),
                    )
        return accum.reshape(h, w, 3) / cfg.samples_per_pixel

    def render_to_bmp(self, path: str, seed: Optional[int] = None) -> torch.Tensor:
        image = self.render(seed=seed)
        accum = image.cpu().numpy() * np.float32(self.config.samples_per_pixel)
        write_bmp(path, quantize_image(accum, self.config.samples_per_pixel))
        return image
