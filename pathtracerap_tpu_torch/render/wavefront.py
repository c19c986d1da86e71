"""The render facade (port of ``pathtracerap_tpu/render/wavefront.py``).

``Renderer(scene, config, device).render(seed)`` bakes the world once, then
accumulates the samples through one of the megakernel engines
(:mod:`..kernels.megakernel`): ``binned`` (primary hits through kernel 1,
each later bounce through kernel 2) for scenes of two or more blocks, or
``fused`` (kernel 4, whole samples) for single-block scenes and the
jittered quality camera.  Engines the port does not have yet raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import RenderConfig
from ..io.bmp import quantize_image, write_bmp
from ..kernels.megakernel import render_accumulate_binned, render_accumulate_fused
from ..ops.plucker import bake_world_triangles
from ..ops.rng import prng_key
from ..scene.types import SceneDevice
from .camera import generate_rays, jitter_step

_MISSING = {
    "mxu": "the brute-force mxu engine as a render engine (ROADMAP A10)",
    "parity": "the parity DDA engine (ROADMAP A10)",
    "pallas": "the per-bounce dense pallas engine (ROADMAP A11, kernel B5)",
}


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
        self.world = (
            bake_world_triangles(scene) if config.engine in ("fused", "binned") else None
        )
        self.engine = effective_engine(config.engine, self.world, config.camera.jitter)
        if self.engine not in ("binned", "fused"):
            raise NotImplementedError(
                f"engine {config.engine!r} routes to {self.engine!r}: "
                + _MISSING.get(self.engine, "not an engine of this package")
            )

    def render(self, seed: Optional[int] = None) -> torch.Tensor:
        """Full render; returns the (H, W, 3) float image (accumulated
        contributions / n_samples, pre-quantization) on the device."""
        cfg = self.config
        seed = cfg.seed if seed is None else seed
        key = prng_key(seed, device=self.device)
        w, h = cfg.resolution
        ro, rd = generate_rays(cfg.camera, cfg.resolution, device=self.device)
        spp, bounces = cfg.samples_per_pixel, cfg.max_bounces
        if self.engine == "fused":
            acc = render_accumulate_fused(
                self.world, ro, rd, key, spp, bounces, parity=cfg.parity,
                jitter_step=jitter_step(cfg.camera, cfg.resolution),
            )
        else:
            acc = render_accumulate_binned(self.world, ro, rd, key, spp, bounces, parity=cfg.parity)
        return acc.reshape(h, w, 3) / spp

    def render_to_bmp(self, path: str, seed: Optional[int] = None) -> torch.Tensor:
        image = self.render(seed=seed)
        accum = image.cpu().numpy() * np.float32(self.config.samples_per_pixel)
        write_bmp(path, quantize_image(accum, self.config.samples_per_pixel))
        return image
