"""Render diagnostics: the live-ray decay curve (port of
``pathtracerap_tpu/render/diagnostics.py``).

The reference's stream compaction makes the live-ray count an explicit
host-side number every bounce (``Renderer.cpp:629-634``); the masked
wavefront hides it inside liveness masks.  This module recomputes it on
demand, for the metrics stream.
"""

from __future__ import annotations

from typing import List

import torch

from ..config import RenderConfig
from ..ops.rng import tile_uniforms
from ..scene.types import SceneDevice
from .camera import generate_rays
from .shade import RayState, shade
from .wavefront import _make_tracer


def live_ray_curve(
    scene: SceneDevice,
    config: RenderConfig,
    key: torch.Tensor,
    sample_index: int = 0,
    max_rays: int = 65536,
) -> List[float]:
    """Fraction of rays still alive ENTERING each bounce of one sample.

    Index 0 is always 1.0 (primaries); index b is the fraction that still
    trace+shade at bounce b.  Uses at most ``max_rays`` rays, drawn as one
    RNG tile (tile 0), as JAX draws them.  The megakernel engines keep
    liveness inside their kernels; the per-bounce ``pallas`` engine has the
    same kill semantics and traces for them."""
    ro, rd = generate_rays(config.camera, config.resolution, device=scene.device)
    ro, rd = ro[:max_rays], rd[:max_rays]
    n = ro.shape[0]
    engine = "pallas" if config.engine in ("fused", "binned") else config.engine
    tracer = _make_tracer(scene, engine)
    state = RayState.primary(ro, rd, config.max_bounces)
    fracs = []
    for b in range(config.max_bounces):
        alive = state.remaining > 0
        fracs.append(alive.to(torch.float32).mean())
        hits = tracer(state.orig, state.dir, alive=alive)
        u = tile_uniforms(key, sample_index, config.max_bounces - b, 0, n)
        state = shade(state, hits, u, parity=config.parity)
    return [round(float(x), 4) for x in torch.stack(fracs).cpu()]
