"""Primary ray generation (port of ``pathtracerap_tpu/render/camera.py``).

``generateRaysKernel`` (``Renderer.cpp:521-555``): a pinhole eye shooting
through an axis-aligned image-plane rectangle, one ray per pixel, row 0 at
the bottom.  The reference never jitters; the quality camera's per-sample
jitter is applied by the fused engine itself
(:func:`..kernels.megakernel.render_samples_fused`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import CameraConfig
from ..ops.rng import uniform


def generate_rays(
    camera: CameraConfig,
    resolution: Tuple[int, int],
    key: Optional[torch.Tensor] = None,
    device=None,
):
    """Returns (orig (N, 3), dir (N, 3)); dir is unnormalized (pix - eye).
    N = W*H, index = y*W + x, y up.  With ``camera.jitter`` and a ``key``
    every pixel's image-plane point moves by ``uniform(key, (2, N))`` of a
    pixel, as JAX's ``generate_rays(camera, resolution, key)``; without a
    key the rays are the jitterless ones.  ``device`` defaults to the
    key's, and without a key to the card, as the port's other entry
    points do; the CPU is for callers that ask for it."""
    if device is None:
        device = key.device if key is not None else "cuda"
    w, h = resolution
    n = w * h
    iray = torch.arange(n, dtype=torch.int32, device=device)
    y = iray // w
    x = iray % w

    x0, x1 = camera.plane_x
    y0, y1 = camera.plane_y
    step_x = (x1 - x0) / w
    step_y = (y1 - y0) / h

    fx = x.to(torch.float32)
    fy = y.to(torch.float32)
    if camera.jitter and key is not None:
        jx, jy = uniform(key, 2, n)
        fx = fx + jx
        fy = fy + jy

    world_x = x0 + fx * step_x
    world_y = y0 + fy * step_y
    world_z = torch.full((n,), camera.plane_z, dtype=torch.float32, device=device)

    eye = torch.tensor(camera.position, dtype=torch.float32, device=device)
    pix = torch.stack([world_x, world_y, world_z], dim=-1)
    ro = eye.expand(n, 3)
    rd = pix - eye
    return ro, rd


def jitter_step(camera: CameraConfig, resolution: Tuple[int, int]):
    """The quality camera's (pixel step x, step y) on the image plane, or
    None for the jitterless camera (JAX ``render_accumulate``,
    ``render/wavefront.py:264-270``)."""
    if not camera.jitter:
        return None
    w, h = resolution
    return (
        (camera.plane_x[1] - camera.plane_x[0]) / w,
        (camera.plane_y[1] - camera.plane_y[0]) / h,
    )
