"""Primary ray generation (port of ``pathtracerap_tpu/render/camera.py``).

``generateRaysKernel`` (``Renderer.cpp:521-555``): a pinhole eye shooting
through an axis-aligned image-plane rectangle, one ray per pixel, row 0 at
the bottom.  Only the jitterless parity camera is ported.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pathtracerap_tpu.config import CameraConfig


def generate_rays(camera: CameraConfig, resolution: Tuple[int, int], device=None):
    """Returns (orig (N, 3), dir (N, 3)); dir is unnormalized (pix - eye).
    N = W*H, index = y*W + x, y up."""
    if camera.jitter:
        raise NotImplementedError(
            "the jittered quality camera is not ported yet (ROADMAP A9)"
        )
    w, h = resolution
    n = w * h
    iray = torch.arange(n, dtype=torch.int32, device=device)
    y = iray // w
    x = iray % w

    x0, x1 = camera.plane_x
    y0, y1 = camera.plane_y
    step_x = (x1 - x0) / w
    step_y = (y1 - y0) / h

    world_x = x0 + x.to(torch.float32) * step_x
    world_y = y0 + y.to(torch.float32) * step_y
    world_z = torch.full((n,), camera.plane_z, dtype=torch.float32, device=device)

    eye = torch.tensor(camera.position, dtype=torch.float32, device=device)
    pix = torch.stack([world_x, world_y, world_z], dim=-1)
    ro = eye.expand(n, 3)
    rd = pix - eye
    return ro, rd
