"""Traversal visualizer (port of ``pathtracerap_tpu/render/debug_viz.py``).

The reference declares a debug visualizer (``Debug_Visualizer.h:11``,
``Renderer.h:36-43``) but ships none.  This module renders first-hit AOVs
(depth, world normal, material id, flat color, hit mask) and the parity
DDA's traversal heatmaps (voxel steps and triangle tests per ray) to BMPs,
through :func:`..kernels.dda.grid_trace`: kernel G1 on the card, its plain
version for a CPU scene.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from ..config import RenderConfig
from ..constants import FLOAT_MAX
from ..io.bmp import write_bmp
from ..kernels.dda import grid_trace
from ..scene.types import SceneDevice
from .camera import generate_rays


def render_aovs(scene: SceneDevice, config: RenderConfig) -> Dict[str, np.ndarray]:
    """(H, W, ...) float arrays of first-hit AOVs and traversal statistics,
    traced on the scene's device."""
    w, h = config.resolution
    ro, rd = generate_rays(config.camera, config.resolution, device=scene.device)
    hits, stats = grid_trace(scene, ro.contiguous(), rd, return_stats=True)
    t = hits.t.cpu().numpy().reshape(h, w)
    hit = t < FLOAT_MAX
    return {
        "depth": np.where(hit, t, np.nan),
        "normal": hits.normal.cpu().numpy().reshape(h, w, 3),
        "mat_type": hits.mat_type.cpu().numpy().reshape(h, w),
        "albedo": hits.mat_color.cpu().numpy().reshape(h, w, 3),
        "hit": hit,
        "dda_steps": stats["steps"].cpu().numpy().reshape(h, w),
        "tri_tests": stats["tri_tests"].cpu().numpy().reshape(h, w),
    }


def _to_u8(x: np.ndarray) -> np.ndarray:
    return (np.clip(x, 0.0, 1.0) * 255.0).astype(np.uint8)


def _colorize_scalar(x: np.ndarray) -> np.ndarray:
    """Normalized grayscale (NaN -> 0) replicated to 3 channels."""
    v = np.nan_to_num(x, nan=0.0).astype(np.float64)
    lo, hi = v.min(), v.max()
    g = (v - lo) / (hi - lo) if hi > lo else np.zeros_like(v)
    return np.repeat(_to_u8(g)[..., None], 3, axis=2)


def write_aov_bmps(scene: SceneDevice, config: RenderConfig, out_dir: str) -> Dict[str, str]:
    """Render all AOVs and write one BMP each; returns {name: path}."""
    os.makedirs(out_dir, exist_ok=True)
    aovs = render_aovs(scene, config)
    images = {
        "depth": _colorize_scalar(aovs["depth"]),
        "normal": _to_u8(np.asarray(aovs["normal"]) * 0.5 + 0.5),
        "mat_type": _colorize_scalar(aovs["mat_type"].astype(np.float32)),
        "albedo": _to_u8(aovs["albedo"]),
        "hit": _colorize_scalar(aovs["hit"].astype(np.float32)),
        "dda_steps": _colorize_scalar(aovs["dda_steps"].astype(np.float32)),
        "tri_tests": _colorize_scalar(aovs["tri_tests"].astype(np.float32)),
    }
    paths = {}
    for name, img in images.items():
        paths[name] = os.path.join(out_dir, f"{name}.bmp")
        write_bmp(paths[name], img)
    return paths
