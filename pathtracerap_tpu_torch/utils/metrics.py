"""Structured per-render metrics (port of ``pathtracerap_tpu/utils/metrics.py``).

Per-chunk timings, derived Mrays/s, the live-ray curve, JSON lines on a
stream, and rank-0 gating for multi-process runs: the rank is
``torch.distributed``'s, or 0 when no process group is initialised.  The
``device`` of a :class:`RenderMetrics` is the name of the card the render
ran on (``torch.cuda.get_device_name``), or ``"cpu"``.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from typing import List, Optional, TextIO

import torch


def process_rank() -> int:
    """This process's rank in the default ``torch.distributed`` group, or 0
    when there is none."""
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def device_name(device) -> str:
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


@dataclasses.dataclass
class RenderMetrics:
    resolution: tuple
    samples_per_pixel: int
    max_bounces: int
    engine: str
    wall_s: float
    samples_done: int
    mrays_per_s: float
    device: str
    chunks: List[dict] = dataclasses.field(default_factory=list)
    # fraction of rays alive entering each bounce; filled by Renderer.render
    # when a metrics logger is attached
    live_ray_curve: List[float] = dataclasses.field(default_factory=list)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


class MetricsLogger:
    """Collects chunk timings during a render; rank-0 only output.
    ``device`` is the render's device: ``Renderer.render`` sets it to its
    own, and it is the card until then."""

    def __init__(self, config, stream: Optional[TextIO] = None, enabled: bool = True):
        self.config = config
        self.stream = stream or sys.stderr
        self.enabled = enabled and process_rank() == 0
        self.device = "cuda"
        self.chunks: List[dict] = []
        self.live_ray_curve: List[float] = []
        self._t0 = time.perf_counter()

    def chunk_done(self, samples: int, wall_s: float) -> None:
        w, h = self.config.resolution
        rays = w * h * samples * self.config.max_bounces
        rec = {
            "samples": samples,
            "wall_s": round(wall_s, 4),
            "mrays_per_s": round(rays / wall_s / 1e6, 2),
        }
        self.chunks.append(rec)
        if self.enabled:
            print(f"[metrics] chunk {json.dumps(rec)}", file=self.stream, flush=True)

    def record_live_curve(self, curve) -> None:
        self.live_ray_curve = list(curve)
        if self.enabled:
            print(f"[metrics] live_ray_curve {json.dumps(self.live_ray_curve)}",
                  file=self.stream, flush=True)

    def finalize(self, samples_done: int) -> RenderMetrics:
        wall = time.perf_counter() - self._t0
        w, h = self.config.resolution
        rays = w * h * samples_done * self.config.max_bounces
        m = RenderMetrics(
            resolution=tuple(self.config.resolution),
            samples_per_pixel=self.config.samples_per_pixel,
            max_bounces=self.config.max_bounces,
            engine=self.config.engine,
            wall_s=round(wall, 4),
            samples_done=samples_done,
            mrays_per_s=round(rays / wall / 1e6, 2) if wall > 0 else 0.0,
            device=device_name(self.device),
            chunks=self.chunks,
            live_ray_curve=self.live_ray_curve,
        )
        if self.enabled:
            print(f"[metrics] render {m.to_json()}", file=self.stream, flush=True)
        return m
