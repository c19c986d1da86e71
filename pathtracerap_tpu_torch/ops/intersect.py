"""Hit records (port of the ``HitRecord`` of ``pathtracerap_tpu/ops/intersect.py``).

The parity DDA engine of that module is not ported yet (ROADMAP A10).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import constants

F_MAX = constants.FLOAT_MAX


@dataclasses.dataclass
class HitRecord:
    """Wavefront hit data — the SoA analog of ``IntersectionData``
    (``Primitive.h:150-156``)."""

    t: torch.Tensor  # (N,) world-space impact distance; FLOAT_MAX = miss
    normal: torch.Tensor  # (N, 3) world-space shading normal
    mat_type: torch.Tensor  # (N,) i32
    mat_color: torch.Tensor  # (N, 3)
    # unit geometric normal; read only by quality-mode shading
    geom_normal: Optional[torch.Tensor] = None
    # material index of refraction; read only by quality-mode REFRACTIVE
    mat_ri: Optional[torch.Tensor] = None

    @property
    def hit(self) -> torch.Tensor:
        return self.t < F_MAX

    @classmethod
    def miss(cls, n: int, device="cuda") -> "HitRecord":
        """``n`` misses (t = FLOAT_MAX, zero attributes) on ``device``: the
        card unless the caller asks for another (``"cpu"``)."""
        return cls(
            t=torch.full((n,), F_MAX, dtype=torch.float32, device=device),
            normal=torch.zeros((n, 3), dtype=torch.float32, device=device),
            mat_type=torch.zeros((n,), dtype=torch.int32, device=device),
            mat_color=torch.zeros((n, 3), dtype=torch.float32, device=device),
        )
