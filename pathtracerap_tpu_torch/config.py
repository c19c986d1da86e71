"""Runtime configuration (the port's copy of ``pathtracerap_tpu/config.py``).

Plain frozen dataclasses, serializable to and from dicts and JSON, that
fully describe a render.  ``tests/test_torch_host.py`` holds their fields
and defaults equal to the JAX package's.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple

from . import constants


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Pinhole camera shooting through an axis-aligned image-plane rectangle.

    The defaults are the reference camera: eye at (0, 0, 920) looking down
    -z through x in [-10, 10), y in [-4, 12) at z = 900
    (``Renderer.cpp:528-545``); rows are generated bottom-up.
    """

    position: Tuple[float, float, float] = (0.0, 0.0, 920.0)
    plane_x: Tuple[float, float] = (-10.0, 10.0)
    plane_y: Tuple[float, float] = (-4.0, 12.0)
    plane_z: float = 900.0
    # True: a sub-pixel jitter per sample (the quality camera); the
    # reference never jitters, so parity renders keep this False
    jitter: bool = False


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Full description of one render job."""

    resolution: Tuple[int, int] = (constants.RESOLUTION_X, constants.RESOLUTION_Y)
    samples_per_pixel: int = constants.ITER
    max_bounces: int = constants.MAX_BOUNCES
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)

    # traversal engine: all five of render/wavefront.py's ENGINES are ported;
    # "parity" is the grid DDA (kernel G1, kernels/dda.py)
    engine: str = "mxu"

    # True reproduces the reference's behavioural quirks (reflectRay,
    # utility.h:64-69); False enables the physically standard forms
    parity: bool = True

    grid_dims: Tuple[int, int, int] = (constants.GRID_X, constants.GRID_Y, constants.GRID_Z)
    cache_first_hit: bool = True
    accum_dtype: str = "float32"
    samples_per_chunk: int = 0
    seed: int = 0

    def to_dict(self) -> dict:
        # JSON-canonical (tuples -> lists) so round-trips compare equal
        return json.loads(json.dumps(dataclasses.asdict(self)))

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_dict(cls, d: dict) -> "RenderConfig":
        d = dict(d)
        cam = d.pop("camera", None)
        cfg = cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items()})
        if cam is not None:
            cam = {k: tuple(v) if isinstance(v, list) else v for k, v in cam.items()}
            cfg = dataclasses.replace(cfg, camera=CameraConfig(**cam))
        return cfg

    @classmethod
    def from_json(cls, s: str) -> "RenderConfig":
        return cls.from_dict(json.loads(s))

    @property
    def n_pixels(self) -> int:
        return self.resolution[0] * self.resolution[1]
