"""pathtracerap_tpu_torch — the path tracer on PyTorch and CUDA.

A port of :mod:`pathtracerap_tpu` (JAX/Pallas on a TPU) to PyTorch, with the
traversal kernels of the serving path written by hand in CUDA C++ for
Hopper (``csrc/``).  The JAX package stays the reference the port is held
against; this package never imports ``jax`` or ``flax``.  The host-side
modules it shares with the reference (``constants``, ``config``,
``io.obj``, ``io.bmp``, ``native``) are jax-free.

Slice 1 covers the binned forward render of the reference scene:
``Renderer(scene, RenderConfig(engine="fused"), device).render()``.
"""

__version__ = "0.1.0"

from pathtracerap_tpu import constants
from pathtracerap_tpu.config import CameraConfig, RenderConfig
from pathtracerap_tpu.io.bmp import read_bmp

from .render.wavefront import Renderer, effective_engine
from .scene.build import SceneBuilder, build_reference_scene
from .scene.types import Material, MaterialType, SceneDevice, SceneHost, WorldTriangles

__all__ = [
    "constants",
    "CameraConfig",
    "RenderConfig",
    "read_bmp",
    "Renderer",
    "effective_engine",
    "SceneBuilder",
    "build_reference_scene",
    "Material",
    "MaterialType",
    "SceneDevice",
    "SceneHost",
    "WorldTriangles",
    "__version__",
]
