"""pathtracerap_tpu_torch — the path tracer on PyTorch and CUDA.

A port of :mod:`pathtracerap_tpu` (JAX/Pallas on a TPU) to PyTorch, with the
traversal kernels written by hand in CUDA C++ for Hopper (``csrc/``).  The
JAX package stays the reference the port is held against; this package
imports neither ``jax`` nor anything of ``pathtracerap_tpu``, and keeps its
own copies of the host modules it needs (``constants``, ``config``,
``io.bmp``, ``io.obj``).

It covers, through ``Renderer(scene, config, device).render()``:

* the binned forward render of the reference scene (``engine="fused"``
  routed to ``binned``; kernels 1 and 2);
* the whole-sample fused engine (kernel 4): single-block scenes such as
  :func:`build_cornell_box_scene` (primaries through kernel 1), and the
  jittered quality camera, ``CameraConfig(jitter=True)``, on any scene;
* the per-bounce ``pallas`` engine (kernel 1's worklists, or kernel 5's
  dense sweep for worlds above the fused pack's budget, where ``fused``
  routes too) and ``mxu`` (the brute-force tracer);

and, through ``diff.make_train_step``, the differentiable train step: by
default the per-bounce ``pallas`` diff engine; with ``engine="fused"`` the
binned deferred-trace forward (kernels 1 and 3) on multi-block scenes,
kernel 4's ``emit_idx`` forward on single-block ones.  ``bench_suite``
holds the benchmark suite's scenes and configs.
"""

__version__ = "0.1.0"

from . import constants
from .config import CameraConfig, RenderConfig
from .io.bmp import read_bmp
from .diff import extract_params, image_loss, make_train_step, render_for_params
from .render.wavefront import Renderer, effective_engine
from .scene.build import SceneBuilder, build_cornell_box_scene, build_reference_scene
from .scene.types import Material, MaterialType, SceneDevice, SceneHost, WorldTriangles

__all__ = [
    "constants",
    "CameraConfig",
    "RenderConfig",
    "read_bmp",
    "Renderer",
    "effective_engine",
    "extract_params",
    "image_loss",
    "make_train_step",
    "render_for_params",
    "SceneBuilder",
    "build_cornell_box_scene",
    "build_reference_scene",
    "Material",
    "MaterialType",
    "SceneDevice",
    "SceneHost",
    "WorldTriangles",
    "__version__",
]
