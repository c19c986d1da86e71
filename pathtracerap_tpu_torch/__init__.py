"""pathtracerap_tpu_torch — the path tracer on PyTorch and CUDA.

A port of :mod:`pathtracerap_tpu` (JAX/Pallas on a TPU) to PyTorch, with the
traversal kernels written by hand in CUDA C++ for Hopper (``csrc/``).  The
JAX package stays the reference the port is held against; this package
imports neither ``jax`` nor anything of ``pathtracerap_tpu``, and keeps its
own copies of the host modules it needs (``constants``, ``config``,
``io.bmp``, ``io.obj``, ``io.ply``, ``oracle``).

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

``Renderer.render(seed, checkpoint_path=None, metrics=None)`` renders in
chunks that checkpoint and resume bit for bit; ``utils`` holds the
checkpoint, failure (with the collective ``liveness_probe``), metrics,
profiling and debug (``PTAP_DEBUG=1``) helpers; ``scripts`` the profiling
scripts with their kernels P1 to P4.

``python -m pathtracerap_tpu_torch.cli render | benchmark | invert | info |
visualize`` is the command line (:mod:`.cli`, JAX's flags plus
``--device``).  :mod:`.parallel` renders and trains data-parallel over the
ranks of a ``torch.distributed`` group (one process a card; ``gloo`` on the
CPU or where ranks share a card): ``render_image_dp``, the sample-parallel
render, ``diff.make_sharded_train_step``, ``init_distributed``,
``scaling_report`` and ``python -m pathtracerap_tpu_torch.parallel.dryrun``.
``io.ply`` reads PLY meshes (scene files take them), and ``oracle`` is the
scalar NumPy oracle the tests hold the engines to.
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
