"""Data-parallel and triangle-sharded rendering and training over
``torch.distributed`` ranks (port of ``pathtracerap_tpu/parallel``):
:mod:`.sharding` (the ray- and sample-parallel renders), :mod:`.geometry`
(the geometry ring: each rank keeps 1/D of the traversal pack, the shards
rotate), :mod:`.distributed` (process-group set-up, communication model,
scaling report) and :mod:`.dryrun` (a multi-process dry run of the sharded
and ring train steps).  The data-parallel train step is
:func:`..diff.grad.make_sharded_train_step`."""

from .distributed import comm_model, init_distributed, scaling_report
from .geometry import (
    make_geometry_sharded_tracer,
    make_geometry_sharded_tracer_fused,
    make_geometry_sharded_train_step,
    make_ring_diff_tracer,
    render_image_geometry_sharded,
    ring_world_specs,
)
from .sharding import (
    Mesh,
    default_mesh,
    render_accumulate_dp,
    render_accumulate_sample_parallel,
    render_image_dp,
)

__all__ = [
    "Mesh",
    "comm_model",
    "default_mesh",
    "init_distributed",
    "make_geometry_sharded_tracer",
    "make_geometry_sharded_tracer_fused",
    "make_geometry_sharded_train_step",
    "make_ring_diff_tracer",
    "render_accumulate_dp",
    "render_accumulate_sample_parallel",
    "render_image_dp",
    "render_image_geometry_sharded",
    "ring_world_specs",
    "scaling_report",
]
