"""Data-parallel rendering and training over ``torch.distributed`` ranks
(port of ``pathtracerap_tpu/parallel``): :mod:`.sharding` (the ray- and
sample-parallel renders), :mod:`.distributed` (process-group set-up,
communication model, scaling report) and :mod:`.dryrun` (a multi-process
sharded train step on the CPU).  The sharded train step is
:func:`..diff.grad.make_sharded_train_step`."""

from .distributed import comm_model, init_distributed, scaling_report
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
    "render_accumulate_dp",
    "render_accumulate_sample_parallel",
    "render_image_dp",
    "scaling_report",
]
