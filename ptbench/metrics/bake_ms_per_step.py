"""bake_ms_per_step: host milliseconds a train step inside the program's
``ptap.bake`` span (``ops/plucker.py`` ``bake_world_triangles``, which the step runs
inside its loss).  Layer: the world bake."""

from ptbench import spans


def read(ctx):
    return spans.ms_per_unit(ctx, "ptap.bake")
