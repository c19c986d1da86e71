"""rng_launches_per_frame: launches (kernels, copies, sets) a frame made inside
the program's ``ptap.rng`` spans (``ops/rng.py`` ``chunk_uniforms``), counted as CUDA
runtime calls in the trace.  Layer: the RNG."""

from ptbench import spans


def read(ctx):
    return spans.launches_per_unit(ctx, "ptap.rng")
