"""rng_ms_per_frame: host milliseconds a frame inside the program's ``ptap.rng`` spans
(``ops/rng.py`` ``chunk_uniforms``: the uniform stream of 8 samples a call, as
threefry int64 torch ops).  Layer: the RNG."""

from ptbench import spans


def read(ctx):
    return spans.ms_per_unit(ctx, "ptap.rng")
