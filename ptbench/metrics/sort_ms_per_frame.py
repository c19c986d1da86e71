"""sort_ms_per_frame: host milliseconds a frame inside the program's
``ptap.sort`` spans (``kernels/megakernel.py`` ``render_samples_binned``: the
binned engine's wavefront sort, keys, argsort and gather, once a bounce and
slab).  Layer: the facade and engines."""

from ptbench import spans


def read(ctx):
    return spans.ms_per_unit(ctx, "ptap.sort")
