"""worklists_ms_per_frame: host milliseconds a frame inside the program's
``ptap.worklists`` spans (``kernels/megakernel.py`` ``bounce_lists``: the binned
engine's per-tile worklists of the sorted wavefront, once a bounce and slab).
Layer: the facade and engines."""

from ptbench import spans


def read(ctx):
    return spans.ms_per_unit(ctx, "ptap.worklists")
