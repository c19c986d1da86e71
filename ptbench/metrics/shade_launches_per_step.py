"""shade_launches_per_step: launches (kernels, copies, sets) a train step made
inside the program's ``ptap.shade`` spans (``kernels/megakernel.py``
``first_wavefront`` and ``defer_shade_apply``: each slab and sample group's bounce 0,
with its ``ptap.rng`` call, and its deferred bounces), counted as CUDA runtime calls
in the trace.  A shading step is one launch where a kernel shades it, some 250 where
torch's elementwise ops do.  Layer: the train step."""

from ptbench import spans


def read(ctx):
    return spans.launches_per_unit(ctx, "ptap.shade")
