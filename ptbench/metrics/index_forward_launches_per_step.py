"""index_forward_launches_per_step: launches (kernels, copies, sets) a train
step made inside the program's ``ptap.train.index_forward`` spans (``diff/fast.py``),
counted as CUDA runtime calls in the trace.  Layer: the train step."""

from ptbench import spans


def read(ctx):
    return spans.launches_per_unit(ctx, "ptap.train.index_forward")
