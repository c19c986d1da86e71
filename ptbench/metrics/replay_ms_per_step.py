"""replay_ms_per_step: host milliseconds a train step inside the program's
``ptap.train.replay`` spans (``diff/fast.py``: the differentiable replay of each sample
at its frozen indices, which builds the autograd graph).  Layer: the train step."""

from ptbench import spans


def read(ctx):
    return spans.ms_per_unit(ctx, "ptap.train.replay")
