"""backward_ms_per_step: host milliseconds a train step inside the program's
``ptap.train.backward`` span (``diff/grad.py`` ``value_and_grad``'s
``torch.autograd.grad``).  Layer: the train step."""

from ptbench import spans


def read(ctx):
    return spans.ms_per_unit(ctx, "ptap.train.backward")
