"""index_forward_ms_per_step: host milliseconds a train step inside the program's
``ptap.train.index_forward`` spans (``diff/fast.py``: the ``torch.no_grad()`` kernel
blocks that freeze each sample's hit topology: B1's primaries, then per sample group the
sort, the worklists, B3 and the deferred shading of every bounce).  Layer: the train step."""

from ptbench import spans


def read(ctx):
    return spans.ms_per_unit(ctx, "ptap.train.index_forward")
