"""launches_per_step: device operations (kernels, copies, sets) started
per train step, counted in the trace over the traced steps.  Layer: the
train step (``diff/grad.py``, ``diff/fast.py``): the index forward, the
replay and its backward."""


def read(ctx):
    n = len(ctx.trace.device)
    return n / ctx.units if n else None
