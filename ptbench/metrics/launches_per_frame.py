"""launches_per_frame: device operations (kernels, copies, sets) started
per frame, counted in the trace over the traced frames.  Layer: the facade
and engines (``render/wavefront.py``, ``kernels/megakernel.py``), whose
host-side launches bound a frame where the device idles."""


def read(ctx):
    n = len(ctx.trace.device)
    return n / ctx.units if n else None
