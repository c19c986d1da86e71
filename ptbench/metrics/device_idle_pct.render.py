"""device_idle_pct.render: the share of the traced window in which no
operation ran on the device: 100 x (1 - union of the device intervals /
window), the window being the host span around the traced render units.
Layer: the device (H100)."""

from ptbench import devtrace


def read(ctx):
    if not ctx.trace.device:
        return None
    return 100.0 * devtrace.idle_share(ctx.trace)
