"""The program's own spans in a traced run: how long the host spent inside
each, and the launches it made there, a frame or a step.

The port names its layers with ``ptap.*`` spans
(``pathtracerap_tpu_torch/utils/profiling.py``), which it records only
while a profiler runs: in the traced window.  A span is a host event of the
same ``torch.profiler`` trace as the device operations, on their clock
(:mod:`ptbench.devtrace`).  A span absent from the trace (a program
without it) reads None.
"""

from __future__ import annotations

import bisect

from ptbench import devtrace

# CUDA runtime (cuda*) and low-level API (cu*) calls that start a device
# operation: kernels, copies and sets (what ``launches_per_*`` counts)
LAUNCHES = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset")


def intervals(trace: devtrace.Trace, name: str):
    """The union of the host spans called ``name``: disjoint sorted (start
    us, end us) intervals."""
    return devtrace.merged((s, e) for n, s, e in trace.host if n == name)


def ms_per_unit(ctx, name: str):
    """Milliseconds a unit inside the spans ``name`` (their union)."""
    spans = intervals(ctx.trace, name)
    if not spans:
        return None
    return sum(e - s for s, e in spans) / 1e3 / ctx.units


def launches_per_unit(ctx, name: str):
    """Runtime launch, copy and set calls a unit that lie inside the spans
    ``name``, on any thread (the backward launches from autograd's)."""
    spans = intervals(ctx.trace, name)
    if not spans:
        return None
    starts = [s for s, _ in spans]
    n = 0
    for op, s, e in ctx.trace.host:
        if op.startswith(LAUNCHES):
            i = bisect.bisect_right(starts, s) - 1
            if i >= 0 and e <= spans[i][1]:
                n += 1
    return n / ctx.units
