"""bounce_trace_roofline: kernel B3 (``csrc/bounce_trace.cu``,
``bounce_trace_kernel``), the train step's deferred trace of bounces 1 and
on, as a share of its roofline over the traced steps.

Work (:mod:`ptbench.roofline`, counted by the reference on the same steps'
paths, every ``COUNT_EVERY``-th ray scaled up): the pairs of bounces 1 and
on at ``FLOPS_PER_PAIR``; no shading (torch shades the deferred bounce);
bytes: each live ray's record in and its hit (t and index, 8 bytes) out,
and the triangles once a launch.  Time: B3's summed device time.
"""

from ptbench import devtrace, roofline

PATTERNS = ("bounce_trace_kernel",)
HIT_BYTES = 8


def work(counts, launches: int, n_tris: int):
    flops, live = roofline.later_bounces(counts)
    nbytes = live * (roofline.RAY_BYTES + HIT_BYTES) + launches * n_tris * roofline.TRI_BYTES
    return flops, nbytes


def read(ctx):
    seconds, launches = devtrace.kernel_time(ctx.trace, PATTERNS)
    if not launches or not ctx.counts:
        return None
    return roofline.share(*work(ctx.counts, launches, ctx.n_triangles), seconds)
