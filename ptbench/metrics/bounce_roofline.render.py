"""bounce_roofline.render: kernel B2 (``csrc/bounce.cu``, ``bounce_kernel``),
the binned render's trace and shading of bounces 1 and on over the sorted
wavefront's worklists, as a share of its roofline over the traced render
units.

Work (:mod:`ptbench.roofline`, counted by the reference on the same
frames, every ``COUNT_EVERY``-th ray scaled up): the pairs of bounces 1 and
on at ``FLOPS_PER_PAIR``, and ``SHADE_FLOPS`` for each live ray of those
bounces, which B2 shades in the kernel; bytes: each live ray's record in
and its hit (t and index, 8 bytes) out, as ``bounce_trace_roofline``
counts them, its uniforms in, and the triangles once a launch.  Time: B2's
summed device time.  The pattern matches B2 alone: ``bounce_trace_kernel``
(B3) does not contain it.
"""

from ptbench import devtrace, roofline

PATTERNS = ("bounce_kernel",)
HIT_BYTES = 8


def work(counts, launches: int, n_tris: int):
    pairs_flops, live = roofline.later_bounces(counts)
    flops = pairs_flops + live * roofline.SHADE_FLOPS
    nbytes = (live * (roofline.RAY_BYTES + HIT_BYTES + roofline.UNIFORM_BYTES)
              + launches * n_tris * roofline.TRI_BYTES)
    return flops, nbytes


def read(ctx):
    seconds, launches = devtrace.kernel_time(ctx.trace, PATTERNS)
    if not launches or not ctx.counts:
        return None
    return roofline.share(*work(ctx.counts, launches, ctx.n_triangles), seconds)
