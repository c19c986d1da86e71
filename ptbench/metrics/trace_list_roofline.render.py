"""trace_list_roofline.render: kernel B1 (``csrc/trace_list.cu``,
``trace_list_kernel``), the binned render's primary trace over its
block worklists (one launch a slab), as a share of its roofline over the
traced render units.

Work (:mod:`ptbench.roofline`, counted by the reference on the same
frames, every ``COUNT_EVERY``-th ray scaled up): the primary trace's pairs
at ``FLOPS_PER_PAIR``; no shading (the engine shades bounce 0 in torch);
bytes: each ray's record in and its hit (t and index, 8 bytes) out, and
the triangles once a launch.  The rays are ``ray_samples``, a frame's rays
at one sample a frame, the traffic of every cell this metric lists (the
primary trace runs once a frame).  Time: B1's summed device time.
"""

from ptbench import devtrace, roofline

PATTERNS = ("trace_list_kernel",)
HIT_BYTES = 8


def work(counts, launches: int, n_tris: int):
    flops = counts["primary_pairs"] * roofline.FLOPS_PER_PAIR
    nbytes = (counts["ray_samples"] * (roofline.RAY_BYTES + HIT_BYTES)
              + launches * n_tris * roofline.TRI_BYTES)
    return flops, nbytes


def read(ctx):
    seconds, launches = devtrace.kernel_time(ctx.trace, PATTERNS)
    if not launches or not ctx.counts:
        return None
    return roofline.share(*work(ctx.counts, launches, ctx.n_triangles), seconds)
