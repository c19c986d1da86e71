"""sample_fused_roofline.render: kernel B4 (``csrc/megakernel.cu``,
``sample_fused_kernel``) in the batched render form (8 samples a
launch), as a share of its roofline over
the traced render units.

B4 runs whole samples: it shades bounce 0 from the primary hits (traced
by kernel B1) and traces and shades every later bounce.  Work
(:mod:`ptbench.roofline`, counted by the reference on the same paths,
every ``COUNT_EVERY``-th ray scaled up): the pairs of bounces 1 and on at
``FLOPS_PER_PAIR``, and the shading of every live ray of every bounce at
``SHADE_FLOPS``; bytes: each ray's record in and out a sample, the
uniforms of each live ray-bounce in, the triangles once a launch.  Time:
B4's summed device time.
"""

from ptbench import devtrace, roofline

PATTERNS = ("sample_fused_kernel",)


def work(counts, launches: int, n_tris: int):
    pairs_flops, _ = roofline.later_bounces(counts)
    live = sum(counts["live"])
    flops = pairs_flops + live * roofline.SHADE_FLOPS
    nbytes = (counts["ray_samples"] * 2 * roofline.RAY_BYTES
              + live * roofline.UNIFORM_BYTES + launches * n_tris * roofline.TRI_BYTES)
    return flops, nbytes


def read(ctx):
    seconds, launches = devtrace.kernel_time(ctx.trace, PATTERNS)
    if not launches or not ctx.counts:
        return None
    return roofline.share(*work(ctx.counts, launches, ctx.n_triangles), seconds)
