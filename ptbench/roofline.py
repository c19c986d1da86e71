"""The yardstick of the roofline and peak-share metrics: the card's peaks
and the work an exact path tracer does on the benchmark's inputs.

The work is counted from the inputs, by the plain reference
(:func:`ptbench.reference.pathtrace.render` with ``count_every``), on the
very frames or steps the trace timed, never from the program's counters:

* **pairs**: a (ray, triangle) pair counts when the triangle's box meets
  the live ray's segment up to its nearest hit (:func:`count_pairs` of the
  reference): the tests an exact tracer cannot skip.  Every
  ``COUNT_EVERY``-th ray of a wavefront is counted and the count scaled
  by ``COUNT_EVERY``: the pair count is a mean over hundreds of thousands
  of rays, and the full count would take longer than the traced window.
* **flops**: ``FLOPS_PER_PAIR`` a pair (three six-term side products, 33;
  the four-term plane product, 7; the determinant, 2; its reciprocal, 1;
  t, u and v, 3; u + v, 1: the accept chain's arithmetic, compares not
  counted) and ``SHADE_FLOPS`` a live ray a shading step (the branchless
  shading computes every material's direction: normalize 9, hit and spawn
  points 12, two hemisphere samples 60 each, the Phong lobe 75, the mirror
  12, throughput and miss 6, counter 2; a transcendental counts one).
* **bytes**: each live ray's record read once and written once at the
  benchmark's sizes (``RAY_BYTES``: origin, direction, throughput and
  bounces left in float32), its uniforms read once (``UNIFORM_BYTES``),
  and the scene's triangles read once a launch (``TRI_BYTES``: three
  corners, a shading normal, a material type and colour).

A share is ``max(flops / PEAK_FLOPS, bytes / PEAK_BYTES) / seconds``, in
percent, against NVIDIA's data sheet for the H100 SXM at its 700 W limit;
the run prints the card's power limit beside it.
"""

from __future__ import annotations

PEAK_FLOPS = 67e12  # float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # HBM3
FLOPS_PER_PAIR = 47
SHADE_FLOPS = 250
COUNT_EVERY = 8
RAY_BYTES = 40
UNIFORM_BYTES = 16
TRI_BYTES = 64


def share(flops: float, nbytes: float, seconds: float) -> float:
    """Percent of the roofline: the least time the card could take over
    ``seconds``."""
    return 100.0 * max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES) / seconds


def total(counts_list) -> dict:
    """The per-unit counts of the reference summed over the units."""
    out = {"units": len(counts_list), "ray_samples": 0, "primary_pairs": 0}
    for c in counts_list:
        out["ray_samples"] += c["rays"] * c["samples"]
        out["primary_pairs"] += c["primary_pairs"]
        for k in ("live", "pairs"):
            out[k] = [a + b for a, b in zip(out.get(k, [0] * len(c[k])), c[k])]
    return out


def later_bounces(counts: dict):
    """(flops of their pairs, live ray-bounces) of bounces 1 and on, the
    bounces that the bounce kernels trace after the primary trace."""
    return sum(counts["pairs"][1:]) * FLOPS_PER_PAIR, sum(counts["live"][1:])
