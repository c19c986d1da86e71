"""Debug mode of the traversal kernels (port of ``pathtracerap_tpu/utils/debug.py``).

The fast kernels skip an explicit ``det == 0`` mask: IEEE inf/NaN from the
division fail every range compare, so parallel and padding triangles are
never accepted (``csrc/common.cuh``).  That holds for IEEE arithmetic and is
exactly what a compiler flag (``--use_fast_math``, an approximate
reciprocal) could silently break, on the card alone.

Debug mode guards it two ways:

* ``PTAP_DEBUG=1`` (or ``debug=True`` on the kernels' wrappers) switches
  kernels 1, 2 and 4 and their plain versions to the explicit-mask accept
  chain (``parallel = det == 0`` masking, a guarded reciprocal);
* :func:`checked_trace` runs one worklist trace and checks the invariants
  that reasoning guarantees -- hit distances finite-or-sentinel and
  ``>= -EPSILON``, indices in range, no padding triangle hit, agreement
  with the brute-force ``trace_mxu`` -- and raises
  :class:`TraceInvariantError` on a violation.  The checks are explicit
  tests, not ``assert``, so ``python -O`` keeps them.
"""

from __future__ import annotations

import os

import torch

from .. import constants

F_MAX = constants.FLOAT_MAX
EPS = constants.EPSILON


class TraceInvariantError(RuntimeError):
    """A traversal broke an invariant of the kernels' accept chain."""


def debug_enabled() -> bool:
    """True when PTAP_DEBUG=1: kernels use the explicit det==0/NaN masks."""
    return os.environ.get("PTAP_DEBUG", "0") == "1"


def resolve_debug(flag) -> bool:
    """Kernel-arg convention: ``None`` defers to the env var."""
    return debug_enabled() if flag is None else bool(flag)


def _require(ok: torch.Tensor, what: str) -> None:
    if not bool(ok):
        raise TraceInvariantError(what)


def degenerate_rays(world):
    """Five rays that stress the det == 0 and grazing paths of the accept
    chain, built on the first real triangle (as ``tests/test_debug_mode.py``
    builds them): in its plane, grazing an edge, from its surface, nearly
    parallel, and with a near-zero direction.  Returns (ro, rd) (5, 3) on
    the world's device."""
    i = int(torch.argmax((world.valid > 0).to(torch.int32)))
    a, d1, d2 = (x[i] for x in (world.v0, world.e1, world.e2))
    n = torch.linalg.cross(d1, d2)
    n = n / torch.linalg.norm(n)
    ro = torch.stack([a - 3.0 * d1, a + 0.5 * d1 + 10.0 * n, a + 0.25 * d1 + 0.25 * d2,
                      a - 2.0 * d1 + 1e-3 * n, a + 5.0 * n])
    rd = torch.stack([d1, -n, -n, d1 + 1e-7 * n, 1e-13 * n])
    return ro, rd


def checked_trace(world, ro, rd):
    """Run one traversal (``trace_pallas``) under the invariants above;
    raises :class:`TraceInvariantError` on a violation.  Returns the
    HitRecord.  The Renderer facade validates a slice of primary rays per
    render when ``PTAP_DEBUG=1``."""
    from ..kernels.trace import trace_pallas
    from ..ops.math import normalize
    from ..ops.plucker import trace_mxu

    rec, idx = trace_pallas(world, ro, normalize(rd), return_idx=True)
    hit = rec.t < F_MAX
    t_hit = torch.where(hit, rec.t, 0.0)
    _require(torch.isfinite(t_hit).all(), "kernel returned non-finite hit distance")
    _require((t_hit >= -EPS).all(),
             "kernel accepted a hit below the -EPSILON floor (Renderer.cpp:201)")
    n_tris = world.valid.shape[0]
    _require(((idx >= 0) & (idx < n_tris)).all(), "kernel hit index out of range")
    _require((torch.where(hit, world.valid[idx.long()], 1.0) > 0.0).all(),
             "kernel accepted a padding (invalid) triangle -- the IEEE "
             "inf/NaN-rejection reasoning no longer holds")
    # cross-engine agreement: trace_mxu always carries the explicit parallel
    # mask; per-ray distances must match to fp tolerance
    ref = trace_mxu(world, ro, rd)
    scale = torch.clamp(t_hit.max(), min=1.0)
    both = hit & (ref.t < F_MAX)
    _require((torch.where(both, (rec.t - ref.t).abs(), 0.0) <= 1e-4 * scale).all(),
             "kernel hit distances diverge from the explicitly-masked MXU engine")
    _require((hit == (ref.t < F_MAX)).all(),
             "kernel hit/miss classification diverges from the MXU engine")
    return rec
