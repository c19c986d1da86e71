"""Vector/transform math shared by traversal and shading (port of
``pathtracerap_tpu/ops/math.py``).

Includes the reference's non-standard reflection formula behind
:func:`reflect_parity` (``utility.h:64-69`` computes ``n - 2 (i . n) n``).
Every function broadcasts over leading batch dimensions.  Sums of
products are written out as fused multiply-adds (``torch.addcmul``) in a
fixed order: that is how XLA's CPU backend contracts ``jnp.sum(a * b)``
and ``jnp.cross``, so on the CPU the port reproduces the JAX package's
bits (a one-ulp change in a baked vertex can flip the bake's Morton order).
"""

from __future__ import annotations

import torch


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    acc = torch.addcmul(a[..., 0] * b[..., 0], a[..., 1], b[..., 1])
    return torch.addcmul(acc, a[..., 2], b[..., 2])


def cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [
            torch.addcmul(-(az * by), ay, bz),
            torch.addcmul(-(ax * bz), az, bx),
            torch.addcmul(-(ay * bx), ax, by),
        ],
        dim=-1,
    )


def norm3(v: torch.Tensor) -> torch.Tensor:
    """Euclidean length over the last axis, keepdim."""
    return torch.sqrt(dot3(v, v))[..., None]


def normalize(v: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    n = norm3(v)
    if eps:
        n = torch.clamp(n, min=eps)
    return v / n


def normalize_rsqrt(v: torch.Tensor) -> torch.Tensor:
    """``v * rsqrt(max(|v|^2, 1e-30))``: the normalization of the JAX
    package's in-kernel math (``megakernel._norm3``), finite at v == 0."""
    return v * torch.rsqrt(torch.clamp(dot3(v, v), min=1e-30))[..., None]


def normalize_guarded(v: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    """Normalize possibly-zero vectors: zero rows return the +x axis."""
    ok = dot3(v, v)[..., None] > eps
    fallback = torch.zeros_like(v)
    fallback[..., 0] = 1.0
    v_safe = torch.where(ok, v, fallback)
    return v_safe / norm3(v_safe)


def inv3x3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form cofactor inverse of (..., 3, 3) matrices."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    ca = e * i - f * h
    cb = -(d * i - f * g)
    cc = d * h - e * g
    cd = -(b * i - c * h)
    ce = a * i - c * g
    cf = -(a * h - b * g)
    cg = b * f - c * e
    ch = -(a * f - c * d)
    ci = a * e - b * d
    det = a * ca + b * cb + c * cc
    inv = torch.stack(
        [
            torch.stack([ca, cd, cg], dim=-1),
            torch.stack([cb, ce, ch], dim=-1),
            torch.stack([cc, cf, ci], dim=-1),
        ],
        dim=-2,
    )
    return inv / det[..., None, None]


def reflect_parity(incident: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """The reference's quirky ``reflectRay``: ``n - 2 (i . n) n``."""
    d = dot3(incident, normal)[..., None]
    return normal - 2.0 * d * normal


def reflect_standard(incident: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """Physically standard mirror reflection ``i - 2 (i . n) n``."""
    d = dot3(incident, normal)[..., None]
    return incident - 2.0 * d * normal
