"""BSDF direction sampling (port of ``pathtracerap_tpu/ops/sampling.py``).

Identical math to the reference's scattering helpers given identical
uniform draws:

* :func:`cosine_hemisphere` — ``calculateRandomDirectionInHemisphere``
  (utility.h:91-123);
* :func:`metal_scatter` — ``calculateMetalScattering`` (utility.h:145-170),
  u[2] = phi draw, u[3] = r2 draw;
* :func:`coat_scatter` — ``calculateCoatScattering`` (utility.h:125-143);
* :func:`refract_scatter` — quality-mode Fresnel-roulette dielectric.

``norm`` selects the normalization: :func:`~.math.normalize` (v / |v|,
what the JAX package's XLA shading uses) or
:func:`~.math.normalize_rsqrt` (v * rsqrt(max(|v|^2, 1e-30)), what its
in-kernel shading uses).
"""

from __future__ import annotations

import torch

from .. import constants
from .math import cross3, dot3, normalize, reflect_parity, reflect_standard

_SQRT13 = constants.SQRT_OF_ONE_THIRD
_TWO_PI = constants.TWO_PI


def _axis(like: torch.Tensor, k: int) -> torch.Tensor:
    e = torch.zeros_like(like)
    e[..., k] = 1.0
    return e


def cosine_hemisphere(normal, u0, u1, norm=normalize):
    """Cosine-weighted hemisphere direction around ``normal`` (..., 3)."""
    up = torch.sqrt(torch.clamp(u0, min=0.0))  # cos(theta)
    over = torch.sqrt(torch.clamp(1.0 - up * up, min=0.0))  # sin(theta)
    around = u1 * _TWO_PI

    ax, ay = torch.abs(normal[..., 0]), torch.abs(normal[..., 1])
    # tangent seed: x if |nx| < sqrt(1/3), else y if |ny| < sqrt(1/3), else z
    seed = torch.where(
        (ax < _SQRT13)[..., None],
        _axis(normal, 0),
        torch.where((ay < _SQRT13)[..., None], _axis(normal, 1), _axis(normal, 2)),
    )
    t1 = norm(cross3(normal, seed))
    t2 = norm(cross3(normal, t1))
    return (
        up[..., None] * normal
        + (torch.cos(around) * over)[..., None] * t1
        + (torch.sin(around) * over)[..., None] * t2
    )


def metal_scatter(normal, ray_dir, u2, u3, norm=normalize):
    """Phong-lobe (exponent 30) perturbed mirror reflection."""
    phi = _TWO_PI * u2
    cos_theta = torch.pow(
        torch.clamp(1.0 - u3, min=0.0), 1.0 / (constants.METAL_PHONG_EXPONENT + 1.0)
    )
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))

    ndotd = dot3(normal, ray_dir)[..., None]
    w = norm(ray_dir - normal * (2.0 * ndotd))
    seed = torch.where((torch.abs(w[..., 0]) > 0.1)[..., None], _axis(w, 1), _axis(w, 0))
    u = norm(cross3(seed, w))
    v = cross3(w, u)
    return (
        u * (torch.cos(phi) * sin_theta)[..., None]
        + v * (torch.sin(phi) * sin_theta)[..., None]
        + w * cos_theta[..., None]
    )


def coat_scatter(normal, ray_dir, u0, u1, u2, parity: bool = True, norm=normalize):
    """50/50 roulette between (quirky in parity mode) mirror reflection and
    a diffuse bounce."""
    reflect = reflect_parity if parity else reflect_standard
    mirror = reflect(ray_dir, normal)
    diffuse = cosine_hemisphere(normal, u1, u2, norm=norm)
    take_mirror = (u0 < constants.COAT_REFLECT_PROBABILITY)[..., None]
    return torch.where(take_mirror, mirror, diffuse)


def refract_scatter(normal, ray_dir, ior, u, norm=normalize):
    """Fresnel-weighted dielectric scatter (quality mode).

    ``ior`` is (N, 1).  Returns ``(direction, orient)``: the spawn point is
    ``hit + SPAWN_OFFSET * orient * normal``."""
    entering = dot3(ray_dir, normal)[..., None] < 0.0
    n_eff = torch.where(entering, normal, -normal)
    cos_i = torch.clamp(-dot3(ray_dir, n_eff)[..., None], 0.0, 1.0)
    eta = torch.where(entering, 1.0 / ior, ior)
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    tir = k < 0.0
    cos_t = torch.sqrt(torch.clamp(k, min=0.0))
    refr = norm(eta * ray_dir + (eta * cos_i - cos_t) * n_eff)
    r0 = ((ior - 1.0) / (ior + 1.0)) ** 2
    # Schlick on the angle in the denser medium's vacuum side
    cos_x = torch.where(entering, cos_i, cos_t)
    fres = r0 + (1.0 - r0) * (1.0 - cos_x) ** 5
    take_refl = tir | (u[..., None] < fres)
    refl = reflect_standard(ray_dir, n_eff)
    direction = torch.where(take_refl, refl, refr)
    orient = torch.where(take_refl, 1.0, -1.0) * torch.where(entering, 1.0, -1.0)
    return direction, orient
