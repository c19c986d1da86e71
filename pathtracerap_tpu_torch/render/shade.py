"""Branchless wavefront shading (port of ``pathtracerap_tpu/render/shade.py``).

``shadeRayKernel``'s material branch (``Renderer.cpp:411-479``) as a masked
select over the wavefront: every lane computes every scatter candidate and
``torch.where`` picks by material id; dead lanes stop changing state.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import constants
from ..ops.intersect import HitRecord
from ..ops.math import dot3, normalize, reflect_parity, reflect_standard
from ..ops.sampling import coat_scatter, cosine_hemisphere, metal_scatter, refract_scatter
from ..scene.types import MaterialType

F_MAX = constants.FLOAT_MAX


@dataclasses.dataclass
class RayState:
    """Wavefront ray state — SoA analog of ``Ray`` (``Primitive.h:158-178``)."""

    orig: torch.Tensor  # (N, 3)
    dir: torch.Tensor  # (N, 3)
    color: torch.Tensor  # (N, 3) path throughput
    remaining: torch.Tensor  # (N,) i32 remaining bounces

    @classmethod
    def primary(cls, ro, rd, max_bounces: int) -> "RayState":
        n = ro.shape[0]
        return cls(
            orig=ro,
            dir=rd,
            color=torch.ones((n, 3), dtype=torch.float32, device=ro.device),
            remaining=torch.full((n,), max_bounces, dtype=torch.int32, device=ro.device),
        )


def shade(
    state: RayState, hits: HitRecord, uniforms: torch.Tensor, parity: bool = True,
    norm=normalize,
) -> RayState:
    """One wavefront shading step.

    ``uniforms`` (N, 4) are pre-drawn for this (sample, depth).  Lanes with
    ``remaining <= 0`` are dead and left untouched.  ``norm`` is the
    normalization (see :mod:`..ops.sampling`); the binned bounce's plain
    version passes the in-kernel rsqrt form."""
    alive = state.remaining > 0
    hit = hits.t < F_MAX
    # miss lanes carry zero normals, and normalize(cross(0, seed)) is NaN:
    # substitute a unit normal there (every update below is masked by hit)
    unit_z = torch.zeros_like(hits.normal)
    unit_z[..., 2] = 1.0
    n = torch.where(hit[:, None], hits.normal, unit_z)
    u = uniforms

    d = norm(state.dir)
    pt = state.orig + d * hits.t[:, None]
    spawn = pt + constants.SPAWN_OFFSET * n

    mt = hits.mat_type
    is_diffuse = mt == int(MaterialType.DIFFUSE)
    is_metal = mt == int(MaterialType.METAL)
    is_coat = mt == int(MaterialType.COAT)
    is_emissive = mt == int(MaterialType.EMISSIVE)
    is_reflective = mt == int(MaterialType.REFLECTIVE)

    reflect = reflect_parity if parity else reflect_standard

    dir_diffuse = cosine_hemisphere(n, u[:, 0], u[:, 1], norm=norm)
    dir_metal = metal_scatter(n, d, u[:, 2], u[:, 3], norm=norm)
    dir_coat = coat_scatter(n, d, u[:, 0], u[:, 1], u[:, 2], parity=parity, norm=norm)
    dir_refl = reflect(d, n)

    scatters = is_diffuse | is_metal | is_coat | is_reflective
    new_dir = torch.where(
        is_diffuse[:, None],
        dir_diffuse,
        torch.where(
            is_metal[:, None], dir_metal, torch.where(is_coat[:, None], dir_coat, dir_refl)
        ),
    )

    if not parity:
        # quality mode shades SPECULAR (perfect mirror) and REFRACTIVE
        # (Fresnel-roulette dielectric), which the reference never branches on
        is_specular = mt == int(MaterialType.SPECULAR)
        is_refractive = mt == int(MaterialType.REFRACTIVE)
        ri = (
            hits.mat_ri[:, None]
            if hits.mat_ri is not None
            else torch.full_like(hits.t[:, None], 1.5)
        )
        dir_refr, orient = refract_scatter(n, d, ri, u[:, 3], norm=norm)
        scatters = scatters | is_specular | is_refractive
        new_dir = torch.where(
            is_refractive[:, None],
            dir_refr,
            torch.where(is_specular[:, None], dir_refl, new_dir),
        )
        # transmitted rays spawn below the surface
        spawn = torch.where(
            is_refractive[:, None], pt + constants.SPAWN_OFFSET * orient * n, spawn
        )
    # in parity mode SPECULAR / REFRACTIVE keep direction and origin and
    # just burn a bounce, exactly like the reference
    shaded = alive & hit
    upd_dir = shaded & scatters
    upd_col = shaded & (scatters | is_emissive)

    new_orig = torch.where(upd_dir[:, None], spawn, state.orig)
    new_direction = torch.where(upd_dir[:, None], new_dir, state.dir)
    mat_c = hits.mat_color
    if not parity:
        # the cosine throughput factor the reference commented out
        # (Renderer.cpp:438), against the geometric normal
        gn = hits.geom_normal if hits.geom_normal is not None else n
        gn = torch.where(hit[:, None], gn, unit_z)
        cosf = dot3(dir_diffuse, gn)[:, None]
        mat_c = mat_c * torch.where(is_diffuse[:, None], torch.clamp(cosf, min=0.0), 1.0)
    color = torch.where(upd_col[:, None], state.color * mat_c, state.color)

    # miss: 0.01 ambient attenuation + kill (Renderer.cpp:471-477)
    missed = alive & ~hit
    color = torch.where(missed[:, None], color * constants.MISS_ATTENUATION, color)

    # emissive kills without decrement, miss kills, others decrement
    kill = missed | (shaded & is_emissive)
    remaining = torch.where(
        kill,
        torch.zeros_like(state.remaining),
        torch.where(alive, state.remaining - 1, state.remaining),
    )
    return RayState(orig=new_orig, dir=new_direction, color=color, remaining=remaining)


def gather_contribution(state: RayState) -> torch.Tensor:
    """Per-iteration gamma-2 tone map: sqrt of final throughput
    (``gatherImageDataKernel``, ``Renderer.cpp:481-496``)."""
    return torch.sqrt(torch.clamp(state.color, min=0.0))
