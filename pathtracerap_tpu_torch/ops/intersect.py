"""Hit records and the parity DDA engine (port of
``pathtracerap_tpu/ops/intersect.py``).

:func:`trace_parity` is the reference's per-ray traversal
(``computeRaySceneIntersectionKernel``, ``Renderer.cpp:363-409``) written
for a whole wavefront in PyTorch: the plain version of kernel G1
(``csrc/grid_dda.cu``, :mod:`..kernels.dda`), which the renderer launches
for CUDA scenes.  It keeps every quirk of the reference that the JAX
package keeps:

* the slab test with the FLOAT_MIN/FLOAT_MAX sentinels for zero direction
  components, accepting ``tmin < 0`` (``Renderer.cpp:150-170``);
* the entry point rejected below ``min - EPSILON`` on any axis, and the
  entry voxel ``trunc(abs(entry - min + EPSILON) / width)``
  (``Renderer.cpp:256-270``);
* Amanatides-Woo stepping with the strict axis choice
  (``Renderer.cpp:331-357``) and the early exit once the march is more
  than 2 voxels past the last voxel with a hit (``Renderer.cpp:326-329``),
  which can return a hit that is not the nearest;
* Moeller-Trumbore with the EPSILON-guarded comparisons and the averaged
  vertex normal (``Renderer.cpp:174-215``); within a voxel the first
  closest accepted triangle in bucket order wins, a NaN t counting as the
  smallest (``argmin``'s rule);
* each model's hit in model space, converted to a world distance and
  merged in model order on a strictly smaller distance
  (``Renderer.cpp:377-399``).

Every 3-vector sum is an explicit chain (``ops/math.py``'s ``dot3``,
``cross3``; the transforms below), so that the kernel mirrors it
operation by operation.  The march runs a fixed gx + gy + gz iterations a
model, every update masked by the lane's ``active`` flag (no lane is
active longer), and stops early only when a check every
``_CHECK_EVERY`` iterations finds no active lane.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import constants
from .math import cross3, dot3, inv3x3

F_MAX = constants.FLOAT_MAX
F_MIN = constants.FLOAT_MIN
EPS = constants.EPSILON
_CHECK_EVERY = 8  # march iterations between two host checks for a live lane


@dataclasses.dataclass
class HitRecord:
    """Wavefront hit data — the SoA analog of ``IntersectionData``
    (``Primitive.h:150-156``)."""

    t: torch.Tensor  # (N,) world-space impact distance; FLOAT_MAX = miss
    normal: torch.Tensor  # (N, 3) world-space shading normal
    mat_type: torch.Tensor  # (N,) i32
    mat_color: torch.Tensor  # (N, 3)
    # unit geometric normal; read only by quality-mode shading
    geom_normal: Optional[torch.Tensor] = None
    # material index of refraction; read only by quality-mode REFRACTIVE
    mat_ri: Optional[torch.Tensor] = None
    # the parity engine's winner: (N,) i32 model index and (N,) i32 global
    # triangle index (into tri_vidx), -1 on a miss or a dead ray; what the
    # differentiable parity engine gathers its attributes from
    model: Optional[torch.Tensor] = None
    tri: Optional[torch.Tensor] = None

    @property
    def hit(self) -> torch.Tensor:
        return self.t < F_MAX

    @classmethod
    def miss(cls, n: int, device="cuda") -> "HitRecord":
        """``n`` misses (t = FLOAT_MAX, zero attributes) on ``device``: the
        card unless the caller asks for another (``"cpu"``)."""
        return cls(
            t=torch.full((n,), F_MAX, dtype=torch.float32, device=device),
            normal=torch.zeros((n, 3), dtype=torch.float32, device=device),
            mat_type=torch.zeros((n,), dtype=torch.int32, device=device),
            mat_color=torch.zeros((n, 3), dtype=torch.float32, device=device),
        )


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root (taken in f64; PyTorch's CPU
    f32 sqrt is off by an ulp on about 0.7 % of inputs, XLA's and CUDA's
    ``sqrtf`` are not)."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def normalize(v: torch.Tensor) -> torch.Tensor:
    """``v / |v|`` with :func:`sqrt_rn`."""
    return v / sqrt_rn(dot3(v, v))[..., None]


def mat3_apply(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``m[:3, :3] @ v`` for (N, 3) rows v: products accumulated by fused
    multiply-adds in column order, as XLA's CPU dot does."""
    acc = v[:, 0:1] * m[:3, 0]
    acc = torch.addcmul(acc, v[:, 1:2], m[:3, 1])
    return torch.addcmul(acc, v[:, 2:3], m[:3, 2])


def transform_position(p: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``vec3(M @ vec4(p, 1))`` (``utility.h:77-80``)."""
    return mat3_apply(m, p) + m[:3, 3]


def normal_matrix(m2w: torch.Tensor) -> torch.Tensor:
    """(I, 3, 3) inverse-transposes of the models' upper-left 3x3
    (``utility.h:82-88``): a world normal is ``mat3_apply(nm, n)``."""
    return inv3x3(m2w[:, :3, :3]).transpose(1, 2)


def slab_test(ro, rd, inv_dir, bb_min, bb_max):
    """AABB slab test (``Renderer.cpp:150-170``): (hit (N,), tmin (N,)).
    Zero direction components take the FLOAT_MIN/FLOAT_MAX sentinels; the
    min and max propagate NaN."""
    zero = rd == 0.0
    t_lo = torch.where(zero, F_MIN, (bb_min - ro) * inv_dir)
    t_hi = torch.where(zero, F_MAX, (bb_max - ro) * inv_dir)
    near = torch.minimum(t_lo, t_hi)
    far = torch.maximum(t_lo, t_hi)
    tmin = torch.maximum(torch.maximum(near[..., 0], near[..., 1]), near[..., 2])
    tmax = torch.minimum(torch.minimum(far[..., 0], far[..., 1]), far[..., 2])
    return ~((tmax < 0.0) | (tmin > tmax)), tmin


def moller_trumbore(ro, rd, v0, v1, v2, eps: float = EPS):
    """Moeller-Trumbore with the reference's epsilon rules
    (``Renderer.cpp:174-215``); inputs broadcast.  Returns (accept, t):
    ``accept`` where the reference's function returns true (det == 0 gives
    an infinite or NaN u, v, t that fail the range tests)."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = cross3(rd, e2)
    det = dot3(e1, pvec)
    inv_det = 1.0 / det
    tvec = ro - v0
    u = dot3(tvec, pvec) * inv_det
    qvec = cross3(tvec, e1)
    v = dot3(rd, qvec) * inv_det
    t = dot3(e2, qvec) * inv_det
    accept = (
        (torch.abs(det) >= eps)
        & ~(u < -eps)
        & ~(u > 1.0 + eps)
        & ~(v < -eps)
        & ~(u + v > 1.0 + eps)
        & ~(t < -eps)
    )
    return accept, t


def averaged_normal(vertex_nrm: torch.Tensor, vidx: torch.Tensor) -> torch.Tensor:
    """The averaged (not barycentric) vertex normal (``Renderer.cpp:203``)
    of the triangles whose vertex indices are the (..., 3) ``vidx``."""
    nrm = vertex_nrm
    return normalize((nrm[vidx[..., 0]] + nrm[vidx[..., 1]] + nrm[vidx[..., 2]]) * (1.0 / 3.0))


def _dda_one_model(scene, imodel: int, ro_w, rd_w, alive=None):
    """One model's grid march for the whole wavefront, as
    ``computeRayGridIntersection`` (``Renderer.cpp:238-360``): returns
    (is_intersect, t_model, tri_model, normal_model, ro_model, rd_model,
    steps, tri_tests); ``tri_model`` is the global index of the triangle
    that set ``t_model`` (-1 where none).  Rays outside ``alive`` do not
    march."""
    n = ro_w.shape[0]
    dev = ro_w.device
    gx, gy, gz = scene.grid_dims
    dims = torch.tensor([gx, gy, gz], dtype=torch.int32, device=dev)

    w2m = scene.world_to_model[imodel]
    mesh = int(scene.model_mesh[imodel])
    grid = int(scene.model_grid[imodel])
    bb_min = scene.mesh_bbox_min[mesh]
    bb_max = scene.mesh_bbox_max[mesh]
    vw = scene.grid_voxel_width[grid]
    voxel_base = int(scene.grid_voxel_start[grid])

    # world -> model; the direction normalized in model space (Renderer.cpp:381-383)
    ro = transform_position(ro_w, w2m)
    v = mat3_apply(w2m, rd_w)
    length = sqrt_rn(dot3(v, v))[:, None]
    rd = v / length
    # 1 / rd taken as |v| / v: how XLA simplifies 1 / (v / |v|)
    inv_dir = length / v

    box_ok, t_box = slab_test(ro, rd, inv_dir, bb_min, bb_max)
    entry = torch.addcmul(ro, rd, t_box[:, None])
    entry_ok = ((entry - bb_min) >= -EPS).all(dim=-1)
    ivox = (torch.abs(entry - bb_min + EPS) / vw).to(torch.int32)
    ivox = torch.minimum(torch.clamp(ivox, min=0), dims - 1)

    pos_dir = rd > 0.0
    step = torch.where(pos_dir, 1, -1).to(torch.int32)
    out = torch.where(pos_dir, dims, -1).to(torch.int32)
    pos_next = torch.addcmul(bb_min, torch.where(pos_dir, ivox + 1, ivox).to(torch.float32), vw)
    nonzero = rd != 0.0
    delta = torch.where(nonzero, torch.abs(vw * inv_dir), F_MAX)
    tmax = torch.where(nonzero, (pos_next - entry) * inv_dir, F_MAX)

    active = box_ok & entry_ok
    if alive is not None:
        active = active & alive
    best_t = torch.full((n,), F_MAX, dtype=torch.float32, device=dev)
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_n = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    is_int = torch.zeros((n,), dtype=torch.bool, device=dev)
    cache = ivox
    steps = torch.zeros((n,), dtype=torch.int32, device=dev)
    tri_tests = torch.zeros((n,), dtype=torch.int32, device=dev)
    rows = torch.arange(n, device=dev)
    inf = torch.tensor(float("inf"), device=dev)

    for it in range(gx + gy + gz):
        if it % _CHECK_EVERY == 0 and not bool(active.any()):
            break
        flat = voxel_base + ivox[:, 0] + ivox[:, 1] * gx + ivox[:, 2] * (gx * gy)
        flat = torch.where(active, flat, voxel_base)
        tri_ids = scene.voxel_tris_ell[flat.long()]  # (N, K), -1 = padding
        tri_valid = (tri_ids >= 0) & active[:, None]
        vidx = scene.tri_vidx[torch.clamp(tri_ids, min=0).long()].long()  # (N, K, 3)
        accept, t_cand = moller_trumbore(
            ro[:, None, :], rd[:, None, :], scene.vertex_pos[vidx[..., 0]],
            scene.vertex_pos[vidx[..., 1]], scene.vertex_pos[vidx[..., 2]])
        accept = accept & tri_valid

        # "update if strictly closer" over the bucket in order is its
        # first argmin (Renderer.cpp:208-212, 228-233)
        t_masked = torch.where(accept, t_cand, inf)
        j = t_masked.argmin(dim=1)
        t_vox = t_masked[rows, j]
        improves = active & (t_vox < best_t)
        best_t = torch.where(improves, t_vox, best_t)
        best_tri = torch.where(improves, tri_ids[rows, j], best_tri)
        n_avg = averaged_normal(scene.vertex_nrm, vidx[rows, j])
        best_n = torch.where(improves[:, None], n_avg, best_n)

        voxel_hit = active & accept.any(dim=1)
        is_int = is_int | voxel_hit
        cache = torch.where(voxel_hit[:, None], ivox, cache)
        # the early exit, after the voxel (Renderer.cpp:326-329)
        early = is_int & (torch.abs(cache - ivox) > 2).any(dim=-1)

        # x if tx < ty and tx < tz, else y if ty < tz, else z (Renderer.cpp:331-357)
        tx, ty, tz = tmax[:, 0], tmax[:, 1], tmax[:, 2]
        take_x = (tx < ty) & (tx < tz)
        take_y = ~take_x & (ty < tz)
        axis = torch.stack([take_x, take_y, ~take_x & ~take_y], dim=-1)
        ivox_new = ivox + torch.where(axis, step, 0)
        stepped_out = (axis & (ivox_new == out)).any(dim=-1)
        t_axis = torch.where(take_x, tx, torch.where(take_y, ty, tz))
        tmax_new = torch.where(axis, tmax + delta, tmax)

        steps = steps + active.to(torch.int32)
        tri_tests = tri_tests + tri_valid.sum(dim=1, dtype=torch.int32)
        ivox = torch.where(active[:, None], ivox_new, ivox)
        tmax = torch.where(active[:, None], tmax_new, tmax)
        active = active & ~early & ~stepped_out & ~(t_axis >= F_MAX)
    return is_int, best_t, best_tri, best_n, ro, rd, steps, tri_tests


def trace_parity(scene, ro_w: torch.Tensor, rd_w: torch.Tensor, return_stats: bool = False,
                 alive: Optional[torch.Tensor] = None):
    """Full-scene intersection of a wavefront of world-space rays: every
    model's grid march in model order, merged on a strictly smaller world
    distance (``Renderer.cpp:363-409``).  The record also holds the
    winner's model and triangle (``model``, ``tri``; -1 where none).  With
    ``return_stats`` also returns each ray's DDA steps and triangle tests,
    summed over models (``{"steps", "tri_tests"}``, int32).  A ray outside
    the (N,) bool mask ``alive`` is not traced: it gets the miss record
    (t = FLOAT_MAX, zero normal and colour, ``mat_type`` 0, ``mat_ri``
    1.5, model and triangle -1) and 0 steps and tests."""
    trace_parity.calls += 1
    n = ro_w.shape[0]
    dev = ro_w.device
    best = HitRecord.miss(n, dev)
    best.mat_ri = torch.full((n,), 1.5, dtype=torch.float32, device=dev)
    best.model = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best.tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    total_steps = torch.zeros((n,), dtype=torch.int32, device=dev)
    total_tests = torch.zeros((n,), dtype=torch.int32, device=dev)
    nm = normal_matrix(scene.model_to_world)
    for imodel in range(scene.num_models):
        is_int, t_model, tri_model, n_model, ro_m, rd_m, steps, tests = _dda_one_model(
            scene, imodel, ro_w, rd_w, alive)
        total_steps = total_steps + steps
        total_tests = total_tests + tests
        m2w = scene.model_to_world[imodel]
        world_pt = transform_position(torch.addcmul(ro_m, rd_m, t_model[:, None]), m2w)
        d = world_pt - ro_w
        world_d = sqrt_rn(dot3(d, d))
        closer = is_int & (best.t > world_d)
        world_n = normalize(mat3_apply(nm[imodel], n_model))
        ri = (scene.mat_refractive_index[imodel] if scene.mat_refractive_index is not None
              else torch.tensor(1.5, device=dev))
        best = HitRecord(
            t=torch.where(closer, world_d, best.t),
            normal=torch.where(closer[:, None], world_n, best.normal),
            mat_type=torch.where(closer, scene.mat_type[imodel], best.mat_type),
            mat_color=torch.where(closer[:, None], scene.mat_color[imodel], best.mat_color),
            mat_ri=torch.where(closer, ri, best.mat_ri),
            model=torch.where(closer, imodel, best.model),
            tri=torch.where(closer, tri_model, best.tri),
        )
    if return_stats:
        return best, {"steps": total_steps, "tri_tests": total_tests}
    return best


trace_parity.calls = 0
