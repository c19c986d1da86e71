"""Kernel G1: the parity engine's uniform-grid trace (``csrc/grid_dda.cu``).

:func:`grid_trace` launches the kernel for a scene and rays on the card,
one thread a ray (counted in ``grid_trace.launches``), and runs the plain
version, :func:`..ops.intersect.trace_parity`, for CPU tensors.  The
kernel repeats the plain version's arithmetic operation by operation, so
the two agree bit for bit on the card: t, normal, material, index of
refraction, and the DDA steps and triangle tests of ``return_stats``.
JAX runs this trace as XLA (``pathtracerap_tpu/ops/intersect.py:131``,
``:276``), not as a Pallas kernel.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.intersect import HitRecord, normal_matrix, trace_parity
from ..scene.types import SceneDevice
from . import _build
from .trace import _check


# the scene's fields that G1 reads (the normal matrices derive from
# model_to_world, the default indices of refraction from the model count)
_SCENE_FIELDS = (
    "world_to_model", "model_to_world", "model_mesh", "model_grid", "mesh_bbox_min",
    "mesh_bbox_max", "grid_voxel_width", "grid_voxel_start", "voxel_tri_start",
    "voxel_tri_count", "per_voxel_tris", "tri_vidx", "vertex_pos", "vertex_nrm", "mat_type",
    "mat_color", "mat_refractive_index", "grid_dims",
)


def _scene_args(scene: SceneDevice, dev: torch.device):
    """The kernel's scene tables in argument order, with the per-model
    normal matrices and indices of refraction made here: checked and made
    once a scene (held in ``scene.kernel_tables``), again only where one
    of its fields was replaced or ``model_to_world`` written in place."""
    stamp = (dev, scene.model_to_world._version)
    sources = tuple(getattr(scene, f) for f in _SCENE_FIELDS)
    held = scene.kernel_tables.get("grid_trace")
    if held is not None and held[0] == stamp and all(a is b for a, b in zip(held[1], sources)):
        return held[2]
    i = scene.num_models
    n_mesh = scene.mesh_bbox_min.shape[0]
    n_grid = scene.grid_voxel_width.shape[0]
    nv = scene.voxel_tri_start.shape[0]
    gx, gy, gz = scene.grid_dims
    if scene.grid_voxel_start.shape[0] != n_grid or nv != n_grid * gx * gy * gz:
        raise ValueError(f"grid tables do not hold {n_grid} grids of {scene.grid_dims} voxels")
    ri = scene.mat_refractive_index
    if ri is None:
        ri = torch.full((i,), 1.5, dtype=torch.float32, device=dev)
    f32, i32 = torch.float32, torch.int32
    tables = [
        ("world_to_model", scene.world_to_model, f32, (i, 4, 4)),
        ("model_to_world", scene.model_to_world, f32, (i, 4, 4)),
        ("normal_matrix", normal_matrix(scene.model_to_world).contiguous(), f32, (i, 3, 3)),
        ("model_mesh", scene.model_mesh, i32, (i,)),
        ("model_grid", scene.model_grid, i32, (i,)),
        ("mesh_bbox_min", scene.mesh_bbox_min, f32, (n_mesh, 3)),
        ("mesh_bbox_max", scene.mesh_bbox_max, f32, (n_mesh, 3)),
        ("grid_voxel_width", scene.grid_voxel_width, f32, (n_grid, 3)),
        ("grid_voxel_start", scene.grid_voxel_start, i32, (n_grid,)),
        ("voxel_tri_start", scene.voxel_tri_start, i32, (nv,)),
        ("voxel_tri_count", scene.voxel_tri_count, i32, (nv,)),
        ("per_voxel_tris", scene.per_voxel_tris, i32, tuple(scene.per_voxel_tris.shape[:1])),
        ("tri_vidx", scene.tri_vidx, i32, (scene.tri_vidx.shape[0], 3)),
        ("vertex_pos", scene.vertex_pos, f32, (scene.vertex_pos.shape[0], 3)),
        ("vertex_nrm", scene.vertex_nrm, f32, (scene.vertex_pos.shape[0], 3)),
        ("mat_type", scene.mat_type, i32, (i,)),
        ("mat_color", scene.mat_color, f32, (i, 3)),
        ("mat_refractive_index", ri, f32, (i,)),
    ]
    for name, x, dtype, shape in tables:
        _check(x, name, dtype, shape, dev)
    args = [x for _, x, _, _ in tables]
    scene.kernel_tables["grid_trace"] = (stamp, sources, args)
    return args


def grid_trace(scene: SceneDevice, ro: torch.Tensor, rd: torch.Tensor, return_stats: bool = False):
    """G1 (see :func:`..ops.intersect.trace_parity`) on world-space rays
    ro, rd (N, 3) f32: a :class:`HitRecord` with ``mat_ri``, and with
    ``return_stats`` also ``{"steps", "tri_tests"}`` (N,) int32, summed
    over the models."""
    if ro.device.type == "cpu":
        return trace_parity(scene, ro, rd, return_stats=return_stats)
    if ro.device.type != "cuda":
        raise ValueError(f"no kernel for device {ro.device}")
    dev = ro.device
    n = ro.shape[0]
    _check(ro, "ro", torch.float32, (n, 3), dev)
    _check(rd, "rd", torch.float32, (n, 3), dev)
    tables = _scene_args(scene, dev)
    f32, i32 = torch.float32, torch.int32
    rec = HitRecord(
        t=torch.empty(n, dtype=f32, device=dev), normal=torch.empty((n, 3), dtype=f32, device=dev),
        mat_type=torch.empty(n, dtype=i32, device=dev),
        mat_color=torch.empty((n, 3), dtype=f32, device=dev),
        mat_ri=torch.empty(n, dtype=f32, device=dev),
    )
    stats = ({"steps": torch.empty(n, dtype=i32, device=dev),
              "tri_tests": torch.empty(n, dtype=i32, device=dev)} if return_stats else None)
    p, c = ctypes.c_void_p, ctypes.c_int
    ptr = [p(x.data_ptr()) for x in tables]
    gx, gy, gz = scene.grid_dims
    err = _build.library().ptt_grid_dda(
        p(ro.data_ptr()), p(rd.data_ptr()), c(n), *ptr[:5], c(scene.num_models), *ptr[5:],
        c(gx), c(gy), c(gz),
        p(rec.t.data_ptr()), p(rec.normal.data_ptr()), p(rec.mat_type.data_ptr()),
        p(rec.mat_color.data_ptr()), p(rec.mat_ri.data_ptr()),
        p(stats["steps"].data_ptr() if stats else None),
        p(stats["tri_tests"].data_ptr() if stats else None),
        p(torch.cuda.current_stream(dev).cuda_stream),
    )
    _build.check(err, "ptt_grid_dda")
    grid_trace.launches += 1
    return (rec, stats) if return_stats else rec


grid_trace.launches = 0
