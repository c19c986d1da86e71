"""Kernel G1: the parity engine's uniform-grid trace (``csrc/grid_dda.cu``).

:func:`grid_trace` launches the kernel for a scene and rays on the card
(counted in ``grid_trace.launches``): one wave of persistent blocks whose
warps take the live rays of the ``alive`` mask from a per-launch counter
and refill their lanes as rays finish.  For CPU tensors it runs the plain
version, :func:`..ops.intersect.trace_parity`.  The kernel repeats the
plain version's arithmetic operation by operation, so the two agree bit
for bit on the card: t, normal, material, index of refraction, the
winning model and triangle, and the DDA steps and triangle tests of
``return_stats``; a dead ray gets the miss record and no work.  JAX runs
this trace as XLA (``pathtracerap_tpu/ops/intersect.py:131``, ``:276``),
not as a Pallas kernel.

The kernel reads the scene through tables made once a scene
(:func:`_scene_args`).  A block stages the model rows, the triangle
table and the voxel and bucket tables of :data:`SHARED_TABLES` into
shared memory when they fit in ``GRID_DDA_SMEM_MAX`` bytes (and every
index fits 16 bits), else the same kernel reads them from global memory.
A call without a liveness mask (a camera's primaries) takes the kernel's
coherent form, one with a mask (a bounce) its bounce form.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..ops.intersect import HitRecord, averaged_normal, normal_matrix, trace_parity
from ..scene.types import SceneDevice
from . import _build
from .trace import _check

MODEL_WORDS = 48  # csrc/grid_dda.cu kModelWords: a model's row of the table
# dynamic shared memory a block stages at most (the static queues and warp
# scratch take 40 KB more of the H100's 227 KB): the reference scene's
# 179,376 bytes fit; the highpoly blob's 5.3 MB of triangles take the
# global-memory form, as does a scene whose indices pass 16 bits
GRID_DDA_SMEM_MAX = 180 * 1024
# the tables the shared form stages, in order
SHARED_TABLES = ("models", "tris", "occupied", "word_rank", "cells", "entries")

# the scene's fields that G1's tables derive from
_SCENE_FIELDS = (
    "world_to_model", "model_to_world", "model_mesh", "model_grid", "mesh_bbox_min",
    "mesh_bbox_max", "grid_voxel_width", "grid_voxel_start", "voxel_tri_start",
    "voxel_tri_count", "per_voxel_tris", "tri_vidx", "vertex_pos", "vertex_nrm", "mat_type",
    "mat_color", "mat_refractive_index", "grid_dims",
)


def _bits(x: torch.Tensor) -> torch.Tensor:
    """An int32 column's bits as float32, for the model rows."""
    return x.to(torch.int32).contiguous().view(torch.float32)[:, None]


def _scene_args(scene: SceneDevice, dev: torch.device) -> dict:
    """G1's tables for a scene on ``dev``: ``models`` (I, MODEL_WORDS) f32
    (rows 0 to 2 of world_to_model and model_to_world, the normal matrix,
    the mesh's box, the grid's voxel width and first voxel, the material
    type, colour and index of refraction), ``tris`` the (T, 9) mesh-space
    (v0, e1, e2) flattened and padded to a multiple of 4 floats,
    ``tri_nrm`` (T, 3) the averaged vertex normals, ``voxel`` (NV, 2)
    int32 (start, count), ``vt_tris`` the buckets' triangles, ``occupied``
    a bit a voxel (bit v % 32 of word v // 32: a non-empty bucket),
    ``word_rank`` the set bits before each word, ``cells`` a set bit's
    bucket (start | count << 16), ``entries`` the buckets' triangles
    (16-bit values two a word, the first in the low half), and
    ``shared``, ``smem_bytes`` (the form the kernel takes and the bytes
    it stages: SHARED_TABLES, each padded to a multiple of 4 words; the
    shared form needs every index below 2 ** 16).  The scene's
    fields are checked and the tables made once a scene (held in
    ``scene.kernel_tables``), again only where one of its fields was
    replaced or ``model_to_world`` written in place."""
    stamp = (dev, scene.model_to_world._version)
    sources = tuple(getattr(scene, f) for f in _SCENE_FIELDS)
    held = scene.kernel_tables.get("grid_trace")
    if held is not None and held[0] == stamp and all(a is b for a, b in zip(held[1], sources)):
        return held[2]
    i = scene.num_models
    n_mesh = scene.mesh_bbox_min.shape[0]
    n_grid = scene.grid_voxel_width.shape[0]
    nv = scene.voxel_tri_start.shape[0]
    n_tri = scene.tri_vidx.shape[0]
    gx, gy, gz = scene.grid_dims
    if scene.grid_voxel_start.shape[0] != n_grid or nv != n_grid * gx * gy * gz:
        raise ValueError(f"grid tables do not hold {n_grid} grids of {scene.grid_dims} voxels")
    ri = scene.mat_refractive_index
    if ri is None:
        ri = torch.full((i,), 1.5, dtype=torch.float32, device=dev)
    f32, i32 = torch.float32, torch.int32
    checks = [
        ("world_to_model", scene.world_to_model, f32, (i, 4, 4)),
        ("model_to_world", scene.model_to_world, f32, (i, 4, 4)),
        ("model_mesh", scene.model_mesh, i32, (i,)),
        ("model_grid", scene.model_grid, i32, (i,)),
        ("mesh_bbox_min", scene.mesh_bbox_min, f32, (n_mesh, 3)),
        ("mesh_bbox_max", scene.mesh_bbox_max, f32, (n_mesh, 3)),
        ("grid_voxel_width", scene.grid_voxel_width, f32, (n_grid, 3)),
        ("grid_voxel_start", scene.grid_voxel_start, i32, (n_grid,)),
        ("voxel_tri_start", scene.voxel_tri_start, i32, (nv,)),
        ("voxel_tri_count", scene.voxel_tri_count, i32, (nv,)),
        ("per_voxel_tris", scene.per_voxel_tris, i32, tuple(scene.per_voxel_tris.shape[:1])),
        ("tri_vidx", scene.tri_vidx, i32, (n_tri, 3)),
        ("vertex_pos", scene.vertex_pos, f32, (scene.vertex_pos.shape[0], 3)),
        ("vertex_nrm", scene.vertex_nrm, f32, (scene.vertex_pos.shape[0], 3)),
        ("mat_type", scene.mat_type, i32, (i,)),
        ("mat_color", scene.mat_color, f32, (i, 3)),
        ("mat_refractive_index", ri, f32, (i,)),
    ]
    for name, x, dtype, shape in checks:
        _check(x, name, dtype, shape, dev)
    with torch.no_grad():  # constants of the kernel, also where a field is a leaf of a loss
        args = _tables(scene, ri, dev)
    scene.kernel_tables["grid_trace"] = (stamp, sources, args)
    return args


def _words(x: torch.Tensor) -> torch.Tensor:
    """A 1-D int64 tensor of 32-bit patterns as int32, zero-padded to a
    multiple of 4 words (the kernel stages 16 bytes a copy)."""
    out = torch.zeros(-(-x.numel() // 4) * 4, dtype=torch.int64, device=x.device)
    out[:x.numel()] = x
    return torch.where(out >= 2 ** 31, out - 2 ** 32, out).to(torch.int32)


def _pairs16(x: torch.Tensor) -> torch.Tensor:
    """Values below 2 ** 16 as 16-bit halves, two a word (the first in the
    low half), as :func:`_words` pads them."""
    x = x & 0xFFFF
    x = torch.cat([x, x.new_zeros(x.numel() % 2)])
    return _words(x[0::2] | (x[1::2] << 16))


def _tables(scene: SceneDevice, ri: torch.Tensor, dev: torch.device) -> dict:
    i = scene.num_models
    mesh, grid = scene.model_mesh.long(), scene.model_grid.long()
    models = torch.cat([
        scene.world_to_model[:, :3, :].reshape(i, 12),
        scene.model_to_world[:, :3, :].reshape(i, 12),
        normal_matrix(scene.model_to_world).reshape(i, 9),
        scene.mesh_bbox_min[mesh], scene.mesh_bbox_max[mesh], scene.grid_voxel_width[grid],
        _bits(scene.grid_voxel_start[grid]), _bits(scene.mat_type), scene.mat_color, ri[:, None],
    ], dim=1).contiguous()
    vidx = scene.tri_vidx.long()
    v = scene.vertex_pos[vidx]  # (T, 3, 3)
    tab = torch.cat([v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]], dim=1).reshape(-1)
    tris = torch.zeros(-(-tab.numel() // 4) * 4, dtype=torch.float32, device=dev)
    tris[:tab.numel()] = tab
    # the shared form: a bit a voxel for a non-empty bucket, 32 voxels a
    # word; the set bits before each word; a cell a set bit, its bucket's
    # start | count << 16; and the entries, 16 bits each
    start, count = scene.voxel_tri_start.long(), scene.voxel_tri_count.long()
    busy = (count > 0).long()
    busy = torch.cat([busy, busy.new_zeros(-busy.numel() % 32)]).reshape(-1, 32)
    per_word = busy.sum(dim=1)
    full = count > 0
    entries = scene.per_voxel_tris.long()
    small = max(vidx.shape[0], entries.numel(), int(full.sum()) + 1,
                int(count.max()) + 1 if count.numel() else 0) <= 2 ** 16
    shared_tables = {
        "occupied": _words((busy << torch.arange(32, device=dev)).sum(dim=1)),
        "word_rank": _pairs16(torch.cumsum(per_word, 0) - per_word),
        "cells": _words(start[full] | (count[full] << 16)),
        "entries": _pairs16(entries),
    }
    smem_bytes = 4 * (models.numel() + tris.numel()
                      + sum(x.numel() for x in shared_tables.values()))
    return {
        "models": models, "tris": tris,
        "tri_nrm": averaged_normal(scene.vertex_nrm, vidx).contiguous(),
        "voxel": torch.stack([scene.voxel_tri_start, scene.voxel_tri_count], dim=1).contiguous(),
        "vt_tris": scene.per_voxel_tris, **shared_tables,
        "shared": small and smem_bytes <= GRID_DDA_SMEM_MAX, "smem_bytes": smem_bytes,
    }


def grid_trace_form(scene: SceneDevice) -> dict:
    """The form G1 takes for a scene on the card: ``shared`` (the tables
    staged into shared memory), ``smem_bytes`` (dynamic shared memory a
    block, 0 in the global-memory form) and ``blocks_per_sm`` (the
    occupancy the launch's wave is sized from)."""
    t = _scene_args(scene, scene.device)
    smem = t["smem_bytes"] if t["shared"] else 0
    out = ctypes.c_int(0)
    _build.check(_build.library().ptt_grid_dda_blocks_per_sm(int(t["shared"]), smem,
                                                             ctypes.byref(out)),
                 "ptt_grid_dda_blocks_per_sm")
    return {"shared": t["shared"], "smem_bytes": smem, "blocks_per_sm": out.value}


def grid_trace(scene: SceneDevice, ro: torch.Tensor, rd: torch.Tensor,
               alive: Optional[torch.Tensor] = None, return_stats: bool = False):
    """G1 (see :func:`..ops.intersect.trace_parity`) on world-space rays
    ro, rd (N, 3) f32: a :class:`HitRecord` with ``mat_ri``, ``model`` and
    ``tri``, and with ``return_stats`` also ``{"steps", "tri_tests"}``
    (N,) int32, summed over the models.  Only the rays of the (N,) bool
    mask ``alive`` are traced (all without it); the others get the miss
    record and 0 steps and tests."""
    if ro.device.type == "cpu":
        return trace_parity(scene, ro, rd, return_stats=return_stats, alive=alive)
    if ro.device.type != "cuda":
        raise ValueError(f"no kernel for device {ro.device}")
    dev = ro.device
    n = ro.shape[0]
    _check(ro, "ro", torch.float32, (n, 3), dev)
    _check(rd, "rd", torch.float32, (n, 3), dev)
    if alive is not None:
        _check(alive, "alive", torch.bool, (n,), dev)
    t = _scene_args(scene, dev)
    f32, i32 = torch.float32, torch.int32
    rec = HitRecord(
        t=torch.empty(n, dtype=f32, device=dev), normal=torch.empty((n, 3), dtype=f32, device=dev),
        mat_type=torch.empty(n, dtype=i32, device=dev),
        mat_color=torch.empty((n, 3), dtype=f32, device=dev),
        mat_ri=torch.empty(n, dtype=f32, device=dev),
        model=torch.empty(n, dtype=i32, device=dev), tri=torch.empty(n, dtype=i32, device=dev),
    )
    stats = ({"steps": torch.empty(n, dtype=i32, device=dev),
              "tri_tests": torch.empty(n, dtype=i32, device=dev)} if return_stats else None)
    counter = torch.empty(1, dtype=i32, device=dev)
    p, c = ctypes.c_void_p, ctypes.c_int
    gx, gy, gz = scene.grid_dims
    err = _build.library().ptt_grid_dda(
        p(ro.data_ptr()), p(rd.data_ptr()), p(alive.data_ptr() if alive is not None else None),
        c(n), p(t["models"].data_ptr()), c(scene.num_models), p(t["tris"].data_ptr()),
        p(t["tri_nrm"].data_ptr()), p(t["voxel"].data_ptr()), p(t["vt_tris"].data_ptr()),
        *(p(t[k].data_ptr()) for k in SHARED_TABLES[2:]),
        *(c(t[k].numel()) for k in SHARED_TABLES),
        c(gx), c(gy), c(gz), c(int(t["shared"])), c(int(alive is None)),
        p(counter.data_ptr()),
        p(rec.t.data_ptr()), p(rec.normal.data_ptr()), p(rec.mat_type.data_ptr()),
        p(rec.mat_color.data_ptr()), p(rec.mat_ri.data_ptr()), p(rec.model.data_ptr()),
        p(rec.tri.data_ptr()), p(stats["steps"].data_ptr() if stats else None),
        p(stats["tri_tests"].data_ptr() if stats else None),
        p(torch.cuda.current_stream(dev).cuda_stream),
    )
    _build.check(err, "ptt_grid_dda")
    grid_trace.launches += 1
    return (rec, stats) if return_stats else rec


grid_trace.launches = 0
