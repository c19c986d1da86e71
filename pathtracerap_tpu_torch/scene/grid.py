"""Uniform-grid build on the host (port of ``pathtracerap_tpu/scene/grid.py``).

One mesh's grid covers its AABB with ``dims`` voxels (25^3 in the
reference, ``Scene.cpp:318-396``).  Each triangle's AABB is stamped
conservatively into the voxels it overlaps (``computeVoxelIndex``,
``Scene.cpp:293-316``) and the buckets are flattened CSR-style: a voxel's
entries are ``tri_indices[start : start + count]``, in ascending triangle
order, as the reference's triangle-major loop fills them
(``Scene.cpp:349-375``).  The stamping is vectorized numpy (repeat, decode,
stable sort by voxel), or the native library's two-pass counting sort
(:mod:`..native`), which gives the same arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class UniformGrid:
    voxel_width: np.ndarray  # (3,) f32
    voxel_tri_start: np.ndarray  # (GX*GY*GZ,) i32 CSR starts
    voxel_tri_count: np.ndarray  # (GX*GY*GZ,) i32
    tri_indices: np.ndarray  # (P,) i32 flattened bucket contents
    dims: tuple


def build_uniform_grid(
    tri_verts: np.ndarray,
    bbox_min: np.ndarray,
    bbox_max: np.ndarray,
    dims: tuple = (25, 25, 25),
    tri_index_base: int = 0,
    backend: str = "auto",
) -> UniformGrid:
    """Build one mesh's grid from its (T, 3, 3) model-space triangles and
    AABB; ``tri_index_base`` is added to the bucket entries so that they
    are global triangle ids (``Scene.cpp:371``).

    ``backend``: ``"auto"`` uses the native builder when the library loads
    (:mod:`..native`) and numpy otherwise; ``"native"`` requires it
    (``RuntimeError`` when it does not load); ``"python"`` forces numpy.
    Both give the same arrays."""
    from .. import native

    if native.use(backend, "grid"):
        width, starts, counts, indices = native.build_grid_native(
            tri_verts, bbox_min, bbox_max, dims, tri_index_base)
        return UniformGrid(voxel_width=width, voxel_tri_start=starts,
                           voxel_tri_count=counts, tri_indices=indices, dims=dims)
    gx, gy, gz = dims
    n_voxels = gx * gy * gz
    tri_verts = np.asarray(tri_verts, dtype=np.float32)
    t = tri_verts.shape[0]
    bbox_min = np.asarray(bbox_min, dtype=np.float32)
    bbox_max = np.asarray(bbox_max, dtype=np.float32)

    voxel_width = ((bbox_max - bbox_min) / np.array(dims, dtype=np.float32)).astype(np.float32)
    # a planar mesh has a zero width, where the reference divides by zero
    safe_width = np.where(voxel_width > 0, voxel_width, np.float32(1e-30))

    if t == 0:
        return UniformGrid(
            voxel_width=voxel_width,
            voxel_tri_start=np.zeros(n_voxels, np.int32),
            voxel_tri_count=np.zeros(n_voxels, np.int32),
            tri_indices=np.zeros(0, np.int32),
            dims=dims,
        )

    # floor(abs(bb_min - t_min) / width), clamped (Scene.cpp:300-315)
    lo = np.floor(np.abs(bbox_min[None, :] - tri_verts.min(axis=1)) / safe_width).astype(np.int64)
    hi = np.floor(np.abs(bbox_min[None, :] - tri_verts.max(axis=1)) / safe_width).astype(np.int64)
    dims_arr = np.array(dims, dtype=np.int64)
    lo = np.clip(lo, 0, dims_arr - 1)
    hi = np.clip(hi, 0, dims_arr - 1)

    span = hi - lo + 1  # (T, 3) voxels per axis
    per_tri = span.prod(axis=1)
    total = int(per_tri.sum())

    tri_ids = np.repeat(np.arange(t, dtype=np.int64), per_tri)
    first = np.concatenate([[0], np.cumsum(per_tri)[:-1]])
    k = np.arange(total, dtype=np.int64) - first[tri_ids]
    nx = span[tri_ids, 0]
    ny = span[tri_ids, 1]
    ix = lo[tri_ids, 0] + k % nx
    iy = lo[tri_ids, 1] + (k // nx) % ny
    iz = lo[tri_ids, 2] + k // (nx * ny)
    voxel_flat = ix + iy * gx + iz * gx * gy

    order = np.lexsort((tri_ids, voxel_flat))
    voxel_tri_count = np.bincount(voxel_flat[order], minlength=n_voxels).astype(np.int32)
    voxel_tri_start = np.zeros(n_voxels, np.int32)
    np.cumsum(voxel_tri_count[:-1], out=voxel_tri_start[1:])
    return UniformGrid(
        voxel_width=voxel_width,
        voxel_tri_start=voxel_tri_start,
        voxel_tri_count=voxel_tri_count,
        tri_indices=(tri_ids[order] + tri_index_base).astype(np.int32),
        dims=dims,
    )


def grids_to_ell(
    voxel_tri_start: np.ndarray,
    voxel_tri_count: np.ndarray,
    per_voxel_tris: np.ndarray,
    pad_multiple: int = 8,
) -> np.ndarray:
    """The CSR buckets as a padded (NV, K) ELL matrix: row r holds voxel
    r's entries in CSR order, then -1; K is the largest bucket rounded up
    to ``pad_multiple``."""
    nv = voxel_tri_start.shape[0]
    k_max = int(voxel_tri_count.max()) if nv else 0
    k = max(pad_multiple, -(-k_max // pad_multiple) * pad_multiple)
    ell = np.full((nv, k), -1, dtype=np.int32)
    total = int(voxel_tri_count.sum())
    if total:
        rows = np.repeat(np.arange(nv, dtype=np.int64), voxel_tri_count)
        starts = np.repeat(voxel_tri_start.astype(np.int64), voxel_tri_count)
        within = np.arange(total, dtype=np.int64) - starts
        ell[rows, within] = per_voxel_tris[starts + within]
    return ell
