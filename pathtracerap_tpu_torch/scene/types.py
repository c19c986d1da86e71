"""Scene data model (port of ``pathtracerap_tpu/scene/types.py``).

* :class:`SceneHost` — NumPy structure-of-arrays built on the host by
  :mod:`pathtracerap_tpu_torch.scene.build`: geometry pools, the model
  (instance) table, per-model materials and the uniform grids.
* :class:`SceneDevice` — the same arrays as torch tensors on one device,
  plus the static world-instance maps the bake consumes.
* :class:`WorldTriangles` — the baked world-space triangle soup with the
  fused operand pack and attribute rows that the CUDA kernels read
  (see :func:`pathtracerap_tpu_torch.ops.plucker.bake_world_triangles`).

The uniform grids (one per mesh that a model uses, ``Scene.cpp:318-396``)
are the reference's CSR buckets plus a padded ELL view; they serve the
parity DDA engine (:mod:`pathtracerap_tpu_torch.ops.intersect`,
``csrc/grid_dda.cu``).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np
import torch


class MaterialType(enum.IntEnum):
    """Material enum; values match the reference order (``Primitive.h:70-79``)."""

    DIFFUSE = 0
    SPECULAR = 1
    REFLECTIVE = 2
    REFRACTIVE = 3
    EMISSIVE = 4
    COAT = 5
    METAL = 6


@dataclasses.dataclass
class Material:
    material_type: MaterialType
    color: tuple
    refractive_index: float = 1.0
    reflectivity: float = 0.0


@dataclasses.dataclass
class SceneHost:
    """Host-side scene: NumPy SoA of the geometry pools (model space), the
    model table and the uniform grids (CSR buckets, ``Scene.cpp:377-394``,
    and their padded ELL view)."""

    # geometry pools
    vertex_pos: np.ndarray  # (V, 3) f32
    vertex_nrm: np.ndarray  # (V, 3) f32
    tri_vidx: np.ndarray  # (T, 3) i32

    # mesh table
    mesh_tri_start: np.ndarray  # (M,) i32
    mesh_tri_end: np.ndarray  # (M,) i32
    mesh_bbox_min: np.ndarray  # (M, 3) f32
    mesh_bbox_max: np.ndarray  # (M, 3) f32

    # model (instance) table
    model_mesh: np.ndarray  # (I,) i32
    model_grid: np.ndarray  # (I,) i32
    model_to_world: np.ndarray  # (I, 4, 4) f32
    world_to_model: np.ndarray  # (I, 4, 4) f32
    mat_type: np.ndarray  # (I,) i32
    mat_color: np.ndarray  # (I, 3) f32
    mat_refractive_index: np.ndarray  # (I,) f32
    mat_reflectivity: np.ndarray  # (I,) f32

    # uniform grids, one per unique mesh that at least one model references
    grid_mesh: np.ndarray  # (G,) i32 mesh index
    grid_voxel_start: np.ndarray  # (G,) i32 offset into the voxel pool
    grid_voxel_width: np.ndarray  # (G, 3) f32
    voxel_tri_start: np.ndarray  # (NV,) i32 CSR start into per_voxel_tris
    voxel_tri_count: np.ndarray  # (NV,) i32
    per_voxel_tris: np.ndarray  # (P,) i32 triangle indices (global)
    voxel_tris_ell: np.ndarray  # (NV, K) i32, padded with -1
    grid_dims: tuple = (25, 25, 25)

    @property
    def num_models(self) -> int:
        return int(self.model_mesh.shape[0])

    @property
    def num_triangles(self) -> int:
        return int(self.tri_vidx.shape[0])

    def world_instance_maps(self, align: int = 128):
        """Static index maps enumerating every (model, mesh triangle) pair.

        ``world_tri_src[k]`` is the global triangle index (−1 for padding)
        and ``world_tri_model[k]`` the model instance for world triangle
        ``k``.  Each model's range is padded to a multiple of ``align`` so
        128-triangle culling clusters never span two model instances.
        """
        srcs, mdls = [], []
        for i in range(self.num_models):
            mi = int(self.model_mesh[i])
            ts, te = int(self.mesh_tri_start[mi]), int(self.mesh_tri_end[mi])
            n = te - ts
            pad = (-n) % align
            srcs.append(np.arange(ts, te, dtype=np.int32))
            srcs.append(np.full(pad, -1, dtype=np.int32))
            mdls.append(np.full(n + pad, i, dtype=np.int32))
        return np.concatenate(srcs), np.concatenate(mdls)

    def to_device(self, device="cuda") -> "SceneDevice":
        """The scene's arrays as tensors on ``device``: the card unless the
        caller asks for the CPU."""
        world_tri_src, world_tri_model = self.world_instance_maps()

        def put(a, dtype):
            return torch.as_tensor(np.asarray(a, dtype), device=device)

        f32, i32 = np.float32, np.int32
        return SceneDevice(
            vertex_pos=put(self.vertex_pos, f32),
            vertex_nrm=put(self.vertex_nrm, f32),
            tri_vidx=put(self.tri_vidx, i32),
            mesh_bbox_min=put(self.mesh_bbox_min, f32),
            mesh_bbox_max=put(self.mesh_bbox_max, f32),
            model_mesh=put(self.model_mesh, i32),
            model_grid=put(self.model_grid, i32),
            model_to_world=put(self.model_to_world, f32),
            world_to_model=put(self.world_to_model, f32),
            mat_type=put(self.mat_type, i32),
            mat_color=put(self.mat_color, f32),
            mat_refractive_index=put(self.mat_refractive_index, f32),
            grid_mesh=put(self.grid_mesh, i32),
            grid_voxel_start=put(self.grid_voxel_start, i32),
            grid_voxel_width=put(self.grid_voxel_width, f32),
            voxel_tri_start=put(self.voxel_tri_start, i32),
            voxel_tri_count=put(self.voxel_tri_count, i32),
            per_voxel_tris=put(self.per_voxel_tris, i32),
            voxel_tris_ell=put(self.voxel_tris_ell, i32),
            grid_dims=tuple(self.grid_dims),
            world_tri_src=put(world_tri_src, i32),
            world_tri_model=put(world_tri_model, i32),
            n_world_valid=int((world_tri_src >= 0).sum()),
        )


@dataclasses.dataclass
class SceneDevice:
    """The host scene as tensors on one device."""

    vertex_pos: torch.Tensor  # (V, 3) f32
    vertex_nrm: torch.Tensor  # (V, 3) f32
    tri_vidx: torch.Tensor  # (T, 3) i32
    mesh_bbox_min: torch.Tensor  # (M, 3) f32
    mesh_bbox_max: torch.Tensor  # (M, 3) f32
    model_mesh: torch.Tensor  # (I,) i32
    model_grid: torch.Tensor  # (I,) i32
    model_to_world: torch.Tensor  # (I, 4, 4) f32
    world_to_model: torch.Tensor  # (I, 4, 4) f32
    mat_type: torch.Tensor  # (I,) i32
    mat_color: torch.Tensor  # (I, 3) f32
    grid_mesh: torch.Tensor  # (G,) i32
    grid_voxel_start: torch.Tensor  # (G,) i32
    grid_voxel_width: torch.Tensor  # (G, 3) f32
    voxel_tri_start: torch.Tensor  # (NV,) i32
    voxel_tri_count: torch.Tensor  # (NV,) i32
    per_voxel_tris: torch.Tensor  # (P,) i32
    voxel_tris_ell: torch.Tensor  # (NV, K) i32, padded with -1
    world_tri_src: torch.Tensor  # (Tw,) i32 global triangle per world tri, -1 pad
    world_tri_model: torch.Tensor  # (Tw,) i32 owning model instance
    mat_refractive_index: Optional[torch.Tensor] = None  # (I,) f32
    grid_dims: tuple = (25, 25, 25)
    # number of REAL instanced triangles (world_tri_src >= 0); the bake
    # uses it to drop pure-padding traversal blocks.  0 means unknown.
    n_world_valid: int = 0
    # what a kernel wrapper derives from this scene once and reuses
    # (kernels/dda.py: G1's checked tables); a scene made by replace()
    # starts empty
    kernel_tables: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                            compare=False)

    @property
    def num_models(self) -> int:
        return int(self.model_mesh.shape[0])

    @property
    def device(self) -> torch.device:
        return self.vertex_pos.device

    def replace(self, **fields) -> "SceneDevice":
        return dataclasses.replace(self, **fields)


@dataclasses.dataclass
class WorldTriangles:
    """World-space baked triangle soup.

    The triangle axis is padded to a multiple of ``tri_block`` (the fused
    pack's block width), or of 128 in a world without a pack
    (``tri_block == 0``); padding rows have ``valid == 0`` and zero
    geometry, so every hit test rejects them (det == 0).

    ``edge_mat`` (3, 8, T) and ``plane_mat`` (8, T) are the dense tracer's
    operands (kernel 5, ``csrc/nearest_hit.cu``): per triangle the three
    edge columns ``[p x q, q - p, 0, 0]`` and ``[n, d_plane, 0...]``, so a
    ray's ``[dir, orig x dir, 0, 0]`` gives the side values and its
    ``[orig, -1, alive, 0...]`` gives ``orig . n - d_plane``;
    ``cluster_aabb`` gates them per 128-triangle cluster, after
    ``group_aabb`` has gated the clusters' groups
    (:func:`pathtracerap_tpu_torch.ops.plucker.cluster_group_aabb`).

    ``fused_ops`` (16, 4*T) is the operand pack the traversal kernels
    read.  Per block of ``tri_block`` triangles its columns are grouped
    ``[s_ab | s_bc | s_ca | plane]``; a ray vector
    ``[dir(0:3), orig x dir(3:6), orig(6:9), -1(9), alive(10), 0...]``
    dotted with an edge column (rows 0-5 ``[p x q, q - p]``) gives that
    edge's Pluecker side value, and with the plane column (rows 6-9
    ``[-n, -d_plane]``) gives t * det.  ``ops_tri`` (T, 24) holds the same
    non-zero entries triangle-major, detached
    (:func:`pathtracerap_tpu_torch.ops.plucker.tri_major_ops`): what kernels 1
    to 4 stage.  ``attr_rows`` (16, T) holds the
    per-triangle shading attributes ``[shade_n(0:3), mat_type(3),
    rgb(4:7), geom_n(7:10), idx+1(10), refractive_index(11), 0(12:16)]``.

    ``v0``, ``e1``, ``e2``, ``tri_model`` and ``mat_table`` serve the
    differentiable replay (:mod:`pathtracerap_tpu_torch.diff.fast`), which
    recomputes hits at frozen triangle indices; ``mat_table`` is the
    scene's ``mat_color`` leaf itself and ``mat_color == mat_table[tri_model]``.
    """

    edge_pluecker: torch.Tensor  # (3, 6, T) f32 edge columns [p x q; q - p]
    plane_n: torch.Tensor  # (T, 3) geometric normal (b-a) x (c-a)
    plane_d: torch.Tensor  # (T,) dot(n, a)
    cluster_aabb: torch.Tensor  # (8, T/128) per-128-tri [min; max; 0, 0]
    shade_normal: torch.Tensor  # (T, 3) normalized averaged vertex normal
    mat_type: torch.Tensor  # (T,) i32
    mat_color: torch.Tensor  # (T, 3) f32
    mat_ri: torch.Tensor  # (T,) f32 refractive index (1.5 on padding)
    valid: torch.Tensor  # (T,) f32 1.0 real, 0.0 padding
    v0: torch.Tensor  # (T, 3) f32 vertex a
    e1: torch.Tensor  # (T, 3) f32 b - a
    e2: torch.Tensor  # (T, 3) f32 c - a
    tri_model: torch.Tensor  # (T,) i32 owning model instance (0 on padding)
    mat_table: torch.Tensor  # (M, 3) f32 per-model color
    edge_mat: Optional[torch.Tensor] = None  # (3, 8, T) f32 edge_pluecker + 2 zero rows
    plane_mat: Optional[torch.Tensor] = None  # (8, T) f32 [n; d_plane; 0...]
    group_aabb: Optional[torch.Tensor] = None  # (8, groups) f32 union boxes of cluster_aabb
    fused_ops: Optional[torch.Tensor] = None  # (16, 4*T) f32
    ops_tri: Optional[torch.Tensor] = None  # (T, 24) f32, triangle-major fused_ops
    block_aabb: Optional[torch.Tensor] = None  # (nb_real, 8) f32
    attr_rows: Optional[torch.Tensor] = None  # (16, T) f32
    sub_aabb: Optional[torch.Tensor] = None  # (T/128, 8) f32, NaN padding rows
    tri_block: int = 0  # fused-pack block width (0: no pack)
    n_valid: int = 0  # real triangles (they come first in the soup)

    @property
    def num_triangles(self) -> int:
        return int(self.valid.shape[0])

    @property
    def device(self) -> torch.device:
        return self.valid.device

    def detached(self) -> "WorldTriangles":
        """The same world with every tensor detached from the autograd
        graph: what the kernels and the index-stream forward read."""
        return dataclasses.replace(self, **{
            f.name: v.detach()
            for f in dataclasses.fields(self)
            for v in [getattr(self, f.name)]
            if isinstance(v, torch.Tensor)
        })
