"""World bake and the brute-force Pluecker tracer (port of
``pathtracerap_tpu/ops/plucker.py``).

With per-ray ``W = [dir, orig x dir]`` and per-edge ``[p x q; q - p]`` the
Moeller-Trumbore edge tests are dot products (Pluecker side values):
``det = s_ab + s_bc + s_ca``, ``u = s_ca / det``, ``v = s_ab / det`` and
``t = (d_plane - orig . n) / det``.  :func:`bake_world_triangles` bakes all
model instances into one world-space soup in (fat | Morton | padding)
order and emits the fused operand pack the traversal kernels read;
:func:`trace_mxu` is the brute-force nearest hit over the whole soup, the
plain reference for hits.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import constants
from ..scene.types import SceneDevice, WorldTriangles
from .intersect import HitRecord
from .math import cross3, dot3, inv3x3, normalize, normalize_guarded

F_MAX = constants.FLOAT_MAX
EPS = constants.EPSILON
SUB_BLOCK = 128  # cluster / sub-block width of the bake
# The fused pack costs 320 bytes a triangle with its attribute rows; JAX
# drops it above this many world triangles, and so does the port.
PACK_MAX_TRIANGLES = 2_097_152
# Clusters a group box of kernel 5's two-level gate unites (G; chosen on
# the card, PERF.md; csrc/nearest_hit.cu kGroup).
CLUSTER_GROUP = 64


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _morton3(p: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """30-bit Morton code (int32) of points ``p`` (T, 3) within AABB [lo, hi]."""
    q = torch.clamp(
        (p - lo) / torch.clamp(hi - lo, min=1e-30) * 1023.0, 0.0, 1023.0
    ).to(torch.int32)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    return (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])


def _matvec(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(T, 3, 3) @ (T, 3) with the products accumulated by fused
    multiply-adds in column order, as XLA's CPU dot does: a one-ulp change
    in a vertex can flip the Morton order of the bake."""
    acc = m[:, :, 0] * p[:, None, 0]
    acc = torch.addcmul(acc, m[:, :, 1], p[:, None, 1])
    return torch.addcmul(acc, m[:, :, 2], p[:, None, 2])


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(dot3(v, v))


def keeps_pack(n_world_triangles: int) -> bool:
    """Whether the bake emits the fused pack for a world of this many
    triangles (padding included): JAX's budget of ``PACK_MAX_TRIANGLES``
    (``pathtracerap_tpu/ops/plucker.py:194``).  Above it the world has no
    pack and every engine routes to the dense ``pallas`` tracer."""
    return n_world_triangles <= PACK_MAX_TRIANGLES


def tri_major_ops(fused_ops: torch.Tensor, tri_block: int) -> torch.Tensor:
    """The (T, 24) triangle-major operand pack of kernels 1 to 4: for
    triangle g the 22 non-zero entries of its four ``fused_ops`` columns
    in the kernels' staging order (s_ab rows 0-5, s_bc rows 0-5, s_ca rows
    0-5, plane rows 6-9), then two zeros.  96 bytes a triangle, so a run
    of triangles is one contiguous, 16-byte aligned span."""
    t = fused_ops.shape[1] // 4
    q = (
        fused_ops.reshape(16, t // tri_block, 4, tri_block)
        .permute(1, 3, 2, 0)  # (nb, TB, quadrant, row)
        .reshape(t, 4, 16)
    )
    return torch.cat(
        [q[:, 0:3, 0:6].reshape(t, 18), q[:, 3, 6:10], fused_ops.new_zeros((t, 2))], dim=1
    ).contiguous()


def dense_runs(t_tris: int, n_valid: int) -> int:
    """The 128-triangle runs (clusters) kernel 5 visits: those that hold real
    triangles (``n_valid`` of them come first), or all when unknown (0)."""
    if t_tris % SUB_BLOCK:
        raise ValueError(f"{t_tris} triangles are not a multiple of {SUB_BLOCK}")
    runs = t_tris // SUB_BLOCK
    return min(runs, -(-n_valid // SUB_BLOCK)) if n_valid else runs


def cluster_group_aabb(cluster_aabb: torch.Tensor, n_valid: int) -> torch.Tensor:
    """The union boxes of kernel 5's two-level gate, (8, ceil(runs /
    CLUSTER_GROUP)) ``[min; max; 0, 0]``, ``runs`` the clusters that hold the
    world's ``n_valid`` real triangles (:func:`dense_runs`): per group of
    ``CLUSTER_GROUP`` consecutive clusters among them, the members' smallest
    min and largest max, no slack added; the last group holds the clusters
    left.

    The gate reaches a group box by the clusters' slab test
    (:func:`..kernels.trace.slab_reaches`).  Where a member's box is
    inverted or NaN (a cluster of padding only: min = +F_MAX, max =
    -F_MAX, which every ray reaches), the group's box is infinite, which
    every ray with a finite origin reaches too.  Otherwise the group box
    contains each member's, and the slab test's rounding is monotone, so a
    ray that reaches a member reaches its group at any t at least as
    large: the gate that tests a group before its members skips only
    clusters the per-cluster gate skips.  Computed once per world, by the
    bake, from a detached ``cluster_aabb``."""
    g = CLUSTER_GROUP
    runs = dense_runs(cluster_aabb.shape[1] * SUB_BLOCK, n_valid)
    box = cluster_aabb[:6, :runs].detach()
    pad = (-runs) % g
    # the cut last group is padded with entries that leave min and max as they are
    lo = torch.cat([box[0:3], box.new_full((3, pad), F_MAX)], dim=1).reshape(3, -1, g)
    hi = torch.cat([box[3:6], box.new_full((3, pad), -F_MAX)], dim=1).reshape(3, -1, g)
    bad = (~(box[0:3] <= box[3:6])).any(dim=0)  # (runs,) inverted or NaN member boxes
    inverted = torch.cat([bad, bad.new_zeros(pad)]).reshape(-1, g).any(dim=1)  # (groups,)
    lo_g = torch.where(inverted, -float("inf"), lo.amin(dim=2))
    hi_g = torch.where(inverted, float("inf"), hi.amax(dim=2))
    return torch.cat([lo_g, hi_g, box.new_zeros((2, lo_g.shape[1]))], dim=0).contiguous()


def bake_world_triangles(scene: SceneDevice, fused_tile: Optional[int] = 512) -> WorldTriangles:
    """Bake all model instances into a world-space triangle soup, with the
    dense tracer's operands (``edge_mat``, ``plane_mat``, ``cluster_aabb``,
    ``group_aabb``) and, unless ``fused_tile`` is None or the world is
    above the pack budget (:func:`keeps_pack`), the fused (16, 4*T) operand pack, its
    triangle-major copy ``ops_tri`` (:func:`tri_major_ops`), block /
    sub-block AABBs and attribute rows of the worklist kernels (see
    :class:`WorldTriangles`).  Without a pack the triangle axis is padded
    to ``SUB_BLOCK`` and ``tri_block`` is 0.

    Differentiable in ``vertex_pos``, ``vertex_nrm``, ``model_to_world``
    and ``mat_color``: the integer parts (Morton codes, the argsorts, the
    static counts) carry no gradient and cut no path one needs, and no
    tensor that may require grad is written in place."""
    if fused_tile is not None and fused_tile % SUB_BLOCK:
        raise ValueError(f"fused_tile must be a multiple of {SUB_BLOCK}, got {fused_tile}")
    src = scene.world_tri_src.long()
    mdl = scene.world_tri_model.long()
    dev = scene.device
    # model-alignment padding entries carry src == -1: zero their vertices
    src_valid = (src >= 0).to(torch.float32)[:, None]
    vidx = scene.tri_vidx[torch.clamp(src, min=0)].long()  # (Tw, 3)

    m2w = scene.model_to_world[mdl]  # (Tw, 4, 4)
    rot = m2w[:, :3, :3]
    trans = m2w[:, :3, 3]

    def xform(p):  # (Tw, 3) model-space points
        return (_matvec(rot, p) + trans) * src_valid

    a = xform(scene.vertex_pos[vidx[:, 0]])
    b = xform(scene.vertex_pos[vidx[:, 1]])
    c = xform(scene.vertex_pos[vidx[:, 2]])

    # Pluecker edge columns [p x q ; q - p] for edges (a,b), (b,c), (c,a)
    def edge(p, q):
        return torch.cat([cross3(p, q), q - p], dim=-1)  # (Tw, 6)

    e_ab, e_bc, e_ca = edge(a, b), edge(b, c), edge(c, a)
    n = cross3(b - a, c - a)
    d_plane = dot3(n, a)

    # shading normal: inverse-transpose of the model 3x3 applied to the
    # averaged vertex normal (Renderer.cpp:203,397 + utility.h:82-88)
    inv_t = inv3x3(scene.model_to_world[:, :3, :3]).transpose(1, 2)
    navg = (
        scene.vertex_nrm[vidx[:, 0]] + scene.vertex_nrm[vidx[:, 1]] + scene.vertex_nrm[vidx[:, 2]]
    ) * (1.0 / 3.0)
    x_axis = torch.tensor([1.0, 0.0, 0.0], device=dev)
    navg = torch.where(src_valid > 0, navg, x_axis)
    shade_n = normalize_guarded(_matvec(inv_t[mdl], navg))

    mat_type = scene.mat_type[mdl]
    mat_color = scene.mat_color[mdl]
    mat_ri = (
        scene.mat_refractive_index[mdl]
        if scene.mat_refractive_index is not None
        else torch.full(mdl.shape, 1.5, device=dev)
    )

    # (fat | small-by-Morton | padding) order: triangles longer than 15%
    # of the scene diagonal (the enclosing-box walls) get their own leading
    # block(s) so they do not poison the Morton blocks' AABBs, and seed
    # every ray's best t on the first visit.  Exact-t ties resolve to the
    # lowest index IN THIS ORDER in every engine.
    centroid = (a + b + c) * (1.0 / 3.0)
    valid_row = src_valid > 0
    scene_lo = torch.where(valid_row, centroid, F_MAX).amin(dim=0)
    scene_hi = torch.where(valid_row, centroid, -F_MAX).amax(dim=0)
    code = _morton3(centroid, scene_lo, scene_hi)
    tmin_ = torch.minimum(torch.minimum(a, b), c)
    tmax_ = torch.maximum(torch.maximum(a, b), c)
    diag_t = _norm(tmax_ - tmin_)
    diag_s = _norm(torch.clamp(scene_hi - scene_lo, min=1e-30))
    fat = diag_t > 0.15 * diag_s
    klass = torch.where(
        src_valid[:, 0] > 0, torch.where(fat, 0, 1), 2
    ).to(torch.int32)
    perm = torch.argsort(code, stable=True)
    perm = perm[torch.argsort(klass[perm], stable=True)]
    (a, b, c, e_ab, e_bc, e_ca, n, d_plane, shade_n, mat_type, mat_color,
     mat_ri, src_valid, tri_model) = (
        x[perm]
        for x in (a, b, c, e_ab, e_bc, e_ca, n, d_plane, shade_n, mat_type,
                  mat_color, mat_ri, src_valid, mdl)
    )

    tw = a.shape[0]
    n_world_valid = int(scene.n_world_valid) or tw
    if not keeps_pack(tw):
        fused_tile = None
    t_pad = _round_up(tw, fused_tile or SUB_BLOCK)
    pad = t_pad - tw

    def padt(x, value=0.0):
        tail = torch.full((pad,) + tuple(x.shape[1:]), value, dtype=x.dtype, device=dev)
        return torch.cat([x, tail], dim=0)

    # the dense tracer's operands, JAX's layout: edge columns padded to 8
    # rows, (3, 8, T); the plane [n; d; 0...], (8, T).  edge_pluecker is a
    # view of edge_mat's first six rows, not a second copy.
    edge_mat = torch.cat(
        [torch.stack([padt(e_ab).T, padt(e_bc).T, padt(e_ca).T], dim=0),
         torch.zeros((3, 2, t_pad), device=dev)],
        dim=1,
    )
    edge_pluecker = edge_mat[:, 0:6]  # (3, 6, T)
    n_p, d_p = padt(n), padt(d_plane)
    plane_mat = torch.cat([n_p.T, d_p[None, :], torch.zeros((4, t_pad), device=dev)], dim=0)

    # per-128-triangle cluster AABBs; padding triangles contribute an
    # inverted box (min = +FMAX, max = -FMAX)
    valid_row = src_valid > 0
    tri_min = torch.where(valid_row, torch.minimum(torch.minimum(a, b), c), F_MAX)
    tri_max = torch.where(valid_row, torch.maximum(torch.maximum(a, b), c), -F_MAX)
    tri_min = torch.cat([tri_min, torch.full((pad, 3), F_MAX, device=dev)]).reshape(-1, SUB_BLOCK, 3)
    tri_max = torch.cat([tri_max, torch.full((pad, 3), -F_MAX, device=dev)]).reshape(-1, SUB_BLOCK, 3)
    cl_min = tri_min.amin(dim=1)  # (T/128, 3)
    cl_max = tri_max.amax(dim=1)
    # inflate spatially: the EPSILON-slack barycentric accept admits hit
    # points up to ~2*EPS*edge_length outside the triangle; the absolute
    # term is scene-scale relative
    diag = _norm(torch.clamp(cl_max - cl_min, min=0.0))[:, None]
    scene_diag = _norm(torch.clamp(scene_hi - scene_lo, min=0.0))
    pad_sp = 2.0 * EPS * diag + 1e-5 * scene_diag + 1e-6
    cl_min = cl_min - pad_sp
    cl_max = cl_max + pad_sp
    zeros2 = torch.zeros((cl_min.shape[0], 2), device=dev)
    cluster_aabb = torch.cat([cl_min.T, cl_max.T, zeros2.T], dim=0)  # (8, T/128)
    group_aabb = cluster_group_aabb(cluster_aabb, n_world_valid)

    fused_ops = ops_tri = block_aabb = attr_rows = sub_aabb = None
    if fused_tile is not None:
        nb = t_pad // fused_tile
        # fused (16, 4*T) pack: per block, columns [ab | bc | ca | plane];
        # edge columns in rows 0-5, the negated plane column [-n, -d] in
        # rows 6-9, so [d, o x d, o, -1, alive, 0...] . column is a side
        # value or t*det
        z10 = torch.zeros((10, t_pad), device=dev)
        q_edges = [torch.cat([edge_pluecker[k], z10], dim=0) for k in range(3)]
        z6 = torch.zeros((6, t_pad), device=dev)
        q_plane = torch.cat([z6, -n_p.T, -d_p[None, :], z6], dim=0)
        fused_ops = (
            torch.stack(q_edges + [q_plane], dim=0)  # (4, 16, T)
            .reshape(4, 16, nb, fused_tile)
            .permute(1, 2, 0, 3)  # (16, nb, 4, TB)
            .reshape(16, 4 * t_pad)
            .contiguous()
        )
        # the kernels take no gradient: the replay differentiates through
        # fused_ops in torch
        ops_tri = tri_major_ops(fused_ops.detach(), fused_tile)
        # per-block AABBs with the same slack; only the real blocks are
        # kept (an inverted box is always hit under the min/max-swapped
        # slab test)
        b_min = tri_min.reshape(nb, -1, 3).amin(dim=1)
        b_max = tri_max.reshape(nb, -1, 3).amax(dim=1)
        b_diag = _norm(torch.clamp(b_max - b_min, min=0.0))[:, None]
        b_pad = 2.0 * EPS * b_diag + 1e-5 * scene_diag + 1e-6
        block_aabb = torch.cat(
            [b_min - b_pad, b_max + b_pad, torch.zeros((nb, 2), device=dev)], dim=-1
        )  # (nb, 8)
        nb_real = -(-n_world_valid // fused_tile)
        block_aabb = block_aabb[:nb_real].contiguous()
        # 128-triangle sub-block AABBs, row-major; pure-padding rows are
        # NaN so every worklist comparison rejects them
        nsb_real = -(-n_world_valid // SUB_BLOCK)
        sub_aabb = torch.cat([cl_min, cl_max, zeros2], dim=-1)  # (nsb, 8)
        sub_row = torch.arange(sub_aabb.shape[0], device=dev)[:, None]
        sub_aabb = torch.where(sub_row < nsb_real, sub_aabb, torch.nan)

        # per-triangle attribute rows (16, T): [shade_n(0:3), mat_type(3),
        # rgb(4:7), geom_n(7:10), idx+1(10), refractive_index(11), 0(12:16)]
        geom_n = normalize_guarded(n)
        attr_rows = torch.cat(
            [
                padt(shade_n).T,
                padt(mat_type.to(torch.float32))[None, :],
                padt(mat_color).T,
                padt(geom_n).T,
                (torch.arange(t_pad, dtype=torch.float32, device=dev) + 1.0)[None, :],
                padt(mat_ri)[None, :],
                torch.zeros((4, t_pad), device=dev),
            ],
            dim=0,
        ).contiguous()  # (16, T)

    return WorldTriangles(
        edge_pluecker=edge_pluecker,
        edge_mat=edge_mat,
        plane_mat=plane_mat,
        plane_n=n_p,
        plane_d=d_p,
        cluster_aabb=cluster_aabb,
        group_aabb=group_aabb,
        shade_normal=padt(shade_n),
        mat_type=padt(mat_type).to(torch.int32),
        mat_color=padt(mat_color),
        mat_ri=padt(mat_ri, value=1.5),
        valid=padt(src_valid)[:, 0],
        v0=padt(a),
        e1=padt(b - a),
        e2=padt(c - a),
        tri_model=padt(tri_model).to(torch.int32),
        mat_table=scene.mat_color,
        fused_ops=fused_ops,
        ops_tri=ops_tri,
        block_aabb=block_aabb,
        attr_rows=attr_rows,
        sub_aabb=sub_aabb,
        tri_block=fused_tile or 0,
        n_valid=n_world_valid,
    )


def _trace_chunk(world: WorldTriangles, ro, rd_n):
    """Nearest hit of one chunk of rays (rd_n normalized) over the soup."""
    w = torch.cat([rd_n, cross3(ro, rd_n)], dim=-1)  # (n, 6)
    s_ab, s_bc, s_ca = (w @ world.edge_pluecker[e] for e in range(3))
    det = s_ab + s_bc + s_ca  # = dir . n
    parallel = det == 0.0
    inv_det = 1.0 / torch.where(parallel, 1.0, det)
    u = s_ca * inv_det  # weight of vertex b
    v = s_ab * inv_det  # weight of vertex c
    o_dot_n = ro @ world.plane_n.T
    t = (world.plane_d[None, :] - o_dot_n) * inv_det
    accept = (
        ~parallel
        & ~(u < -EPS)
        & ~(u > 1.0 + EPS)
        & ~(v < -EPS)
        & ~(u + v > 1.0 + EPS)
        & ~(t < -EPS)
        & (world.valid[None, :] > 0.0)
    )
    t_masked = torch.where(accept, t, F_MAX)
    best_t, idx = torch.min(t_masked, dim=1)
    return best_t, idx


def hit_record(world: WorldTriangles, t: torch.Tensor, idx: torch.Tensor) -> HitRecord:
    """Gather the hit attributes of triangle ``idx`` (>= 0) where ``t`` is
    a hit; misses get zeros (ri 1.5)."""
    hit = t < F_MAX
    h3 = hit[:, None]
    return HitRecord(
        t=t,
        normal=torch.where(h3, world.shade_normal[idx], 0.0),
        mat_type=torch.where(hit, world.mat_type[idx], 0),
        mat_color=torch.where(h3, world.mat_color[idx], 0.0),
        geom_normal=torch.where(h3, normalize_guarded(world.plane_n[idx]), 0.0),
        mat_ri=torch.where(hit, world.mat_ri[idx], 1.5),
    )


def trace_mxu(world: WorldTriangles, ro, rd, chunk_size: int = 8192) -> HitRecord:
    """Full-scene nearest hit for a wavefront of world-space rays (the true
    nearest accepted triangle; exact-t ties to the lowest index)."""
    rd_n = normalize(rd)
    ts, idxs = [], []
    for s0 in range(0, ro.shape[0], chunk_size):
        t, idx = _trace_chunk(world, ro[s0:s0 + chunk_size], rd_n[s0:s0 + chunk_size])
        ts.append(t)
        idxs.append(idx)
    return hit_record(world, torch.cat(ts), torch.cat(idxs))
