"""The operands and the sweep contract of the traversal kernels, on the CPU.

Kernels 1 to 4 (``csrc/trace_list.cu``, ``bounce.cu``, ``bounce_trace.cu``,
``megakernel.cu``) stage the bake's triangle-major pack ``ops_tri`` and stop
their sweep at the last real triangle.  These tests hold ``ops_tri`` to the
column formula of the fused pack (``csrc/common.cuh``) entry by entry and
rebuild ``fused_ops`` from it bit for bit, show that the padding columns the
sweep skips never win a nearest hit (fast and debug accept chains,
degenerate rays included), and check the wrappers' validations.  Kernel 5
(``csrc/nearest_hit.cu``) writes its runs in ``ops_tri``'s order from the
dense operands, and gates group boxes before cluster boxes: the staged
rows are held to ``ops_tri`` and the group gate to the cluster gate.  The
kernels themselves run on the card (``tests/test_torch_cuda.py``).  This
file imports no JAX.
"""

import numpy as np
import pytest
import torch

from pathtracerap_tpu_torch import build_cornell_box_scene, build_reference_scene
from pathtracerap_tpu_torch.kernels import _build
from pathtracerap_tpu_torch.kernels import megakernel as TM
from pathtracerap_tpu_torch.kernels import prof as KP
from pathtracerap_tpu_torch.kernels import trace as TT
from pathtracerap_tpu_torch.ops.math import normalize, normalize_rsqrt
from pathtracerap_tpu_torch.ops.rng import RNG_TILE
from pathtracerap_tpu_torch.ops.intersect import HitRecord
from pathtracerap_tpu_torch.ops.plucker import (
    CLUSTER_GROUP, SUB_BLOCK, bake_world_triangles, cluster_group_aabb, dense_runs, tri_major_ops,
)
from pathtracerap_tpu_torch.render.camera import generate_rays
from pathtracerap_tpu_torch.config import CameraConfig
from pathtracerap_tpu_torch.scene.build import SceneBuilder, make_box_mesh, make_sphere_mesh
from pathtracerap_tpu_torch.scene.types import Material, MaterialType as M
from pathtracerap_tpu_torch.utils.debug import degenerate_rays

CORNELL_CAM = CameraConfig(position=(0.0, 0.0, 150.0), plane_x=(-40.0, 40.0),
                           plane_y=(-40.0, 40.0), plane_z=100.0)


def _spheres(n_spheres: int, subdiv: int):
    b = SceneBuilder()
    sphere = b.add_mesh(make_sphere_mesh(30.0, subdiv))
    room = b.add_mesh(make_box_mesh((600.0, 600.0, 600.0)))
    b.add_instance(room, Material(M.DIFFUSE, (0.8, 0.8, 0.8)))
    for k in range(n_spheres):
        mat = Material(M.EMISSIVE if k == 4 else (M.METAL, M.DIFFUSE)[k % 2], (0.9, 0.5, 0.2))
        b.add_instance(sphere, mat, translate=(-160.0 + 80.0 * (k % 5), -60.0 + 100.0 * (k // 5),
                                               -100.0 - 20.0 * k))
    return b.build()


SCENES = {
    "reference": build_reference_scene,
    "cornell": build_cornell_box_scene,
    # nine spheres in a room: 17 blocks, the gated sweep of kernel 4
    "gated_17_blocks": lambda: _spheres(9, 16),
    # one 96-subdivision sphere in a room: above 64 blocks, block worklists
    "block_lists": lambda: _spheres(1, 96),
}


@pytest.fixture(scope="module")
def worlds():
    return {}


def _world(worlds, name):
    if name not in worlds:
        worlds[name] = bake_world_triangles(SCENES[name]().to_device("cpu"))
    return worlds[name]


def _column_formula(fused_ops, tri_block):
    """ops_tri as common.cuh's column formula reads it: triangle g's
    quadrant-q column is (g / TB) * 4 * TB + q * TB + g % TB; rows 0-5 of
    the three edge quadrants, rows 6-9 of the plane quadrant, two zeros."""
    t = fused_ops.shape[1] // 4
    g = torch.arange(t)
    base = (g // tri_block) * 4 * tri_block + g % tri_block
    cols = [fused_ops[row, base + q * tri_block] for q in range(3) for row in range(6)]
    cols += [fused_ops[row, base + 3 * tri_block] for row in range(6, 10)]
    cols += [torch.zeros(t), torch.zeros(t)]
    return torch.stack(cols, dim=1)


def _fused_from_tri_major(ops_tri, tri_block):
    """The inverse of tri_major_ops: the (16, 4 * T) fused pack, zero but
    for each triangle's 22 entries."""
    t = ops_tri.shape[0]
    q = torch.zeros((t, 4, 16))
    q[:, 0:3, 0:6] = ops_tri[:, 0:18].reshape(t, 3, 6)
    q[:, 3, 6:10] = ops_tri[:, 18:22]
    return q.reshape(t // tri_block, tri_block, 4, 16).permute(3, 0, 2, 1).reshape(16, 4 * t)


@pytest.mark.parametrize("name", list(SCENES))
def test_ops_tri_matches_column_formula(worlds, name):
    world = _world(worlds, name)
    ops = world.ops_tri
    assert ops.shape == (world.fused_ops.shape[1] // 4, 24) and ops.dtype == torch.float32
    assert ops.is_contiguous() and ops.data_ptr() % 16 == 0
    ref = _column_formula(world.fused_ops, world.tri_block)
    assert torch.equal(ops.view(torch.int32), ref.view(torch.int32))
    if name == "block_lists":
        assert world.block_aabb.shape[0] > TM.SUB_MAX_BLOCKS and not TM.use_sub_blocks(world)
    if name == "gated_17_blocks":
        assert world.block_aabb.shape[0] > TM.GATE_BLOCKS


@pytest.mark.parametrize("name", list(SCENES))
def test_ops_tri_rebuilds_fused_ops(worlds, name):
    """Every entry of fused_ops outside a triangle's 22 is zero, so the
    triangle-major pack loses nothing: its inverse is fused_ops bit for
    bit."""
    world = _world(worlds, name)
    back = _fused_from_tri_major(world.ops_tri, world.tri_block)
    assert torch.equal(back.view(torch.int32), world.fused_ops.view(torch.int32))


@pytest.mark.parametrize("fused_tile", [128, 256])
def test_ops_tri_rows_do_not_depend_on_block_width(worlds, fused_tile):
    """The bake's triangle order does not depend on the block width, so
    neither do the real triangles' rows; only the padding grows."""
    world = _world(worlds, "cornell")
    other = bake_world_triangles(build_cornell_box_scene().to_device("cpu"), fused_tile=fused_tile)
    nv = world.n_valid
    assert other.n_valid == nv and other.ops_tri.shape[0] % fused_tile == 0
    assert torch.equal(other.ops_tri[:nv], world.ops_tri[:nv])
    assert not other.ops_tri[nv:].any() and not world.ops_tri[nv:].any()
    assert torch.equal(other.ops_tri, tri_major_ops(other.fused_ops, fused_tile))


def test_world_without_pack_has_no_ops_tri():
    world = bake_world_triangles(build_cornell_box_scene().to_device("cpu"), fused_tile=None)
    assert world.fused_ops is None and world.ops_tri is None


def test_ops_tri_is_detached():
    """The replay differentiates through fused_ops; the kernels' copy
    carries no graph."""
    scene = build_cornell_box_scene().to_device("cpu")
    scene = scene.replace(vertex_pos=scene.vertex_pos.clone().requires_grad_(True))
    world = bake_world_triangles(scene)
    assert world.fused_ops.requires_grad and not world.ops_tri.requires_grad
    assert torch.equal(world.ops_tri, tri_major_ops(world.fused_ops.detach(), world.tri_block))


def _sweep_rays(world, camera, res):
    """Camera rays plus degenerate ones: the debug-mode set (in a
    triangle's plane, grazing, from its surface, nearly parallel, near-zero
    direction), axis-aligned rays from the origin and from the camera,
    rays through the origin, and a zero-length direction (rsqrt-normalized,
    as the kernels' state_ray does)."""
    ro, rd = generate_rays(camera, res, device="cpu")
    dro, drd = degenerate_rays(world)
    axes = torch.cat([torch.eye(3), -torch.eye(3)])
    cam = torch.tensor(camera.position, dtype=torch.float32).expand(6, 3)
    thru = torch.tensor([[1.0, 2.0, 3.0], [-4.0, 0.5, 2.0]])
    w_main = TT.ray_vectors(torch.cat([ro, torch.zeros(6, 3), cam, -50.0 * thru]),
                            normalize(torch.cat([rd, axes, axes, thru])))
    pack = torch.cat([torch.cat([dro, torch.zeros(1, 3)]),
                      torch.cat([drd, torch.zeros(1, 3)]),
                      torch.ones(6, 3), torch.full((6, 1), 4.0)], dim=1)
    w_deg = TT.ray_vectors(pack[:, 0:3], normalize_rsqrt(pack[:, 3:6]))
    return torch.cat([w_main, w_deg])


@pytest.mark.parametrize("debug", [False, True], ids=["fast", "debug"])
@pytest.mark.parametrize("name", ["cornell", "reference", "block_lists"])
def test_padding_cut_is_exact(worlds, name, debug):
    """The sweep over the first n_valid triangles gives the full sweep's t
    and index bit for bit: a padding column (all zero: det = 0, t = NaN)
    is never accepted, in the fast or the debug accept chain.  The Cornell
    box's one block holds 48 real triangles, the 72-block world's last
    block 140."""
    world = _world(worlds, name)
    cam = CORNELL_CAM if name == "cornell" else CameraConfig()
    w = _sweep_rays(world, cam, (12, 8) if name == "block_lists" else (24, 16))
    nb, tb, nv = world.block_aabb.shape[0], world.tri_block, world.n_valid
    assert nv < nb * tb  # the last block holds padding
    s = w @ world.fused_ops[:, :nb * 4 * tb]  # (R, nb * 4 * TB)
    t_full, i_full = TT.accept_nearest(s, tb, debug)
    s_cut = s.reshape(-1, nb, 4, tb).permute(0, 2, 1, 3).reshape(-1, 4, nb * tb)[:, :, :nv]
    t_cut, i_cut = TT.accept_nearest(s_cut.reshape(-1, 4 * nv), nv, debug)
    assert torch.equal(t_cut.view(torch.int32), t_full.view(torch.int32))
    assert torch.equal(i_cut, i_full)
    assert (i_full < nv).all() and (i_full >= 0).sum() > 0
    # and the plain version of kernels 1, 2 and 4 agrees with both
    t_p, i_p = TT.nearest_hit_fused_plain(w, world.fused_ops, nb, tb, debug)
    assert torch.equal(t_p.view(torch.int32), t_full.view(torch.int32))
    assert torch.equal(i_p.long(), i_full)


# --------------------------------------------------------------------------
# kernel 1's worklists split over thread blocks
# --------------------------------------------------------------------------


def _merge_key(t, idx):
    """csrc/common.cuh's merge_key before its inversion: the order of t
    (-0.0 as +0.0) above the index above a flag for -0.0; the smallest key
    is the best hit.  The kernel's unsigned 64-bit key less 2^63, so that
    int64 orders it the same way."""
    b = t.view(torch.int32).long() & 0xFFFFFFFF
    neg = b >= 0x80000000
    ord_ = torch.where(neg, 0xFFFFFFFF - b, b | 0x80000000)
    ord_ = torch.where((b << 1) & 0xFFFFFFFF == 0, 0x80000000, ord_)
    return ((ord_ - 0x80000000) << 32) | (idx.long() << 1) | (b == 0x80000000).long()


def _merged_hit(key):
    """csrc/common.cuh's merged_hit: (t, idx int32) of the smallest
    keys; MISS_KEY is a miss."""
    ord_ = (key >> 32) + 0x80000000
    b = torch.where(ord_ >= 0x80000000, ord_ & 0x7FFFFFFF, 0xFFFFFFFF - ord_)
    b = torch.where(key & 1 == 1, 0x80000000, b)
    t = torch.where(b >= 0x80000000, b - (1 << 32), b).to(torch.int32).view(torch.float32)
    idx = ((key & 0xFFFFFFFF) >> 1).to(torch.int32)
    miss = key == MISS_KEY
    return torch.where(miss, TT.F_MAX, t), torch.where(miss, -1, idx)


MISS_KEY = (1 << 63) - 1


def _sweep_entries(w, fused_ops, tb, n_valid, entries, debug):
    """One thread block of kernel 1 on one chunk: the listed blocks in list
    order, each cut at n_valid, the best replaced on a smaller t or an
    equal finite t with a lower index (common.cuh sweep_rays)."""
    best = torch.full((w.shape[0],), TT.F_MAX)
    best_idx = torch.full((w.shape[0],), -1, dtype=torch.int64)
    for blk in entries:
        width = min(tb, n_valid - blk * tb)
        if width <= 0:
            continue
        s = (w @ fused_ops[:, blk * 4 * tb:(blk + 1) * 4 * tb]).reshape(-1, 4, tb)[:, :, :width]
        t, i = TT.accept_nearest(s.reshape(-1, 4 * width), width, debug)
        g = i + blk * tb
        better = (t < best) | ((t == best) & (t < TT.F_MAX) & (g < best_idx))
        best = torch.where(better, t, best)
        best_idx = torch.where(better, g, best_idx)
    return best, best_idx


def _chunked_trace(w, fused_ops, tb, n_valid, lists, ray_tile, chunk, debug=False):
    """Kernel 1's split over thread blocks: each tile's list cut into chunks
    of ``chunk`` entries, each chunk swept on its own, the chunks' bests
    merged by the smallest merge key (a list that fits one chunk is written
    directly)."""
    ts, idxs = [], []
    for tile in range(lists.shape[0]):
        wt = w[tile * ray_tile:(tile + 1) * ray_tile]
        entries = [int(b) for b in lists[tile] if b >= 0]
        parts = [_sweep_entries(wt, fused_ops, tb, n_valid, entries[j:j + chunk], debug)
                 for j in range(0, max(len(entries), 1), chunk)]
        if len(parts) == 1:
            t, i = parts[0]
            ts.append(t)
            idxs.append(i.to(torch.int32))
            continue
        key = torch.full((wt.shape[0],), MISS_KEY, dtype=torch.int64)
        for t, i in parts:
            key = torch.minimum(key, torch.where(i >= 0, _merge_key(t, i), MISS_KEY))
        t, i = _merged_hit(key)
        ts.append(t)
        idxs.append(i)
    return torch.cat(ts), torch.cat(idxs)


def _assert_bits(a, b):
    assert torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))
    assert torch.equal(a[1].to(torch.int32), b[1].to(torch.int32))


@pytest.mark.parametrize("debug", [False, True], ids=["fast", "debug"])
@pytest.mark.parametrize("chunk", [1, 2, 3, 6])
def test_chunked_trace_equals_one_pass(worlds, chunk, debug):
    """The reference scene's 6 blocks swept in chunks of 1, 2, 3 and all
    6 entries and merged give the one-pass plain version bit for bit:
    over full worklists in a shuffled order on every ray (degenerate rays
    included), and over the tmin-sorted worklists on the live rays."""
    world = _world(worlds, "reference")
    nb, tb, nv = world.block_aabb.shape[0], world.tri_block, world.n_valid
    tile = 64
    w = _sweep_rays(world, CameraConfig(), (16, 16))
    w = torch.cat([w, w[:(-w.shape[0]) % tile]])
    one = TT.nearest_hit_fused_plain(w, world.fused_ops, nb, tb, debug)
    g = torch.Generator().manual_seed(chunk)
    full = torch.stack([torch.randperm(nb, generator=g) for _ in range(w.shape[0] // tile)])
    _assert_bits(_chunked_trace(w, world.fused_ops, tb, nv, full, tile, chunk, debug), one)

    ro, rd = generate_rays(CameraConfig(), (32, 16), device="cpu")
    w16, lists = TT.primary_inputs(world, ro, rd)
    assert (lists >= 0).sum(dim=1).max() > chunk or chunk == nb
    t, i = _chunked_trace(w16, world.fused_ops, tb, nv, lists, TT.RAY_TILE, chunk, debug)
    t_p, i_p = TT.nearest_hit_fused_plain(w16, world.fused_ops, nb, tb, debug)
    n = ro.shape[0]
    _assert_bits((t[:n], i[:n]), (t_p[:n], i_p[:n]))


def _tie_world(tb: int = 128, nb: int = 3):
    """A hand-built fused pack of ``nb`` blocks of ``tb`` triangles and the
    ray d = (1, 0, 0) from the origin.  Triangle A (side values 0.25,
    0.25, 0.5, t * det = 0) is hit at t = +0.0, its negation A' at t =
    -0.0 (u, v the same); C (t * det = 2) at t = 2.0.  Returns (the pack,
    a function placing a triangle at a global index, the ray vectors)."""
    ops = torch.zeros((16, 4 * tb * nb))

    def place(g, tri):
        col = (g // tb) * 4 * tb + g % tb
        for q, val in enumerate(tri[:3]):
            ops[0, col + q * tb] = val  # row 0 pairs with d.x
        ops[9, col + 3 * tb] = tri[3]  # row 9 pairs with the ray's -1

    w = torch.zeros((tb, 16))
    w[:, 0] = 1.0
    w[:, 9] = -1.0
    return ops, place, w


A, A_NEG, C = (0.25, 0.25, 0.5, 0.0), (-0.25, -0.25, -0.5, -0.0), (0.25, 0.25, 0.5, -2.0)


@pytest.mark.parametrize("first, second, want", [
    # equal t = 2.0 either side of a chunk boundary: the lower index wins
    ((C, 5), (C, 128 + 7), (2.0, 5)),
    ((C, 128 + 7), (C, 260), (2.0, 135)),
    # -0.0 and +0.0 tie as the sweep ties them: the lower index, its own zero
    ((A, 3), (A_NEG, 128 + 1), (0.0, 3)),
    ((A_NEG, 2), (A, 128 + 5), (-0.0, 2)),
    ((A_NEG, 128 + 9), (A, 256 + 1), (-0.0, 137)),
], ids=["t2-low-first", "t2-blocks-1-2", "plus-zero-low", "minus-zero-low", "minus-zero-mid"])
@pytest.mark.parametrize("chunk", [1, 2, 3])
def test_chunk_merge_keeps_tie_order(first, second, want, chunk):
    """Hand-built exact-t ties between blocks: split over chunks (in both
    list orders) the merge gives the one-pass result, the lower index
    with its own t bits (a -0.0 stays -0.0)."""
    ops, place, w = _tie_world()
    for tri, g in (first, second):
        place(g, tri)
    one = TT.nearest_hit_fused_plain(w, ops, 3, 128)
    want_t = torch.tensor(want[0])
    assert torch.equal(one[0].view(torch.int32), want_t.expand(128).view(torch.int32))
    assert (one[1] == want[1]).all()
    for order in ([0, 1, 2], [2, 1, 0], [1, 2, 0]):
        lists = torch.tensor([order], dtype=torch.int32)
        _assert_bits(_chunked_trace(w, ops, 128, 3 * 128, lists, 128, chunk), one)


def test_merge_key_orders_hits():
    """The merge key orders hits as the one-pass sweep's improve rule: by
    t, -0.0 equal to +0.0, then by index; and decodes to the same bits."""
    t = torch.tensor([-0.005, -0.0, 0.0, 0.0, -0.0, 1e-30, 1.5, 1.5, 9999998.0])
    i = torch.tensor([7, 4, 3, 9, 1, 0, 2, 8, 5], dtype=torch.int32)
    key = _merge_key(t, i)
    order = torch.argsort(key)
    assert order.tolist() == [0, 4, 2, 1, 3, 5, 6, 7, 8]
    back_t, back_i = _merged_hit(key)
    assert torch.equal(back_t.view(torch.int32), t.view(torch.int32)) and torch.equal(back_i, i)


# --------------------------------------------------------------------------
# kernel 2's worklists split over thread blocks: the chunk rule
# --------------------------------------------------------------------------


def _binned_shapes(world, samples: int):
    """(unit, list width, tiles) of the binned engine's kernel-2 launches
    on ``world``, for a slab of ``samples`` samples."""
    sub = TM.use_sub_blocks(world)
    unit = TM.SUB_BLOCK if sub else world.tri_block
    lw = (world.sub_aabb if sub else world.block_aabb).shape[0]
    nt = samples * TM.BINNED_SLAB_TILES * RNG_TILE // TM.binned_ray_tile(world)
    return unit, lw, nt


def _chunks(lw: int, chunk: int) -> int:
    """Chunks a tile in kernel 2's grid: ptt_bounce's ceil(lw / chunk),
    one for an empty list."""
    return -(-lw // chunk) if lw else 1


@pytest.mark.parametrize("samples", [1, 4])
def test_bounce_chunk_keeps_the_reference_lists_whole(worlds, samples):
    """The reference scene's sub-block lists (32 entries of 128 triangles,
    in 256-ray tiles) are no longer kept whole: they split into chunks of
    4 sub-blocks, 8 a tile, which beat one thread block a tile on every
    bounce on the card (PERF.md)."""
    unit, lw, nt = _binned_shapes(_world(worlds, "reference"), samples)
    assert (unit, lw) == (SUB_BLOCK, 32)
    chunk = TM.bounce_chunk(unit, lw, nt)
    assert (chunk, _chunks(lw, chunk)) == (4, 8)
    assert chunk * unit == TM.BOUNCE_CHUNK_TRIS


@pytest.mark.parametrize("samples", [1, 4])
@pytest.mark.parametrize("blocks", [None, 293], ids=["block_lists", "highpoly"])
def test_bounce_chunk_splits_long_block_lists(worlds, samples, blocks):
    """Block lists above 64 blocks (a 96-subdivision sphere's, and the
    highpoly configuration's 293 blocks of 512 in 512-ray tiles) split
    into chunks of at least BOUNCE_CHUNK_TRIS triangles, within the
    launch's cap on thread blocks."""
    unit, lw, nt = _binned_shapes(_world(worlds, "block_lists"), samples)
    assert unit == 512 and lw > TM.SUB_MAX_BLOCKS
    if blocks is not None:
        lw = blocks
    chunk = TM.bounce_chunk(unit, lw, nt)
    chunks = _chunks(lw, chunk)
    assert chunks > 1 and chunk * unit >= TM.BOUNCE_CHUNK_TRIS
    assert nt * chunks <= TM.BOUNCE_MAX_BLOCKS
    if blocks == 293 and samples == 1:  # the highpoly-render cell's launches
        assert (nt, chunk, chunks) == (256, 3, 98)


@pytest.mark.parametrize("lw", [0, 1, 3, 4, 5, 7, 16, 17, 293, 701, 100_000, 10_000_000])
def test_bounce_chunk_stays_in_the_grid(lw):
    """For any shapes the rule gives a chunk of 1 to lw entries whose grid
    ptt_bounce launches: at most 65,535 chunks a tile (CUDA's gridDim.y;
    the card's tests hold the launch's refusal above it), and where a list
    splits, at most BOUNCE_MAX_BLOCKS thread blocks; a list of at most
    BOUNCE_CHUNK_TRIS triangles stays whole."""
    assert TM.BOUNCE_MAX_BLOCKS <= 65535
    for unit in (SUB_BLOCK, 512):
        for nt in (1, 16, 256, 2048, 1 << 20):
            chunk = TM.bounce_chunk(unit, lw, nt)
            assert 1 <= chunk <= max(lw, 1)
            chunks = _chunks(lw, chunk)
            assert chunks <= 65535
            assert chunks == 1 or nt * chunks <= TM.BOUNCE_MAX_BLOCKS
            if lw * unit <= TM.BOUNCE_CHUNK_TRIS:
                assert chunks == 1


@pytest.mark.parametrize("source, name, value", [
    ("trace_list.cu", "kRays", TT.TRACE_LIST_RAYS),
    ("trace_list.cu", "kChunk", TT.TRACE_LIST_CHUNK),
    ("trace_list.cu", "kSweepRun", TT.SWEEP_RUN),
    ("bounce.cu", "kRays", TM.BOUNCE_RAYS_PER_THREAD),
    ("bounce.cu", "kSweepRun", TM.SWEEP_RUN),
    ("megakernel.cu", "kSweepRun", TM.SWEEP_RUN),
    ("megakernel.cu", "kFusedTile", TM.FUSED_TILE),
    ("bounce_trace.cu", "kRays", TM.BOUNCE_TRACE_RAYS_PER_THREAD),
    ("bounce_trace.cu", "kSweepRun", TM.SWEEP_RUN),
    ("nearest_hit.cu", "kRays", TT.DENSE_RAYS),
    ("nearest_hit.cu", "kGroup", CLUSTER_GROUP),
    ("nearest_hit.cu", "kTile", TT.DENSE_TILE),
    ("nearest_hit.cu", "kRun", TT.DENSE_RUN),
    ("prof_parts.cu", "kTile", KP.PARTS_TILE),
    ("prof_parts.cu", "kStageBytes", KP.PARTS_STAGE_BYTES),
    ("prof_parts.cu", "kSelectRows", KP.SELECT_ROWS),
])
def test_wrapper_constants_match_kernel_sources(source, name, value):
    """The wrappers size launches and validate inputs with copies of the
    kernels' compile-time constants: each copy equals its source's."""
    import re

    text = (_build.CSRC / source).read_text()
    (found,) = re.findall(rf"constexpr int {name} = (\d+);", text)
    assert int(found) == value


def test_pair_counter_needs_the_kernel(worlds):
    """Kernel 4's pair counter counts the kernel's sweep: the plain
    version on CPU tensors has none to give, so asking for it raises."""
    world = _world(worlds, "cornell")
    n = TT.RAY_TILE
    with pytest.raises(ValueError, match="pairs counts the kernel's sweep"):
        TM.sample_fused(torch.zeros((n, 16)), torch.zeros((n, 16)), torch.zeros((n, 8)), world, 2,
                        True, True, pairs=torch.zeros((n // TM.FUSED_TILE, 2), dtype=torch.int64))


def test_sweep_operands_need_ops_tri(worlds):
    import dataclasses

    world = dataclasses.replace(_world(worlds, "cornell"), ops_tri=None)
    with pytest.raises(ValueError, match="ops_tri is None"):
        TM.sweep_operands(world)


def test_sweep_operands_need_16_byte_alignment(worlds):
    import dataclasses

    world = _world(worlds, "cornell")
    t = world.ops_tri.shape[0]
    flat = torch.empty(t * 24 + 1)
    shifted = flat[1:].view(t, 24)  # 4 bytes past an aligned allocation
    shifted.copy_(world.ops_tri)
    with pytest.raises(ValueError, match="16-byte aligned"):
        TM.sweep_operands(dataclasses.replace(world, ops_tri=shifted))
    with pytest.raises(ValueError, match=r"\(T, 24\)"):
        TM.sweep_operands(dataclasses.replace(world, ops_tri=world.ops_tri[:, :22]))


def test_sweep_operands_stop_at_real_triangles(worlds):
    import dataclasses

    world = _world(worlds, "cornell")
    ops, n_tris = TM.sweep_operands(world)
    assert ops is world.ops_tri and n_tris == world.n_valid == 48  # scene/build.py:261
    _, n_unknown = TM.sweep_operands(dataclasses.replace(world, n_valid=0))
    assert n_unknown == ops.shape[0]


def test_kernel_resources_reads_ptxas_output():
    log = (
        "ptxas info    : Compiling entry function '_Z13bounce_kernelILi4ELb0EEvPKfS1_' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z13bounce_kernelILi4ELb0EEvPKfS1_\n"
        "    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads\n"
        "ptxas info    : Used 96 registers, 24576 bytes smem, 432 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_Z5emptyv' for 'sm_90a'\n"
        "ptxas info    : Used 4 registers, 352 bytes cmem[0]\n"
    )
    res = _build.kernel_resources(log)
    assert res["_Z13bounce_kernelILi4ELb0EEvPKfS1_"] == {
        "registers": 96, "spill_stores": 4, "spill_loads": 12, "smem": 24576}
    assert res["_Z5emptyv"] == {"registers": 4, "spill_stores": 0, "spill_loads": 0, "smem": 0}


def _may_accept(ab, bc, ca, num):
    """common.cuh's may_accept in float32 torch, operation by operation
    (fminf drops NaN, as torch.fmin does)."""
    det = (ab + bc) + ca
    sgn = torch.where(torch.signbit(det), -1.0, 1.0)
    bound = torch.tensor(-0.006, dtype=torch.float32) * det.abs()
    lo = torch.fmin(torch.fmin(ab * sgn, bc * sgn), torch.fmin(ca * sgn, num * sgn))
    return lo >= bound


def _accepts(ab, bc, ca, num):
    """common.cuh's accept_t (fast form): whether the chain accepts."""
    det = (ab + bc) + ca
    inv = 1.0 / det
    t, u, v = num * inv, ca * inv, ab * inv
    return (u >= -0.005) & (v >= -0.005) & (t >= -0.005) & (u <= 1.005) & (u + v <= 1.005)


@pytest.mark.parametrize("case", ["boundary", "random"])
def test_may_accept_never_rejects_an_accepted_pair(case):
    """The division-free test kernels 2 and 4 run before the accept chain
    is conservative: every pair the chain accepts passes it.  Pairs are
    built around the chain's bounds (u, v, t at -0.005, u and u + v at
    1.005, by a few ulps) at determinants from 2^-135 to 2^127, and at
    random."""
    g = np.random.default_rng(0 if case == "boundary" else 1)
    n = 2_000_000
    det = np.exp2(g.uniform(-135, 127, n)) * g.choice([-1.0, 1.0], n)
    if case == "boundary":
        eps = g.uniform(-3e-7, 3e-7, (n, 3))
        u = g.choice([-0.005, 1.005, 0.3], n) + eps[:, 0]
        v = np.where(g.random(n) < 0.5, -0.005 + eps[:, 1], 1.005 - u + eps[:, 1])
        t = g.choice([-0.005, 0.0, 7.0], n) + eps[:, 2]
    else:
        u, v = g.uniform(-0.5, 1.5, n), g.uniform(-0.5, 1.5, n)
        t = g.uniform(-2.0, 50.0, n)
    ca, ab = u * det, v * det
    bc, num = det - ab - ca, t * det
    with np.errstate(over="ignore"):  # t * det beyond the float range is inf, as on the card
        ab, bc, ca, num = (torch.from_numpy(x.astype(np.float32)) for x in (ab, bc, ca, num))
    acc = _accepts(ab, bc, ca, num)
    assert acc.sum() > n // 20  # the cases reach the chain's bounds
    assert not (acc & ~_may_accept(ab, bc, ca, num)).any()
    if case == "random":  # and the test rejects most of what the chain rejects
        assert (~_may_accept(ab, bc, ca, num) & ~acc).sum() > 0.5 * (~acc).sum()


# --------------------------------------------------------------------------
# kernel 5: the staged operands and the two-level gate
# --------------------------------------------------------------------------


def _dense_stage(edge_mat, plane_mat):
    """The (T, 24) rows kernel 5 writes into shared memory (csrc/nearest_hit.cu
    stage_dense, and the pads it zeroes): row r < 18 is edge_mat[r / 6, r % 6],
    rows 18-21 the negated plane_mat rows 0-3, then two zeros."""
    t = plane_mat.shape[1]
    rows = [edge_mat[r // 6, r % 6] for r in range(18)] + [-plane_mat[r] for r in range(4)]
    return torch.stack(rows + [torch.zeros(t), torch.zeros(t)], dim=1)


@pytest.mark.parametrize("name", ["reference", "cornell", "gated_17_blocks"])
def test_dense_stage_order_equals_ops_tri(worlds, name):
    """On a world baked with a pack, kernel 5's staged rows are ops_tri's
    bit for bit (the plane negated as the fused pack negates it, -0.0
    included), pads zero; so sweep_rays computes kernel 5's sums with the
    fmaf chains of kernels 1 to 4."""
    world = _world(worlds, name)
    staged = _dense_stage(world.edge_mat, world.plane_mat)
    assert torch.equal(staged[:, :22].view(torch.int32), world.ops_tri[:, :22].view(torch.int32))
    assert torch.equal(staged[:, 22:].view(torch.int32), torch.zeros_like(staged[:, 22:]).view(torch.int32))


def test_bake_fills_group_boxes():
    """The bake makes kernel 5's group boxes once, from the detached
    cluster boxes of its real clusters: each contains its members."""
    scene = build_reference_scene().to_device("cpu")
    scene = scene.replace(vertex_pos=scene.vertex_pos.clone().requires_grad_(True))
    world = bake_world_triangles(scene, fused_tile=None)
    runs = dense_runs(world.plane_mat.shape[1], world.n_valid)
    assert not world.group_aabb.requires_grad
    assert torch.equal(world.group_aabb, cluster_group_aabb(world.cluster_aabb, world.n_valid))
    assert world.group_aabb.shape == (8, -(-runs // CLUSTER_GROUP))
    g = torch.arange(runs) // CLUSTER_GROUP
    box = world.cluster_aabb.detach()[:, :runs]
    assert (world.group_aabb[0:3, g] <= box[0:3]).all() and (world.group_aabb[3:6, g] >= box[3:6]).all()


def _gate_case(scale: float, case: str, seed: int = 0):
    """Seeded f32 cluster boxes (8, M) of a scene 10 units wide at ``scale``
    (1e5: a million units, under FLOAT_MAX's 1e7) and the runs the gate
    walks, and rays: ("cut") a last group cut at runs < M; ("padding")
    every cluster walked (n_valid unknown), the last ones padding's
    inverted boxes; ("mixed") inverted boxes among real ones."""
    g = np.random.default_rng(seed)
    m = CLUSTER_GROUP * 13
    # consecutive clusters lie near each other, as the bake's Morton order
    # places them, so that group boxes are tight
    near = CLUSTER_GROUP // 2
    c = (np.repeat(g.uniform(-5, 5, (m // near, 3)), near, axis=0) + g.uniform(-0.4, 0.4, (m, 3))) * scale
    h = np.exp(g.uniform(np.log(0.0025), np.log(0.3), (m, 3))) * scale
    lo, hi = (c - h).astype(np.float32), (c + h).astype(np.float32)
    runs = m
    if case == "cut":
        runs = m - 5
    elif case == "padding":
        lo[-21:], hi[-21:] = 9999999.0, -9999999.0
    elif case == "mixed":
        k = g.choice(m, 9, replace=False)
        lo[k], hi[k] = 9999999.0, -9999999.0
    box = torch.from_numpy(np.concatenate([lo.T, hi.T, np.zeros((2, m), np.float32)]))
    n = 384
    ro = g.uniform(-7.5, 7.5, (n, 3)) * scale
    # two rays in three aim at a cluster, the others go anywhere
    d = np.where((np.arange(n) % 3 != 0)[:, None], c[g.integers(0, runs, n)] - ro,
                 g.normal(size=(n, 3)))
    d /= np.linalg.norm(d, axis=1, keepdims=True)  # unit directions, as the kernel's rays
    d[::7, 0] = 0.0  # axis-parallel rays and near-zero components hit the clamp
    d[1::7, 1] = 1e-13
    d[2::7, 2] = -3e-13
    best = np.where(g.random(n) < 0.3, 9999999.0, g.uniform(0, 15, n) * scale)
    best[::11] = 0.0
    f32 = (lambda x: torch.from_numpy(np.asarray(x, np.float32)))
    return box, runs, f32(ro), f32(d), f32(best)


@pytest.mark.parametrize("case", ["cut", "padding", "mixed"])
@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3, 1e5])
def test_group_gate_is_conservative(scale, case):
    """Every (ray, cluster) the per-cluster slab test admits lies in a group
    that the same test admits on the union box, at the same best t, in f32,
    at scales from 1e-3 to 1e5, with inverted padding boxes and a last group
    cut at runs; and the group test does reject (it is not trivially true)."""
    box, runs, ro, d, best = _gate_case(scale, case)
    margin = TT._cluster_margin(box)
    groups = cluster_group_aabb(box, runs * SUB_BLOCK)
    flat = TT.slab_reaches(box[:6, :runs], ro, d, margin, best)  # (N, runs)
    grp = TT.slab_reaches(groups[:6], ro, d, margin, best)  # (N, groups)
    member_group = torch.arange(runs) // CLUSTER_GROUP
    assert flat.any() and not flat.all()
    assert not (flat & ~grp[:, member_group]).any()
    assert not grp.all()
    # each group box is its members' union, or infinite where a member's box is inverted
    for k in range(groups.shape[1]):
        members = box[:6, k * CLUSTER_GROUP:min((k + 1) * CLUSTER_GROUP, runs)]
        if (members[0:3] > members[3:6]).any():
            assert torch.isinf(groups[:6, k]).all()
        else:
            assert torch.equal(groups[0:3, k], members[0:3].amin(dim=1))
            assert torch.equal(groups[3:6, k], members[3:6].amax(dim=1))


def _gate_walk(box, groups, runs, ro, d, margin, hit_t, two_level: bool):
    """A tile's gate walk as kernel 5 makes it, the sweep of an admitted run
    modelled by each ray's best falling to ``hit_t`` (N, runs) of that run:
    (swept runs, group tests, cluster tests)."""
    best = torch.full((ro.shape[0],), 9999999.0)
    swept, n_group, n_cluster = [], 0, 0
    for gi in range(-(-runs // CLUSTER_GROUP)):
        members = range(gi * CLUSTER_GROUP, min((gi + 1) * CLUSTER_GROUP, runs))
        if two_level:
            n_group += 1
            if not TT.slab_reaches(groups[:6, gi:gi + 1], ro, d, margin, best).any():
                continue
        for c in members:
            n_cluster += 1
            if TT.slab_reaches(box[:6, c:c + 1], ro, d, margin, best).any():
                swept.append(c)
                best = torch.minimum(best, hit_t[:, c])
    return swept, n_group, n_cluster


@pytest.mark.parametrize("case", ["cut", "padding", "mixed"])
@pytest.mark.parametrize("scale", [1e-3, 1e5])
def test_group_gate_sweeps_the_flat_gates_runs(scale, case):
    """A tile of 64 rays walked with the two-level gate sweeps exactly the
    runs the per-cluster gate sweeps, the bests falling as runs are swept,
    and tests fewer boxes where groups are rejected."""
    box, runs, ro, d, _ = _gate_case(scale, case, seed=3)
    ro, d = ro[:64], d[:64]
    g = np.random.default_rng(4)
    hit_t = torch.from_numpy(np.where(g.random((64, runs)) < 0.2, g.uniform(0, 20, (64, runs)) * scale,
                                      9999999.0).astype(np.float32))
    margin = TT._cluster_margin(box)
    groups = cluster_group_aabb(box, runs * SUB_BLOCK)
    flat, _, flat_tests = _gate_walk(box, groups, runs, ro, d, margin, hit_t, False)
    two, n_group, n_cluster = _gate_walk(box, groups, runs, ro, d, margin, hit_t, True)
    assert two == flat and 0 < len(flat) < runs
    assert flat_tests == runs and n_cluster <= runs


def test_hit_record_miss_device():
    """HitRecord.miss lands on the card unless the caller asks for the CPU."""
    import inspect

    assert inspect.signature(HitRecord.miss).parameters["device"].default == "cuda"
    rec = HitRecord.miss(5, "cpu")
    assert rec.t.device.type == "cpu" and (rec.t == 9999999.0).all() and not rec.hit.any()
    assert rec.normal.shape == (5, 3) and rec.mat_type.dtype == torch.int32
