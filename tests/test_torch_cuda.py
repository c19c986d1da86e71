"""The CUDA kernels against their plain PyTorch versions, on the GPU.

A CUDA kernel has no CPU mode, so these tests skip where no GPU is
present (kernels 1 to 5, kernels 1 and 2 above 313 blocks, the train
steps on the card against CPU tensors).  On the GPU machine (which has no
JAX, so the JAX conftest is left out):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

This file imports no JAX.
"""

import os

import numpy as np
import pytest
import torch

from pathtracerap_tpu_torch import (
    CameraConfig, RenderConfig, Renderer, build_cornell_box_scene, build_reference_scene, read_bmp,
)
from pathtracerap_tpu_torch.kernels import megakernel as TM
from pathtracerap_tpu_torch.kernels import trace as TT
from pathtracerap_tpu_torch.ops.math import normalize, normalize_rsqrt
from pathtracerap_tpu_torch.ops.plucker import bake_world_triangles
from pathtracerap_tpu_torch.ops.rng import chunk_jitter_uniforms, chunk_uniforms, prng_key
from pathtracerap_tpu_torch.render.camera import generate_rays

pytestmark = pytest.mark.cuda

# a camera inside the room of the suite's scenes, facing the sphere
INSIDE = dict(position=(0.0, 0.0, 190.0), plane_x=(-60.0, 60.0), plane_y=(-48.0, 48.0),
              plane_z=120.0)
GOLDEN = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "assets", "golden", "reference_scene.bmp",
)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def world(dev):
    return bake_world_triangles(build_reference_scene().to_device(dev))


def test_trace_list_kernel_matches_plain(dev, world):
    ro, rd = generate_rays(CameraConfig(), (256, 128), device=dev)
    w16, lists = TT.primary_inputs(world, ro, rd)
    before = TT.nearest_hit_fused.launches
    t, idx = TT.nearest_hit_fused(w16, world, lists, TT.RAY_TILE)
    torch.cuda.synchronize()
    assert TT.nearest_hit_fused.launches == before + 1
    tp, ip = TT.nearest_hit_fused_plain(w16, world.fused_ops, world.block_aabb.shape[0], world.tri_block)
    same = idx == ip
    assert same.float().mean().item() >= 0.9999
    both = same & (ip >= 0)
    rel = ((t - tp).abs() / tp.abs().clamp_min(1e-30))[both]
    assert rel.max().item() <= 1e-5
    assert _bits_equal((t, idx), (tp, ip), w16[:, 10] > 0)


@pytest.fixture(scope="module")
def wavefront(dev, world):
    """Bounce 1 of a sorted 4-sample wavefront: (pack (N, 10), u (N, 4))."""
    ro, rd = generate_rays(CameraConfig(), (256, 128), device=dev)
    rd = normalize(rd)
    hits0 = TT.trace_pallas(world, ro, rd)
    pack, u_flat = TM.first_wavefront(world, ro, rd, hits0, prng_key(1, dev), 0, 4, ro.shape[0], 5, True, 0)
    pix = torch.arange(pack.shape[0], device=dev)
    pack, pix = TM.sort_wavefront(pack, pix, *TM.scene_morton_bounds(world.block_aabb))
    return pack, u_flat[:, 4:8][pix]


def _unsplit(world, pack, u, lists, unit, ray_tile, parity, debug=False):
    """Kernel 2 with each tile's whole worklist in one thread block: the
    launch without chunks or merge."""
    return TM._bounce_kernel(pack, u, lists, unit, world, ray_tile, parity, debug,
                             max(lists.shape[1], 1))


def _same_bounce(a, b, rows=None):
    """Two kernel-2 outputs (state, index) bit for bit (on ``rows``)."""
    (s, i), (sp, ip) = a, b
    if rows is not None:
        s, i, sp, ip = s[rows], i[rows], sp[rows], ip[rows]
    return torch.equal(s.view(torch.int32), sp.view(torch.int32)) and torch.equal(i, ip)


def _check_bounce(world, pack, u, lists, unit, ray_tile, parities=(True, False)):
    """Kernel 2 against its plain version: the state bit-equal on every
    ray (dead rays pass through), the index on live rays, -1 for the rays
    of a tile with no live ray; and bit-equal on every ray to its launch
    with each tile's whole list in one thread block."""
    live = pack[:, 9] > 0
    dead_tile = ~live.reshape(-1, ray_tile).any(dim=1).repeat_interleave(ray_tile)
    for parity in parities:
        ref, ridx = TM.bounce_plain(pack, u, world, parity)
        before = TM.bounce.launches
        out, idx = TM.bounce(pack, u, lists, unit, world, ray_tile, parity)
        torch.cuda.synchronize()
        assert TM.bounce.launches == before + 1
        assert torch.equal(out.view(torch.int32), ref.view(torch.int32))
        assert torch.equal(idx[live], ridx[live])
        assert (idx[dead_tile] == -1).all()
        assert _same_bounce((out, idx), _unsplit(world, pack, u, lists, unit, ray_tile, parity))


def test_bounce_kernel_matches_plain(dev, world, wavefront):
    """Sub-block worklists (128 triangles per entry), as the reference
    scene's main path runs them."""
    pack, u = wavefront
    ray_tile = TM.binned_ray_tile(world)
    lists, unit = TM.bounce_lists(world, TT._slab_margin(world.block_aabb), pack, ray_tile)
    assert unit == TM.SUB_BLOCK
    _check_bounce(world, pack, u, lists, unit, ray_tile)


def test_bounce_kernel_block_mode_matches_plain(dev, world, wavefront):
    """Block worklists (a whole ``tri_block`` per entry) in 512-ray tiles,
    the mode scenes above ``SUB_MAX_BLOCKS`` blocks take.  The kernel does
    not depend on the scene's size, so the reference scene's blocks serve."""
    pack, u = wavefront
    ray_tile = 512
    lists = TT._tile_block_lists(
        world.block_aabb, pack[:, 0:3], normalize_rsqrt(pack[:, 3:6]),
        (pack[:, 9:10] > 0.0).to(torch.float32), ray_tile, TT._slab_margin(world.block_aabb),
    )
    _check_bounce(world, pack, u, lists, world.tri_block, ray_tile)


def _check_bounce_trace(world, pack, lists, unit, ray_tile):
    """Kernel 3 against its plain version: t bits and index + 1 equal on
    every live ray, a miss (F_MAX, 0) on every ray of a tile with no live
    ray."""
    before = TM.bounce_trace.launches
    t, col1 = TM.bounce_trace(pack, lists, unit, world, ray_tile)
    torch.cuda.synchronize()
    assert TM.bounce_trace.launches == before + 1
    tp, cp = TM.bounce_trace_plain(pack, world, ray_tile)
    live = pack[:, 9] > 0
    assert _bits_equal((t, col1), (tp, cp), live)
    dead_tile = ~live.reshape(-1, ray_tile).any(dim=1).repeat_interleave(ray_tile)
    assert (col1[dead_tile] == 0).all() and (t[dead_tile] == 9999999.0).all()


def test_bounce_trace_kernel_matches_plain(dev, world, wavefront):
    """Kernel 3 on the sub-block worklists of the same sorted wavefront:
    the winner's index and t bit for bit on live rays, and a miss for dead
    tiles."""
    pack, _ = wavefront
    ray_tile = TM.binned_ray_tile(world)
    lists, unit = TM.bounce_lists(world, TT._slab_margin(world.block_aabb), pack, ray_tile)
    _check_bounce_trace(world, pack, lists, unit, ray_tile)


def test_train_step_on_gpu_matches_cpu(dev):
    """The mat_color loss and gradient at 32x16, 2 spp, 4 bounces through
    the kernels against the same on CPU tensors (the plain versions)."""
    from pathtracerap_tpu_torch.diff import extract_params, loss_and_grad, make_train_step

    out = {}
    for d in (dev, torch.device("cpu")):
        scene = build_reference_scene().to_device(d)
        target = torch.full((512, 3), 0.25, device=d)
        TT.nearest_hit_fused_plain.calls = TM.bounce_trace_plain.calls = 0
        out[d.type] = loss_and_grad(extract_params(scene), scene, target, prng_key(1, d),
                                    CameraConfig(), (32, 16), 2, 4, engine="fused")
        if d.type == "cuda":
            assert TT.nearest_hit_fused_plain.calls == TM.bounce_trace_plain.calls == 0
            step = make_train_step(scene, CameraConfig(), (32, 16), 2, 4, engine="fused")
            loss, new = step(extract_params(scene), target, prng_key(1, d))
            assert torch.equal(loss, out["cuda"][0])
    (l_g, g_g), (l_c, g_c) = out["cuda"], out["cpu"]
    np.testing.assert_allclose(l_g.item(), l_c.item(), rtol=1e-5)
    np.testing.assert_allclose(g_g["mat_color"].cpu().numpy(), g_c["mat_color"].numpy(),
                               rtol=1e-4, atol=1e-7)


def test_render_on_gpu_matches_golden(dev):
    cfg = RenderConfig(resolution=(100, 80), samples_per_pixel=4, max_bounces=5, engine="fused")
    r = Renderer(build_reference_scene().to_device(dev), cfg, device=dev)
    TT.nearest_hit_fused_plain.calls = TM.bounce_plain.calls = 0
    img = r.render(seed=5).cpu().numpy()
    assert TT.nearest_hit_fused_plain.calls == TM.bounce_plain.calls == 0
    assert np.isfinite(img).all()
    golden = read_bmp(GOLDEN).astype(np.float32) / 255.0

    def down(x, f):
        h, w, _ = x.shape
        return x.reshape(h // f, f, w // f, f, 3).mean(axis=(1, 3))

    a, b = down(img, 4), down(down(golden, 10), 4)
    assert float(np.abs(a - b).mean()) < 0.08
    assert float(np.corrcoef(a.ravel(), b.ravel())[0, 1]) > 0.9


CORNELL_CAM = CameraConfig(position=(0.0, 0.0, 150.0), plane_x=(-40.0, 40.0),
                           plane_y=(-40.0, 40.0), plane_z=100.0)  # bench_suite.py:109-112


def _fused_case(world, dev, camera, res, jitter: bool):
    """Kernel 4's inputs at ``res``: ray vectors (jittered per sample 0
    when ``jitter``), primary rows with their index + 1, 3 samples of
    5-bounce uniforms."""
    ro, rd = generate_rays(camera, res, device=dev)
    n = ro.shape[0]
    pad = (-n) % TT.RAY_TILE
    ro = torch.cat([ro, ro.new_zeros(pad, 3)])
    rd_raw = torch.cat([rd, rd.new_ones(pad, 3)])
    key = prng_key(6, dev)
    if jitter:
        ju = chunk_jitter_uniforms(key, 0, n, ro.shape[0])
        rd_raw = rd_raw + torch.cat([ju * 0.05, torch.zeros_like(ju[:, :1])], dim=1)
    rd_n = normalize(rd_raw)
    hits, idx = TT.trace_pallas(world, ro, rd_n, return_idx=True)
    prim = TM.primary_pack(hits, torch.where(hits.t < 9999999.0, idx + 1, 0))
    u = chunk_uniforms(key, range(3), 5, n, ro.shape[0]).reshape(3, ro.shape[0], 20)
    return TT.ray_vectors(ro, rd_n), prim, u


def _check_fused(world, w16, prim, u, parity, use_primary, emit_idx=False):
    """Kernel 4 against its plain version: the contribution bit-equal, and
    with emit_idx the index stream equal; with its pair counter the same
    output, and, where the sweep is not gated, every real triangle swept
    once for each live traced ray and bounce."""
    live = []
    ref = TM.sample_fused_plain(w16, prim, u, world, 5, parity, use_primary, emit_idx=emit_idx,
                                live=live)
    pairs = torch.zeros((w16.shape[0] // TM.FUSED_TILE, 2), dtype=torch.int64, device=w16.device)
    for count in (None, pairs):
        before = TM.sample_fused.launches
        out = TM.sample_fused(w16, prim, u, world, 5, parity, use_primary, emit_idx=emit_idx,
                              pairs=count)
        torch.cuda.synchronize()
        assert TM.sample_fused.launches == before + 1
        if emit_idx:
            (out, idx), (r, ridx) = out, ref
            assert idx.dtype == torch.int32 and idx.shape == (w16.shape[0], 5)
            assert torch.equal(idx, ridx)
        else:
            r = ref
        assert torch.equal(out.view(torch.int32), r.view(torch.int32))
    masks = torch.stack(live).reshape(-1, 5, w16.shape[0])
    traced = int((masks[:, 1:] if use_primary else masks).sum().item())
    _, n_tris = TM.sweep_operands(world)
    issued, live_pairs = pairs.sum(dim=0).tolist()
    assert live_pairs <= issued
    if world.block_aabb.shape[0] <= TM.GATE_BLOCKS:
        assert live_pairs == traced * n_tris
    else:  # the gate skips blocks, never a live ray of a swept one
        assert 0 < live_pairs <= traced * n_tris


def test_fused_kernel_primary_batched_matches_plain(dev):
    """The Cornell box's path: primary rows, a batch of 3 samples."""
    world = bake_world_triangles(build_cornell_box_scene().to_device(dev))
    w16, prim, u = _fused_case(world, dev, CORNELL_CAM, (64, 64), False)
    for parity in (True, False):
        _check_fused(world, w16, prim, u, parity, True)


def test_fused_kernel_traced_jittered_matches_plain(dev, world):
    """The quality render's path: jittered primaries traced in the kernel."""
    w16, prim, u = _fused_case(world, dev, CameraConfig(), (128, 64), True)
    _check_fused(world, w16, prim, u[0], False, False)


def test_fused_kernel_emit_idx_matches_plain(dev):
    world = bake_world_triangles(build_cornell_box_scene().to_device(dev))
    w16, prim, u = _fused_case(world, dev, CORNELL_CAM, (64, 64), False)
    _check_fused(world, w16, prim, u[0], True, True, emit_idx=True)


def test_fused_kernel_gated_sweep_matches_plain(dev):
    """Above 8 blocks the kernel gates each block on its AABB per tile (its
    sweeping threads over their compacted rays); the plain version sweeps
    every block.  Nine spheres in a room: 17 blocks."""
    from pathtracerap_tpu_torch.scene.build import SceneBuilder, make_box_mesh, make_sphere_mesh
    from pathtracerap_tpu_torch.scene.types import Material, MaterialType as M

    b = SceneBuilder()
    sphere = b.add_mesh(make_sphere_mesh(30.0, 16))
    room = b.add_mesh(make_box_mesh((600.0, 600.0, 600.0)))
    b.add_instance(room, Material(M.DIFFUSE, (0.8, 0.8, 0.8)))
    for k in range(9):
        mat = Material(M.EMISSIVE if k == 4 else (M.METAL, M.DIFFUSE)[k % 2], (0.9, 0.5, 0.2))
        b.add_instance(sphere, mat, translate=(-160.0 + 80.0 * (k % 5), -60.0 + 100.0 * (k // 5),
                                               -100.0 - 20.0 * k))
    world = bake_world_triangles(b.build().to_device(dev))
    assert world.block_aabb.shape[0] > TM.GATE_BLOCKS
    cam = CameraConfig(position=(0.0, 0.0, 280.0), plane_x=(-60.0, 60.0), plane_y=(-40.0, 40.0),
                       plane_z=200.0)
    w16, prim, u = _fused_case(world, dev, cam, (128, 64), True)
    _check_fused(world, w16, prim, u[0], False, False)


def test_cornell_step_on_gpu_matches_cpu(dev):
    """The emit_idx train step on the Cornell box at 32x16, 2 spp, 4
    bounces through kernels 1 and 4 against the same on CPU tensors."""
    from pathtracerap_tpu_torch.diff import extract_params, loss_and_grad

    out = {}
    for d in (dev, torch.device("cpu")):
        scene = build_cornell_box_scene().to_device(d)
        target = torch.full((512, 3), 0.25, device=d)
        TM.sample_fused_plain.calls = 0
        before = TM.sample_fused.launches
        out[d.type] = loss_and_grad(extract_params(scene), scene, target, prng_key(1, d),
                                    CORNELL_CAM, (32, 16), 2, 4, engine="fused")
        if d.type == "cuda":
            assert TM.sample_fused_plain.calls == 0 and TM.sample_fused.launches == before + 2
    (l_g, g_g), (l_c, g_c) = out["cuda"], out["cpu"]
    np.testing.assert_allclose(l_g.item(), l_c.item(), rtol=1e-5)
    np.testing.assert_allclose(g_g["mat_color"].cpu().numpy(), g_c["mat_color"].numpy(),
                               rtol=1e-4, atol=1e-7)


def _check_dense(world, ro, rd, alive=None, cull=True):
    """Kernel 5 against its plain version: equal indices on live rays (but
    for 1 in 10,000), t within rtol 1e-5."""
    w, wo = TT.dense_inputs(ro, rd, alive)
    args = (w, wo, world.edge_mat, world.plane_mat, world.cluster_aabb)
    before = TT.nearest_hit.launches
    t, idx = TT.nearest_hit(*args, cull=cull, n_valid=world.n_valid, group_aabb=world.group_aabb)
    torch.cuda.synchronize()
    assert TT.nearest_hit.launches == before + 1
    tp, ip = TT.nearest_hit_plain(w, wo, world.edge_mat, world.plane_mat, world.n_valid)
    live = wo[:, 4] > 0
    same = (idx == ip) & live
    assert same.sum().item() >= 0.9999 * live.sum().item()
    both = same & (ip >= 0)
    assert ((t - tp).abs() / tp.abs().clamp_min(1e-30))[both].max().item() <= 1e-5
    return t, idx


def test_dense_kernel_matches_plain(dev):
    """The reference scene baked without a pack: the camera's primaries,
    culled and not, and bounce-like rays from inside the scene with a
    third of them dead."""
    world = bake_world_triangles(build_reference_scene().to_device(dev), fused_tile=None)
    assert world.fused_ops is None
    ro, rd = generate_rays(CameraConfig(), (256, 128), device=dev)
    for cull in (True, False):
        _check_dense(world, ro, rd, cull=cull)
    g = np.random.default_rng(0)
    ro = torch.tensor(g.uniform(-200, 200, (8192, 3)), dtype=torch.float32, device=dev)
    rd = torch.tensor(g.normal(size=(8192, 3)), dtype=torch.float32, device=dev)
    _check_dense(world, ro, rd, alive=torch.arange(8192, device=dev) % 3 != 0)


def test_dense_kernel_writes_misses_on_a_dead_wavefront(dev):
    """Kernel 5 on a wavefront with no live ray (the room camera's bounce
    2): every tile leaves at once, culled or not, with (F_MAX, -1) on
    every ray and no run swept or box tested."""
    world = bake_world_triangles(build_reference_scene().to_device(dev), fused_tile=None)
    ro, rd = generate_rays(CameraConfig(), (64, 32), device=dev)
    w, wo = TT.dense_inputs(ro, rd, torch.zeros(ro.shape[0], dtype=torch.bool, device=dev))
    nt = w.shape[0] // TT.DENSE_TILE
    for cull in (True, False):
        swept = torch.full((nt,), -1, dtype=torch.int32, device=dev)
        tests = torch.full((nt, 2), -1, dtype=torch.int32, device=dev)
        t, idx = TT.nearest_hit(w, wo, world.edge_mat, world.plane_mat, world.cluster_aabb,
                                cull=cull, n_valid=world.n_valid, swept=swept,
                                group_aabb=world.group_aabb, tests=tests)
        torch.cuda.synchronize()
        assert (t == 9999999.0).all() and (idx == -1).all()
        assert (swept == 0).all() and (tests == 0).all()


def _dense_world_and_rays(dev, camera, res, alive=None):
    from pathtracerap_tpu_torch.bench_suite import build_highpoly_scene

    world = bake_world_triangles(build_highpoly_scene(subdiv=224, use_asset=False).to_device(dev),
                                 fused_tile=None)
    ro, rd = generate_rays(camera, res, device=dev)
    return world, TT.dense_inputs(ro, rd, alive)


def test_dense_kernel_unculled_equals_plain(dev):
    """Kernel 5 without culling against its plain version: the index on
    every live ray of the reference scene (primaries and bounce-like rays,
    a third dead) and of a 200k-triangle sphere seen from inside the room,
    t within rtol 1e-5."""
    world = bake_world_triangles(build_reference_scene().to_device(dev), fused_tile=None)
    ro, rd = generate_rays(CameraConfig(), (256, 128), device=dev)
    cases = [(world, TT.dense_inputs(ro, rd))]
    g = np.random.default_rng(0)
    ro = torch.tensor(g.uniform(-200, 200, (8192, 3)), dtype=torch.float32, device=dev)
    rd = torch.tensor(g.normal(size=(8192, 3)), dtype=torch.float32, device=dev)
    cases.append((world, TT.dense_inputs(ro, rd, torch.arange(8192, device=dev) % 3 != 0)))
    cases.append(_dense_world_and_rays(dev, CameraConfig(**INSIDE), (64, 32)))
    for wld, (w, wo) in cases:
        t, idx = TT.nearest_hit(w, wo, wld.edge_mat, wld.plane_mat, wld.cluster_aabb, cull=False,
                                n_valid=wld.n_valid, group_aabb=wld.group_aabb)
        tp, ip = TT.nearest_hit_plain(w, wo, wld.edge_mat, wld.plane_mat, wld.n_valid)
        live = wo[:, 4] > 0
        assert torch.equal(idx[live], ip[live])
        both = live & (ip >= 0)
        assert ((t - tp).abs() / tp.abs().clamp_min(1e-30))[both].max().item() <= 1e-5


def test_dense_kernel_culled_inside_differs_only_on_phantoms(dev):
    """Kernel 5 with its gate from inside the room, where the rays meet a
    200k-triangle sphere: it differs from its plain version only on rays
    whose plain winner lies in a cluster box the ray's slab test does not
    reach (a phantom accept of a sliver triangle far from the ray)."""
    world, (w, wo) = _dense_world_and_rays(dev, CameraConfig(**INSIDE), (128, 64))
    t, idx = TT.nearest_hit(w, wo, world.edge_mat, world.plane_mat, world.cluster_aabb,
                            n_valid=world.n_valid, group_aabb=world.group_aabb)
    tp, ip = TT.nearest_hit_plain(w, wo, world.edge_mat, world.plane_mat, world.n_valid)
    live = wo[:, 4] > 0
    assert (ip[live] >= 0).float().mean().item() > 0.5
    differ = torch.nonzero(live & (idx != ip)).flatten()
    box = world.cluster_aabb[:6, ip[differ].long() // TT.DENSE_RUN]  # (6, D)
    reach = TT.slab_reaches(box, wo[differ, 0:3], w[differ, 0:3], TT._cluster_margin(world.cluster_aabb),
                            torch.full((differ.numel(),), float("inf"), device=dev))
    assert not reach.diagonal().any()
    same = live & (idx == ip) & (ip >= 0)
    assert ((t - tp).abs() / tp.abs().clamp_min(1e-30))[same].max().item() <= 1e-5


@pytest.mark.parametrize("scale", [1e-3, 1e3])
def test_dense_kernel_gate_at_extreme_scales(dev, scale):
    """The cluster gate's margin is scale-relative: at millimetre and
    kilometre scales the culled kernel finds the plain version's hits."""
    world = bake_world_triangles(build_cornell_box_scene(size=400.0 * scale).to_device(dev),
                                 fused_tile=None)
    g = np.random.default_rng(1234)
    ro = torch.tensor(g.uniform(-150, 150, (2048, 3)) * scale, dtype=torch.float32, device=dev)
    target = torch.tensor(g.uniform(-180, 180, (2048, 3)) * scale, dtype=torch.float32, device=dev)
    t, _ = _check_dense(world, ro, target - ro)
    assert (t < 9999999.0).float().mean().item() > 0.3


@pytest.fixture(scope="module")
def big_world(dev):
    """A 200k-triangle sphere in the room: 391 blocks, above the TPU
    kernels' streaming threshold of 313."""
    from pathtracerap_tpu_torch.bench_suite import build_highpoly_scene

    world = bake_world_triangles(build_highpoly_scene(subdiv=224, use_asset=False).to_device(dev))
    assert world.block_aabb.shape[0] > 313 and not TM.use_sub_blocks(world)
    return world


def test_worklist_kernels_above_313_blocks(dev, big_world):
    """Kernel 1 on the primaries and kernel 2 on a sorted bounce-1
    wavefront, at block granularity over 391-entry worklists."""
    from pathtracerap_tpu_torch.bench_suite import _ROOM_CAMERA

    world = big_world
    ro, rd = generate_rays(_ROOM_CAMERA, (128, 64), device=dev)
    w16, lists = TT.primary_inputs(world, ro, rd)
    assert lists.shape[1] == world.block_aabb.shape[0]
    t, idx = TT.nearest_hit_fused(w16, world, lists, TT.RAY_TILE)
    tp, ip = TT.nearest_hit_fused_plain(w16, world.fused_ops, lists.shape[1], world.tri_block)
    assert (idx == ip).float().mean().item() >= 0.9999
    assert _bits_equal((t, idx), (tp, ip), w16[:, 10] > 0)
    rd = normalize(rd)
    hits0 = TT.trace_pallas(world, ro, rd)
    pack, u_flat = TM.first_wavefront(world, ro, rd, hits0, prng_key(2, dev), 0, 4, ro.shape[0], 6,
                                      True, 0)
    pix = torch.arange(pack.shape[0], device=dev)
    pack, pix = TM.sort_wavefront(pack, pix, *TM.scene_morton_bounds(world.block_aabb))
    ray_tile = TM.binned_ray_tile(world)
    lists, unit = TM.bounce_lists(world, TT._slab_margin(world.block_aabb), pack, ray_tile)
    assert unit == world.tri_block and ray_tile == 512
    _check_bounce(world, pack, u_flat[:, 4:8][pix], lists, unit, ray_tile)
    # from inside the room, where the bounce rays list many of the 391 blocks
    ro, rd = generate_rays(CameraConfig(position=(0.0, 0.0, 190.0), plane_x=(-60.0, 60.0),
                                        plane_y=(-48.0, 48.0), plane_z=120.0), (64, 32), device=dev)
    rd = normalize(rd)
    pack, u_flat = TM.first_wavefront(world, ro, rd, TT.trace_pallas(world, ro, rd), prng_key(2, dev),
                                      0, 4, ro.shape[0], 6, True, 0)
    pix = torch.arange(pack.shape[0], device=dev)
    pack, pix = TM.sort_wavefront(pack, pix, *TM.scene_morton_bounds(world.block_aabb))
    lists, unit = TM.bounce_lists(world, TT._slab_margin(world.block_aabb), pack, ray_tile)
    _check_bounce(world, pack, u_flat[:, 4:8][pix], lists, unit, ray_tile, parities=(True,))


def _bits_equal(a, b, rows=None):
    """Kernel 1's (t, idx) against another's, bit for bit (on ``rows``)."""
    (t, i), (tp, ip) = a, b
    if rows is not None:
        t, i, tp, ip = t[rows], i[rows], tp[rows], ip[rows]
    return torch.equal(t.view(torch.int32), tp.view(torch.int32)) and torch.equal(i, ip)


# worklist lengths either side of kernel 1's chunk (TRACE_LIST_CHUNK entries),
# and a list of many chunks; every case also has a tile with an empty list
_C = TT.TRACE_LIST_CHUNK
K1_LENGTHS = tuple(sorted({_C - 1, _C, _C + 1, 2 * _C, 9 * _C + 1} - {0}))


@pytest.mark.parametrize("length", K1_LENGTHS)
@pytest.mark.parametrize("debug", [False, True], ids=["fast", "debug"])
def test_trace_list_kernel_on_list_lengths(dev, big_world, length, debug):
    """Kernel 1 on worklists of ``length`` blocks (blocks 0 to length - 1
    in a shuffled order per tile), one tile with an empty list: bit-equal
    to its plain version over the same blocks on every ray, a miss on
    every ray of the empty tile."""
    from pathtracerap_tpu_torch.bench_suite import _ROOM_CAMERA

    world = big_world
    ro, rd = generate_rays(_ROOM_CAMERA, (128, 64), device=dev)
    w16, _ = TT.primary_inputs(world, ro, rd)
    nt = w16.shape[0] // TT.RAY_TILE
    g = torch.Generator().manual_seed(length)
    lists = torch.full((nt, world.block_aabb.shape[0]), -1, dtype=torch.int32)
    for tile in range(nt):
        lists[tile, :length] = torch.randperm(length, generator=g)
    lists[1] = -1
    out = TT.nearest_hit_fused(w16, world, lists.to(dev), TT.RAY_TILE, debug)
    ref = TT.nearest_hit_fused_plain(w16, world.fused_ops, length, world.tri_block, debug)
    torch.cuda.synchronize()
    empty = torch.zeros(w16.shape[0], dtype=torch.bool, device=dev)
    empty[TT.RAY_TILE:2 * TT.RAY_TILE] = True
    assert _bits_equal(out, ref, ~empty)
    assert (out[0][empty] == 9999999.0).all() and (out[1][empty] == -1).all()


def test_trace_list_kernel_on_one_and_no_live_ray(dev, big_world):
    """Kernel 1 from inside the room (long worklists) with one live ray in
    tile 0 and none in tile 1: bit-equal to the plain version on the live
    rays, a miss on every ray of the tile with none."""
    world = big_world
    ro, rd = generate_rays(CameraConfig(position=(0.0, 0.0, 190.0), plane_x=(-60.0, 60.0),
                                        plane_y=(-48.0, 48.0), plane_z=120.0), (64, 64), device=dev)
    alive = torch.ones(ro.shape[0], dtype=torch.bool, device=dev)
    alive[1:2 * TT.RAY_TILE] = False
    w16, lists = TT.primary_inputs(world, ro, rd, alive)
    assert (lists[1] < 0).all() and (lists >= 0).sum(dim=1).max() > TT.TRACE_LIST_CHUNK
    out = TT.nearest_hit_fused(w16, world, lists, TT.RAY_TILE)
    ref = TT.nearest_hit_fused_plain(w16, world.fused_ops, lists.shape[1], world.tri_block)
    torch.cuda.synchronize()
    assert _bits_equal(out, ref, w16[:, 10] > 0)
    tile1 = slice(TT.RAY_TILE, 2 * TT.RAY_TILE)
    assert (out[0][tile1] == 9999999.0).all() and (out[1][tile1] == -1).all()


def test_trace_list_kernel_at_701_blocks(dev):
    """Kernel 1 on the suite's 701-block megascene, from its room camera
    and from inside the room: bit-equal to its plain version on every
    live ray, fast and debug forms."""
    from pathtracerap_tpu_torch.bench_suite import _ROOM_CAMERA, suite_configs

    world = bake_world_triangles(suite_configs()["megascene"]["scene"]().to_device(dev))
    assert world.block_aabb.shape[0] == 701
    inside = CameraConfig(position=(0.0, 0.0, 190.0), plane_x=(-60.0, 60.0),
                          plane_y=(-48.0, 48.0), plane_z=120.0)
    for cam in (_ROOM_CAMERA, inside):
        ro, rd = generate_rays(cam, (64, 64), device=dev)
        w16, lists = TT.primary_inputs(world, ro, rd)
        for debug in (False, True):
            out = TT.nearest_hit_fused(w16, world, lists, TT.RAY_TILE, debug)
            ref = TT.nearest_hit_fused_plain(w16, world.fused_ops, 701, world.tri_block, debug)
            assert _bits_equal(out, ref, w16[:, 10] > 0)


def test_pallas_render_on_gpu_matches_cpu(dev):
    """The per-bounce pallas engine at 32x16 x 2 spp x 3 bounces through
    kernels 1 and 5 against the same render on CPU tensors."""
    from pathtracerap_tpu_torch.render.wavefront import render_accumulate

    out = {}
    for d in (dev, torch.device("cpu")):
        scene = build_reference_scene().to_device(d)
        for tile in (512, None):
            world = bake_world_triangles(scene, fused_tile=tile)
            out[d.type, tile] = render_accumulate(scene, prng_key(3, d), CameraConfig(), (32, 16),
                                                  2, 3, engine="pallas", world=world).cpu()
    for tile in (512, None):
        d = (out["cuda", tile] - out["cpu", tile]).abs()
        assert d.mean().item() <= 1e-4 and (d <= 1e-5).float().mean().item() >= 0.995


# --------------------------------------------------------------------------
# the debug form of kernels 1, 2 and 4 (PTAP_DEBUG=1)
# --------------------------------------------------------------------------


def test_debug_trace_list_kernel_matches_fast_and_plain(dev, world):
    """Kernel 1's explicit-mask form against its fast form on primaries and
    on the degenerate rays of tests/test_debug_mode.py, and against its
    plain version in the same form."""
    from pathtracerap_tpu_torch.utils.debug import degenerate_rays

    ro, rd = generate_rays(CameraConfig(), (256, 128), device=dev)
    dro, drd = degenerate_rays(world)
    ro, rd = torch.cat([ro, dro]), torch.cat([rd, drd])
    w16, lists = TT.primary_inputs(world, ro, rd)
    fast = TT.nearest_hit_fused(w16, world, lists, TT.RAY_TILE, False)
    before = TT.nearest_hit_fused.launches
    dbg = TT.nearest_hit_fused(w16, world, lists, TT.RAY_TILE, True)
    torch.cuda.synchronize()
    assert TT.nearest_hit_fused.launches == before + 1
    assert torch.equal(dbg[0], fast[0]) and torch.equal(dbg[1], fast[1])
    tp, ip = TT.nearest_hit_fused_plain(w16, world.fused_ops, lists.shape[1], world.tri_block, True)
    n = ro.shape[0]  # the padding lanes of dead tiles are not traced
    assert (dbg[1][:n] == ip[:n]).float().mean().item() >= 0.9999


def test_debug_bounce_kernel_matches_fast(dev, world, wavefront):
    pack, u = wavefront
    ray_tile = TM.binned_ray_tile(world)
    lists, unit = TM.bounce_lists(world, TT._slab_margin(world.block_aabb), pack, ray_tile)
    fast = TM.bounce(pack, u, lists, unit, world, ray_tile, True, debug=False)
    dbg = TM.bounce(pack, u, lists, unit, world, ray_tile, True, debug=True)
    torch.cuda.synchronize()
    assert torch.equal(dbg[0], fast[0]) and torch.equal(dbg[1], fast[1])


def test_debug_fused_kernel_matches_fast(dev, world):
    w16, prim, u = _fused_case(world, dev, CameraConfig(), (128, 64), True)
    fast = TM.sample_fused(w16, prim, u[0], world, 5, False, False, debug=False)
    dbg = TM.sample_fused(w16, prim, u[0], world, 5, False, False, debug=True)
    torch.cuda.synchronize()
    assert torch.equal(dbg, fast)


# --------------------------------------------------------------------------
# kernel 2's worklists split over thread blocks
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def big_wavefront(dev, big_world):
    """Bounce 1 of a sorted 4-sample wavefront of 64x32 rays from inside
    the 391-block world's room: (pack (8192, 10), u (8192, 4)), 16 tiles
    of 512 rays."""
    world = big_world
    ro, rd = generate_rays(CameraConfig(**INSIDE), (64, 32), device=dev)
    rd = normalize(rd)
    pack, u_flat = TM.first_wavefront(world, ro, rd, TT.trace_pallas(world, ro, rd),
                                      prng_key(3, dev), 0, 4, ro.shape[0], 6, True, 0)
    pix = torch.arange(pack.shape[0], device=dev)
    pack, pix = TM.sort_wavefront(pack, pix, *TM.scene_morton_bounds(world.block_aabb))
    return pack, u_flat[:, 4:8][pix]


def _bounce_plain_over(pack, u, world, n_blocks, parity, debug):
    """Kernel 2's plain version over blocks 0 to n_blocks - 1 alone (a
    miss on every ray for none)."""
    if n_blocks:
        t, idx = TT.nearest_hit_fused_plain(TM._ray_vectors(pack), world.fused_ops, n_blocks,
                                            world.tri_block, debug)
    else:
        t = torch.full((pack.shape[0],), TT.F_MAX, device=pack.device)
        idx = torch.full((pack.shape[0],), -1, dtype=torch.int32, device=pack.device)
    return TM._shade_pack(pack, TM._attr_hits(world, t, idx), u, parity), idx


# worklist lengths either side of kernel 2's chunk on the 391-block world's
# 16 tiles, lists of three and of many chunks, and the whole world
BIG_TILES = 16
_C2 = TM.bounce_chunk(512, 391, BIG_TILES)
B2_LENGTHS = tuple(sorted({_C2 - 1, _C2, _C2 + 1, 2 * _C2 + 1, 4 * _C2, 9 * _C2 + 1, 391} - {0}))


@pytest.mark.parametrize("length", B2_LENGTHS)
@pytest.mark.parametrize("debug", [False, True], ids=["fast", "debug"])
def test_bounce_kernel_on_list_lengths(dev, big_world, big_wavefront, length, debug):
    """Kernel 2 in block mode on worklists of ``length`` blocks (blocks 0
    to length - 1 in a shuffled order per tile), with one live ray in tile
    0, an empty list in tile 1 and no live ray in tile 2 (its list kept),
    in both parities: bit-equal on every ray's state and every live ray's
    index to its plain version over the same blocks, and on every ray to
    its launch with one chunk a tile; every listed tile's chunks are
    enqueued in one launch."""
    world = big_world
    pack, u = big_wavefront
    pack = pack.clone()
    tile = 512
    nt = pack.shape[0] // tile
    assert nt == BIG_TILES and TM.bounce_chunk(world.tri_block, 391, nt) == _C2
    assert pack[0, 9] > 0
    pack[1:tile, 9] = 0.0
    pack[2 * tile:3 * tile, 9] = 0.0
    g = torch.Generator().manual_seed(length)
    lists = torch.full((nt, world.block_aabb.shape[0]), -1, dtype=torch.int32)
    for k in range(nt):
        lists[k, :length] = torch.randperm(length, generator=g)
    lists[1] = -1
    lists = lists.to(dev)
    live = pack[:, 9] > 0
    empty = torch.zeros(pack.shape[0], dtype=torch.bool, device=dev)
    empty[tile:2 * tile] = True
    chunks = -(-lists.shape[1] // _C2)
    for parity in (True, False):
        before = (TM.bounce.launches, TM.bounce.split_launches, TM.bounce.split_blocks)
        out = TM.bounce(pack, u, lists, world.tri_block, world, tile, parity, debug)
        torch.cuda.synchronize()
        assert (TM.bounce.launches, TM.bounce.split_launches, TM.bounce.split_blocks) == (
            before[0] + 1, before[1] + 1, before[2] + nt * chunks)
        ref = _bounce_plain_over(pack, u, world, length, parity, debug)
        ref_empty = _bounce_plain_over(pack, u, world, 0, parity, debug)
        assert _same_bounce(out, ref, live & ~empty)
        assert _same_bounce(out, ref_empty, live & empty)
        assert torch.equal(out[0][~live].view(torch.int32), pack[~live].view(torch.int32))
        assert (out[1][~live] == -1).all()
        one = _unsplit(world, pack, u, lists, world.tri_block, tile, parity, debug)
        assert _same_bounce(out, one)
    assert (ref[1][live & ~empty] >= 0).any()


def _twin_block_world(world, src: int, dst: int):
    """``world`` with block ``src`` copied over block ``dst``: each of its
    triangles has a twin ``(dst - src) * tri_block`` indices away, hit at
    the same t by every ray."""
    import dataclasses

    tb = world.tri_block
    ops_tri, fused, attr = world.ops_tri.clone(), world.fused_ops.clone(), world.attr_rows.clone()
    ops_tri[dst * tb:(dst + 1) * tb] = ops_tri[src * tb:(src + 1) * tb]
    fused[:, dst * 4 * tb:(dst + 1) * 4 * tb] = fused[:, src * 4 * tb:(src + 1) * 4 * tb]
    attr[:, dst * tb:(dst + 1) * tb] = attr[:, src * tb:(src + 1) * tb]
    return dataclasses.replace(world, ops_tri=ops_tri, fused_ops=fused, attr_rows=attr)


@pytest.mark.parametrize("chunk", [1, 2, 3])
@pytest.mark.parametrize("debug", [False, True], ids=["fast", "debug"])
def test_bounce_kernel_ties_across_chunks(dev, world, wavefront, chunk, debug):
    """The reference world's most-hit block copied over a later one: a ray
    that hits it meets two triangles at an equal t in different chunks,
    listed with the higher index first and last.  Kernel 2 split into
    chunks of ``chunk`` blocks keeps the lower index, as its plain version
    and its launch with one chunk a tile do, in both parities."""
    pack, u = wavefront
    tb, nb = world.tri_block, world.block_aabb.shape[0]
    live = pack[:, 9] > 0
    _, hit = TM.bounce_plain(pack, u, world, True)
    real = world.n_valid // tb  # the blocks of real triangles only
    src = int(torch.bincount((hit[live & (hit >= 0)] // tb).long(), minlength=nb)[:real - 1].argmax())
    dst = real - 1
    twins = _twin_block_world(world, src, dst)
    others = [b for b in range(nb) if b not in (src, dst)]
    tile = 512
    nt = pack.shape[0] // tile
    for order in ([dst, *others, src], [src, *others, dst]):
        lists = torch.tensor([order] * nt, dtype=torch.int32, device=dev)
        for parity in (True, False):
            ref, ridx = TM.bounce_plain(pack, u, twins, parity, debug)
            out = TM._bounce_kernel(pack, u, lists, tb, twins, tile, parity, debug, chunk)
            torch.cuda.synchronize()
            assert _same_bounce(out, (ref, ridx), live)
            assert torch.equal(out[0].view(torch.int32), ref.view(torch.int32))
            assert _same_bounce(out, _unsplit(twins, pack, u, lists, tb, tile, parity, debug))
    tied = live & (ridx >= src * tb) & (ridx < (src + 1) * tb)
    assert tied.sum() > 0


def test_bounce_launch_refuses_bad_grids(dev, world, wavefront):
    """ptt_bounce refuses, before it launches, a chunk under one entry, a
    grid of more than 65,535 chunks a tile, and a split with no merge
    buffer; with no tile it launches nothing.  The wrapper raises its
    refusal."""
    from pathtracerap_tpu_torch.kernels import _build

    lib = _build.library()

    def launch(nt, list_w, chunk, merge=None):
        return lib.ptt_bounce(None, None, None, nt, list_w, 512, 512, chunk, None, 0, None, 0, 1,
                              None, None, merge, 0, None)

    invalid = 1  # cudaErrorInvalidValue
    assert launch(1, 65536, 1, 8) == invalid
    assert launch(1, 8, 0, 8) == invalid
    assert launch(1, 8, 4) == invalid
    assert launch(0, 65536, 1) == 0
    pack, u = wavefront
    ray_tile = TM.binned_ray_tile(world)
    lists, unit = TM.bounce_lists(world, TT._slab_margin(world.block_aabb), pack, ray_tile)
    with pytest.raises(RuntimeError, match="ptt_bounce"):
        TM._bounce_kernel(pack, u, lists, unit, world, ray_tile, True, False, 0)


# --------------------------------------------------------------------------
# kernels 2 and 4 on tiles of chosen live counts, and without ops_tri
# --------------------------------------------------------------------------

# live rays of the first tiles: one, none, and either side of multiples of
# kernel 2's R (2) and of a warp
LIVE_PATTERN = (1, 0, 3, 5, 31, 33, 63, 65, 127, 129, 255)


def _kill_outside_pattern(alive, tile: int):
    """``alive`` (N,) bool with tile i cut to its first LIVE_PATTERN[i]
    rays (later tiles left as they are)."""
    alive = alive.clone()
    for i, k in enumerate(LIVE_PATTERN):
        alive[i * tile + k:(i + 1) * tile] = False
    return alive


@pytest.mark.parametrize("ray_tile", [256, 512])
def test_bounce_kernel_on_live_patterns(dev, world, wavefront, ray_tile):
    """Kernel 2 on sub-block worklists with tiles of one live ray, none,
    and live counts either side of multiples of R and of a warp."""
    pack, u = wavefront
    pack = pack.clone()
    pack[:, 9] = torch.where(_kill_outside_pattern(pack[:, 9] > 0, ray_tile), pack[:, 9], 0.0)
    lists, unit = TM.bounce_lists(world, TT._slab_margin(world.block_aabb), pack, ray_tile)
    _check_bounce(world, pack, u, lists, unit, ray_tile, parities=(True,))


@pytest.mark.parametrize("ray_tile", [256, 512])
def test_bounce_trace_kernel_on_live_patterns(dev, world, wavefront, ray_tile):
    """Kernel 3 with tiles of no, one and every live ray and live counts
    either side of multiples of R and of a warp: bit-equal to its plain
    version on live rays, a miss for the tile with none."""
    pack, _ = wavefront
    pack = pack.clone()
    pack[:, 9] = torch.where(_kill_outside_pattern(pack[:, 9] > 0, ray_tile), pack[:, 9], 0.0)
    assert (pack[:, 9].reshape(-1, ray_tile) > 0).all(dim=1).any()  # tiles of every ray live
    lists, unit = TM.bounce_lists(world, TT._slab_margin(world.block_aabb), pack, ray_tile)
    _check_bounce_trace(world, pack, lists, unit, ray_tile)


def test_fused_kernel_on_live_patterns(dev):
    """Kernel 4 on the Cornell box with primary rows whose misses leave
    tile i with LIVE_PATTERN[i] live rays after bounce 0: 8-sample batches
    (parity and quality shading) and the emit_idx pass."""
    world = bake_world_triangles(build_cornell_box_scene().to_device(dev))
    w16, prim, _ = _fused_case(world, dev, CORNELL_CAM, (64, 64), False)
    n = w16.shape[0]
    dead = ~_kill_outside_pattern(torch.ones(n, dtype=torch.bool, device=dev), TM.FUSED_TILE)
    prim = prim.clone()
    prim[dead] = 0.0
    prim[dead, 0] = 9999999.0  # a miss at bounce 0 kills the ray
    u = chunk_uniforms(prng_key(4, dev), range(8), 5, n, n).reshape(8, n, 20)
    for parity in (True, False):
        _check_fused(world, w16, prim, u, parity, True)
    _check_fused(world, w16, prim, u[0], True, True, emit_idx=True)


def test_kernels_raise_without_ops_tri(dev, world, wavefront):
    """No fallback: a CUDA world without the triangle-major pack raises."""
    import dataclasses

    bare = dataclasses.replace(world, ops_tri=None)
    pack, u = wavefront
    ray_tile = TM.binned_ray_tile(world)
    lists, unit = TM.bounce_lists(world, TT._slab_margin(world.block_aabb), pack, ray_tile)
    with pytest.raises(ValueError, match="ops_tri is None"):
        TM.bounce(pack, u, lists, unit, bare, ray_tile, True)
    with pytest.raises(ValueError, match="ops_tri is None"):
        TM.bounce_trace(pack, lists, unit, bare, ray_tile)
    r = TM.BOUNCE_TRACE_RAYS_PER_THREAD
    for bad in [48] + ([32 * (r + 1)] if r > 1 else []):  # not a multiple of 32 * R
        with pytest.raises(ValueError, match="ray_tile must be a multiple"):
            TM.bounce_trace(pack[:2 * bad], lists[:2], unit, world, bad)
    w16, prim, uu = _fused_case(world, dev, CameraConfig(), (32, 16), True)
    with pytest.raises(ValueError, match="ops_tri is None"):
        TM.sample_fused(w16, prim, uu[0], bare, 5, False, False)
    ro, rd = generate_rays(CameraConfig(), (32, 16), device=dev)
    w16, lists = TT.primary_inputs(world, ro, rd)
    with pytest.raises(ValueError, match="ops_tri is None"):
        TT.nearest_hit_fused(w16, bare, lists, TT.RAY_TILE)
    with pytest.raises(ValueError, match="ops_tri is None"):
        TT.trace_pallas(bare, ro, rd)


# --------------------------------------------------------------------------
# the profiling kernels P1 to P4
# --------------------------------------------------------------------------


def _prof_inputs(dev, n, k, tb=512, nb=8, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    w = torch.randn((n, k), generator=g).to(dev)
    ops = torch.randn((k, 4 * tb * nb), generator=g).to(dev)
    attr = torch.randn((16, tb * nb), generator=g).to(dev)
    return w, ops, attr


@pytest.mark.parametrize("variant", ["mm_bf16", "mm_bf16x3", "mm_f32", "accept", "argmin",
                                     "select"])
def test_prof_parts_kernel_matches_plain(dev, variant):
    """P1 at its widths (R = TB = 512, NB = 8) on 8,192 rays: the products
    within rtol 1e-5, the accept chain and what follows on 99.9 % of rays."""
    from pathtracerap_tpu_torch.kernels import prof as P

    w, ops, attr = _prof_inputs(dev, 8192, 16)
    before = P.parts.launches
    out = P.parts(variant, w, ops, attr, 512, 512, 8)
    torch.cuda.synchronize()
    assert P.parts.launches == before + 1
    ref = P.parts_plain(variant, w, ops, attr, 512, 512, 8)
    close = torch.isclose(out, ref, rtol=1e-5, atol=0.0)
    assert close.float().mean().item() >= (1.0 if variant.startswith("mm_") else 0.999)


@pytest.mark.parametrize("k, unroll", [(16, True), (32, False), (128, False), (128, True)])
def test_prof_parts_kernel_depths_match_plain(dev, k, unroll):
    """P2's product variants: single-pass bf16 at K = 16, 32, 128."""
    from pathtracerap_tpu_torch.kernels import prof as P

    w, ops, _ = _prof_inputs(dev, 4096, k, seed=k)
    out = P.parts("mm_bf16", w, ops, None, 512, 512, 8, unroll=unroll)
    ref = P.parts_plain("mm_bf16", w, ops, None, 512, 512, 8)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=0.0)


def _tie_inputs(variant, tb=512, nb=8, n=4096):
    """Small integers, so that every product is exact in bf16 and in f32
    (the kernel and the plain version then round alike, and equal t are
    everywhere).  Ray c < 4 is the unit vector e_c and reads row c of ops
    directly: there every triangle of every visit has s = (1, 1, 1) and
    t = num / 3 >= 1, but for case c's first triangle, at t = 0 in visit 0,
    whose four columns (all 16 rows) are copied to later triangles: in the
    same lane (columns 10, 11 of a lane), in another lane of the same
    8-column tile, in the next staged run and the last, in later visits
    (a staged run: ``parts_run`` triangles).  Returns w, ops,
    attr and each case's first triangle."""
    from pathtracerap_tpu_torch.kernels import prof as P

    g = np.random.default_rng(7)
    w = g.integers(-1, 2, (n, 16)).astype(np.float32)
    ops = g.integers(-1, 2, (16, 4 * tb * nb)).astype(np.float32)
    attr = g.standard_normal((16, tb * nb)).astype(np.float32)
    run = P.parts_run(variant, 16)
    j = np.arange(tb)
    for c in range(4):
        w[c] = 0.0
        w[c, c] = 1.0
        for blk in range(nb):
            base = blk * 4 * tb
            ops[c, base + j] = ops[c, base + tb + j] = ops[c, base + 2 * tb + j] = 1.0
            ops[c, base + 3 * tb + j] = 3.0 + (7 * j + blk) % 11
    cases = [(10, [(0, 11)]), (20, [(0, 23)]), (40, [(0, 40 + run), (0, tb - 24)]),
             (50, [(3, 50), (5, 7)])]
    for c, (first, copies) in enumerate(cases):
        ops[c, 3 * tb + first] = 0.0
        for blk, jj in copies:
            for q in range(4):
                ops[:, blk * 4 * tb + q * tb + jj] = ops[:, q * tb + first]
    return w, ops, attr, [first for first, _ in cases]


@pytest.mark.parametrize("variant", ["argmin", "select", "accept", "mm_bf16", "mm_bf16x3",
                                     "mm_f32"])
def test_prof_parts_kernel_ties_take_the_first_column(dev, variant):
    """On exact inputs full of equal minima the parts kernel equals the
    plain version bit for bit, and where a triangle's columns were copied
    to a later triangle (same lane, another lane, another staged run, a
    later visit) the first one wins: argmin adds its index, select its
    attribute rows."""
    from pathtracerap_tpu_torch.kernels import prof as P

    tb, nb = 512, 8
    w, ops, attr, firsts = _tie_inputs(variant, tb, nb)
    wt, opst, attrt = (torch.from_numpy(x).to(dev) for x in (w, ops, attr))
    out = P.parts(variant, wt, opst, attrt, 512, tb, nb)
    ref = P.parts_plain(variant, wt, opst, attrt, 512, tb, nb)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))
    got = out[:4].cpu().numpy()
    if variant == "argmin":  # visit 0 takes t = 0 at the first; no later visit is smaller
        np.testing.assert_array_equal(got, np.float32(firsts))
    if variant == "select":
        def expected(col):
            a = attr[0, col]
            for k in range(1, 7):
                a = np.float32(a + attr[k, col])
            for _ in range(nb - 1):  # seven visits without an improve
                s = a
                for _ in range(6):
                    s = np.float32(s + a)
                a = np.float32(s + a * np.float32(0.0))
            return a

        np.testing.assert_array_equal(got, [expected(f) for f in firsts])
        assert expected(10) != expected(11) and expected(20) != expected(23)
    assert torch.isclose(out, ref, rtol=1e-5, atol=0.0).all()


BOUNDARY_RAYS = (0, 9, 70, 135, 200, 263, 300, 511)  # in several m-tiles, quads and rows


def _two_rows(x: np.ndarray):
    """Values b, r for ops rows c and d, so that a ray e_c + e_d sums x
    through the bf16x3 split to within an ulp or so: b = bf16 hi + lo of x,
    r = bf16(x - b)."""
    def bf16(v):
        return torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(torch.bfloat16).float().numpy()

    x = x.astype(np.float32)
    hi = bf16(x)
    b = hi + bf16(x - hi)
    return b, bf16(x - b)


def _boundary_inputs(tb=512, nb=8, n=4096):
    """Standard normals, but for ray BOUNDARY_RAYS[i] = e_2i + e_2i+1, whose
    sums rows 2i and 2i + 1 of ops give (_two_rows).  Its pairs sit at the
    accept chain's bounds (u or v at -0.005, u at 1.005, u + v at 1.005; t
    at -0.005 for rays 0 and 4), each a few ulps either way, with t drawn
    from a few values an ulp apart, so that the visit's winner is settled by
    a hair and by the first index.  Rays 0-3 have every triangle so; rays 4-7 six a
    visit (the same lane, two others, the next staged run, the last), the
    rest far outside.  Returns w, ops, attr and the plain chain's accept
    mask over the special rays' pairs with their (u, v, t), from the plain
    version's sums."""
    from pathtracerap_tpu_torch.kernels import prof as P

    g = np.random.default_rng(11)
    w = g.standard_normal((n, 16)).astype(np.float32)
    ops = g.standard_normal((16, 4 * tb * nb)).astype(np.float32)
    attr = g.standard_normal((16, tb * nb)).astype(np.float32)
    m = nb * tb
    for i, ray in enumerate(BOUNDARY_RAYS):
        w[ray] = 0.0
        w[ray, 2 * i] = w[ray, 2 * i + 1] = 1.0
        det = g.uniform(0.5, 3.0, m) * g.choice([-1.0, 1.0], m)
        kind = g.integers(0, 5 if i in (0, 4) else 4, m)  # t at -0.005 for two rays
        eps = g.uniform(-4e-7, 4e-7, (3, m))
        u = np.choose(kind, [-0.005 * (1 + eps[0]), 0.3, 1.005 * (1 + eps[0]), 0.6, 0.2])
        v = np.choose(kind, [0.4, -0.005 * (1 + eps[1]), -0.004, 0.405 * (1 + eps[1]), 0.3])
        t0 = np.repeat(g.uniform(0.5, 4.0, nb), tb)
        t = t0 * (1.0 + 2.0 ** -22 * g.integers(0, 4, m))
        t = np.where(kind == 4, -0.005 * (1 + eps[2]), t)
        if i >= 4:  # six pairs a visit at the bounds, the rest far outside
            keep = np.zeros((nb, tb), bool)
            keep[:, [10, 11, 20, 23, 10 + 128, tb - 2]] = True
            u = np.where(keep.reshape(-1), u, -0.5)
        ca, ab = u * det, v * det
        x = np.stack([ab, det - ab - ca, ca, t * det])  # (4, nb * tb): quadrant, blk * tb + j
        b, r = _two_rows(x)
        cols = (np.arange(nb)[:, None] * 4 * tb + np.arange(4)[:, None, None] * tb
                + np.arange(tb)).reshape(4, -1)  # (4, nb * tb) column of quadrant q
        ops[2 * i, cols] = b
        ops[2 * i + 1, cols] = r
    opst = torch.from_numpy(ops)
    s = P._product("accept", torch.from_numpy(w[list(BOUNDARY_RAYS)]), P._operands("accept", opst))
    s = s.reshape(len(BOUNDARY_RAYS), nb, 4, tb).transpose(0, 2).reshape(4, -1)
    det = (s[0] + s[1]) + s[2]
    inv = 1.0 / det
    t, u, v = s[3] * inv, s[2] * inv, s[0] * inv
    acc = (u >= -0.005) & (v >= -0.005) & (t >= -0.005) & (u <= 1.005) & (u + v <= 1.005)
    return w, ops, attr, acc, (u, v, t)


@pytest.mark.parametrize("variant", ["accept", "argmin", "select"])
def test_prof_parts_chain_settles_boundary_pairs_exactly(dev, variant):
    """The chain variants choose candidates on the tensor cores' sums but
    settle them with the plain version's rounding: where pairs sit at the
    accept chain's bounds by an ulp, and t differ by an ulp or tie, the
    kernel equals the plain version bit for bit on every ray."""
    from pathtracerap_tpu_torch.kernels import prof as P

    tb, nb = 512, 8
    w, ops, attr, acc, (u, v, t) = _boundary_inputs(tb, nb)
    # the inputs reach the bounds: pairs within 4 ulps of one, accepted and not
    ulp = 2.0 ** -23
    near = (((u + 0.005).abs() < 4 * ulp * 0.005) | ((v + 0.005).abs() < 4 * ulp * 0.005)
            | ((t + 0.005).abs() < 4 * ulp * 0.005) | ((u - 1.005).abs() < 8 * ulp)
            | ((u + v - 1.005).abs() < 8 * ulp))
    assert (near & acc).sum() > 1000 and (near & ~acc).sum() > 1000
    wt, opst, attrt = (torch.from_numpy(x).to(dev) for x in (w, ops, attr))
    out = P.parts(variant, wt, opst, attrt, 512, tb, nb)
    ref = P.parts_plain(variant, wt, opst, attrt, 512, tb, nb)
    torch.cuda.synchronize()
    rays = list(BOUNDARY_RAYS)
    assert torch.equal(out[rays].view(torch.int32), ref[rays].view(torch.int32))
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("with_ops", [True, False])
def test_prof_empty_kernel_matches_plain(dev, with_ops):
    from pathtracerap_tpu_torch.kernels import prof as P

    w, ops, _ = _prof_inputs(dev, 1563 * 512, 16, tb=1024, nb=4)
    out = P.empty(w, 512, ops if with_ops else None)
    assert torch.equal(out, P.empty_plain(w))


def test_prof_argmin_kernel_matches_plain(dev):
    from pathtracerap_tpu_torch.kernels import prof as P

    x = torch.randn((512, 512), generator=torch.Generator().manual_seed(1)).to(dev)
    x[7, 300] = x[7, 20] = x[7].min() - 1.0  # a tie: the first index wins
    bases = torch.tensor([3, 9, 1, 7], dtype=torch.int32, device=dev)
    before = P.argmin_int.launches
    out = P.argmin_int(x, bases)
    torch.cuda.synchronize()
    assert P.argmin_int.launches == before + 1
    assert torch.equal(out, P.argmin_int_plain(x, bases))
    assert out[7].item() == 3 * 128 + 20


# --------------------------------------------------------------------------
# slice 10: kernel G1 (the parity grid trace) and P3's redesign
# --------------------------------------------------------------------------


def _hits_bit_equal(a, b):
    """Two (HitRecord, stats) pairs bit for bit on every field and stat."""
    (ra, sa), (rb, sb) = a, b
    for f in ("t", "normal", "mat_type", "mat_color", "mat_ri", "model", "tri"):
        x, y = getattr(ra, f), getattr(rb, f)
        if not torch.equal(x.view(torch.int32), y.view(torch.int32)):
            return f
    for f in ("steps", "tri_tests"):
        if not torch.equal(sa[f], sb[f]):
            return f
    return None


def _odd_rays(dev, n=4096, spread=400.0):
    """Rays from inside and around the scene, a quarter with one zero
    direction component and an eighth with two."""
    g = torch.Generator().manual_seed(5)
    o = (torch.rand(n, 3, generator=g) * 2.0 - 1.0) * spread
    d = torch.randn(n, 3, generator=g)
    d[: n // 4, 0] = 0.0
    d[n // 4: 3 * n // 8, 1:] = 0.0
    return o.to(dev).contiguous(), d.to(dev).contiguous()


@pytest.mark.parametrize("scene_name", ["cornell", "reference"])
def test_grid_dda_kernel_matches_plain(dev, scene_name):
    """G1 against ops/intersect.trace_parity on the card: primaries, their
    bounce-1 rays and odd rays, every field and stat bit for bit."""
    from pathtracerap_tpu_torch.kernels import dda as DD
    from pathtracerap_tpu_torch.ops.intersect import trace_parity
    from pathtracerap_tpu_torch.render.shade import RayState, shade

    if scene_name == "cornell":
        scene = build_cornell_box_scene().to_device(dev)
        cam = CameraConfig(position=(0.0, 0.0, 150.0), plane_x=(-40.0, 40.0),
                           plane_y=(-40.0, 40.0), plane_z=100.0)
        spread = 200.0
    else:
        scene, cam, spread = build_reference_scene().to_device(dev), CameraConfig(), 600.0
    ro, rd = generate_rays(cam, (128, 96), device=dev)
    ro, rd = ro.contiguous(), rd.contiguous()
    before = DD.grid_trace.launches
    k0 = DD.grid_trace(scene, ro, rd, return_stats=True)
    torch.cuda.synchronize()
    assert DD.grid_trace.launches == before + 1
    assert _hits_bit_equal(k0, trace_parity(scene, ro, rd, return_stats=True)) is None
    u = chunk_uniforms(prng_key(3, dev), 0, 5, ro.shape[0], ro.shape[0], 0, rng_tile=2048)
    st = shade(RayState.primary(ro, rd, 5), k0[0], u[:, :4])
    o1, d1 = st.orig.contiguous(), st.dir.contiguous()
    assert _hits_bit_equal(DD.grid_trace(scene, o1, d1, return_stats=True),
                           trace_parity(scene, o1, d1, return_stats=True)) is None
    o, d = _odd_rays(dev, spread=spread)
    k = DD.grid_trace(scene, o, d, return_stats=True)
    assert _hits_bit_equal(k, trace_parity(scene, o, d, return_stats=True)) is None
    assert (k[0].t < 9999999.0).any() and (k[1]["tri_tests"] > 0).any()
    # without stats: the same record
    r = DD.grid_trace(scene, o, d)
    assert torch.equal(r.t, k[0].t) and torch.equal(r.normal, k[0].normal)


def test_grid_dda_wrapper_checks(dev):
    from pathtracerap_tpu_torch.kernels import dda as DD

    scene = build_cornell_box_scene().to_device(dev)
    ro, rd = _odd_rays(dev, n=64)
    with pytest.raises(ValueError, match="contiguous"):
        DD.grid_trace(scene, ro.t().contiguous().t(), rd)
    with pytest.raises(ValueError, match="expected"):
        DD.grid_trace(scene, ro.double(), rd)
    with pytest.raises(ValueError, match="expected"):
        DD.grid_trace(scene, ro[:, :2].contiguous(), rd)
    with pytest.raises(ValueError, match="expected"):
        DD.grid_trace(build_cornell_box_scene().to_device("cpu"), ro, rd)
    bad = scene.replace(voxel_tri_start=scene.voxel_tri_start[:-1])
    with pytest.raises(ValueError, match="grid tables"):
        DD.grid_trace(bad, ro, rd)
    with pytest.raises(ValueError, match="expected"):
        DD.grid_trace(scene, ro, rd, alive=torch.ones(64, dtype=torch.int32, device=dev))
    with pytest.raises(ValueError, match="expected"):
        DD.grid_trace(scene, ro, rd, alive=torch.ones(63, dtype=torch.bool, device=dev))


def _both(scene, o, d, alive=None):
    from pathtracerap_tpu_torch.kernels import dda as DD
    from pathtracerap_tpu_torch.ops.intersect import trace_parity

    return (DD.grid_trace(scene, o, d, alive=alive, return_stats=True),
            trace_parity(scene, o, d, return_stats=True, alive=alive))


@pytest.mark.parametrize("scene_name", ["cornell", "reference"])
def test_grid_dda_kernel_live_rays(dev, scene_name):
    """G1 with the liveness mask against the plain version, bit for bit on
    every ray, field, stat, model and triangle: the primaries (all live),
    their bounce-1 wavefront with the render's mask, odd rays with half of
    them live, a wavefront with no live ray (every record the miss, no
    work) and one with a single live ray; one launch a call."""
    from pathtracerap_tpu_torch.kernels import dda as DD
    from pathtracerap_tpu_torch.render.shade import RayState, shade

    if scene_name == "cornell":
        scene = build_cornell_box_scene().to_device(dev)
        cam = CameraConfig(position=(0.0, 0.0, 150.0), plane_x=(-40.0, 40.0),
                           plane_y=(-40.0, 40.0), plane_z=100.0)
    else:
        scene, cam = build_reference_scene().to_device(dev), CameraConfig()
    ro, rd = generate_rays(cam, (128, 96), device=dev)
    ro, rd = ro.contiguous(), rd.contiguous()
    n = ro.shape[0]
    all_live = torch.ones(n, dtype=torch.bool, device=dev)
    assert _hits_bit_equal(*_both(scene, ro, rd, all_live)) is None
    k0 = DD.grid_trace(scene, ro, rd)
    u = chunk_uniforms(prng_key(3, dev), 0, 5, n, n, 0, rng_tile=2048)
    st = shade(RayState.primary(ro, rd, 5), k0, u[:, :4])
    o1, d1, alive = st.orig.contiguous(), st.dir.contiguous(), st.remaining > 0
    assert 0 < alive.sum().item() <= n
    assert _hits_bit_equal(*_both(scene, o1, d1, alive)) is None
    o, d = _odd_rays(dev, spread=600.0)
    half = torch.arange(o.shape[0], device=dev) % 2 == 1
    assert _hits_bit_equal(*_both(scene, o, d, half)) is None
    none = torch.zeros(n, dtype=torch.bool, device=dev)
    before = DD.grid_trace.launches
    (rec, stats), plain = _both(scene, o1, d1, none)
    assert DD.grid_trace.launches == before + 1
    assert _hits_bit_equal((rec, stats), plain) is None
    assert (rec.t == 9999999.0).all() and (rec.model == -1).all() and (rec.tri == -1).all()
    assert (rec.mat_ri == 1.5).all() and (stats["steps"] == 0).all()
    one = none.clone()
    one[n // 3] = True
    (rec, stats), plain = _both(scene, o1, d1, one)
    assert _hits_bit_equal((rec, stats), plain) is None
    assert (stats["steps"][~one] == 0).all()


def test_grid_dda_kernel_global_form(dev):
    """G1's global-memory form on the highpoly blob alone under 25^3
    voxels (5.3 MB of triangle table, up to 2,613 triangles a voxel),
    bit-equal to the plain version on 1,024 rays aimed at it, all live and
    half of them."""
    from pathtracerap_tpu_torch.kernels import dda as DD
    from pathtracerap_tpu_torch.scene.build import SceneBuilder
    from pathtracerap_tpu_torch.scene.types import Material, MaterialType

    b = SceneBuilder(grid_dims=(25, 25, 25))
    mesh = os.path.join(os.path.dirname(GOLDEN), "..", "meshes", "highpoly_blob.obj")
    b.add_instance(b.add_mesh_file(mesh), Material(MaterialType.DIFFUSE, (0.8, 0.3, 0.2)))
    host = b.build()
    scene = host.to_device(dev)
    assert not DD.grid_trace_form(scene)["shared"]
    g = torch.Generator().manual_seed(7)
    lo, hi = torch.from_numpy(host.mesh_bbox_min[0]), torch.from_numpy(host.mesh_bbox_max[0])
    o = torch.randn(1024, 3, generator=g)
    o = (lo + hi) / 2 + 400.0 * o / o.norm(dim=1, keepdim=True)
    d = lo + torch.rand(1024, 3, generator=g) * (hi - lo) - o
    o, d = o.to(dev).contiguous(), d.to(dev).contiguous()
    (rec, stats), plain = _both(scene, o, d)
    assert _hits_bit_equal((rec, stats), plain) is None
    assert (rec.model == 0).float().mean().item() > 0.5 and stats["tri_tests"].max().item() > 100
    # the bounce form too (a liveness mask)
    half = torch.arange(1024, device=dev) % 2 == 0
    assert _hits_bit_equal(*_both(scene, o, d, half)) is None


@pytest.mark.parametrize("parity", [True, False], ids=["parity", "quality"])
def test_parity_train_step_on_gpu_matches_cpu(dev, parity):
    """The parity engine's loss and its mat_color and model_to_world
    gradients at 32x16, 2 spp, 4 bounces through G1 against the same on
    CPU tensors (the plain version): loss rtol 1e-5, gradients rtol 1e-4,
    as chip_smoke's train_step_vs_cpu holds them."""
    from pathtracerap_tpu_torch.diff import extract_params, loss_and_grad
    from pathtracerap_tpu_torch.kernels import dda as DD

    def loss_grad(d):
        scene = build_reference_scene().to_device(d)
        return loss_and_grad(
            extract_params(scene, ("mat_color", "model_to_world")), scene,
            torch.full((32 * 16, 3), 0.25, device=d), prng_key(1, d), CameraConfig(), (32, 16), 2,
            4, tile_size=2048, engine="parity", parity=parity)

    before = DD.grid_trace.launches
    l_g, g_g = loss_grad(dev)
    assert DD.grid_trace.launches == before + 1 + 2 * 3
    l_c, g_c = loss_grad(torch.device("cpu"))
    assert abs(l_g.item() - l_c.item()) <= 1e-5 * abs(l_c.item())
    for k in g_c:
        assert torch.isfinite(g_g[k]).all(), k
        torch.testing.assert_close(g_g[k].cpu(), g_c[k], rtol=1e-4, atol=1e-7, msg=k)
    assert (g_g["mat_color"] != 0).any()


def test_parity_render_on_the_card_matches_cpu(dev):
    """Renderer(engine="parity") at 32x16 on the card (G1) against the same
    render on CPU tensors (the plain version): the image mean within 1e-4,
    99.5 % of components within 1e-5."""
    cfg = RenderConfig(resolution=(32, 16), samples_per_pixel=2, max_bounces=4, engine="parity")
    a = Renderer(build_reference_scene().to_device(dev), cfg, device=dev).render().cpu()
    b = Renderer(build_reference_scene().to_device("cpu"), cfg, device="cpu").render()
    diff = (a - b).abs()
    assert diff.mean().item() <= 1e-4
    assert (diff <= 1e-5).float().mean().item() >= 0.995


@pytest.mark.parametrize("rows", [512, 131072])
def test_prof_argmin_kernel_nan_and_ties(dev, rows):
    """P3 at the script's 512 x 512 and at 131,072 x 512 (the float4 path),
    rows with NaN (the first NaN wins), tied minima (the first
    wins), all-equal rows, and other widths (the strided path)."""
    from pathtracerap_tpu_torch.kernels import prof as P

    g = torch.Generator().manual_seed(rows)
    x = torch.randn(rows, 512, generator=g)
    x[::7, 100] = float("nan")
    x[::14, 33] = float("nan")
    x[3::13, 5] = x[3::13, 400] = -50.0
    x[5::17] = 1.0
    x[6::19, 511] = -60.0
    x = x.to(dev)
    bases = torch.tensor([3, 9, 1, 7], dtype=torch.int32, device=dev)
    ref = P.argmin_int_plain(x, bases)
    assert ref[0].item() == 3 * 128 + 33 and ref[3].item() == 3 * 128 + 5
    n_vec = P.argmin_int.variant_launches["vec512"]
    assert torch.equal(P.argmin_int(x, bases), ref)
    assert P.argmin_int.variant_launches["vec512"] == n_vec + 1
    for cols in (1, 31, 200, 513):
        y = x[:, :cols].contiguous() if cols <= 512 else torch.cat([x, x[:, :1]], dim=1)
        assert torch.equal(P.argmin_int(y, bases), P.argmin_int_plain(y, bases)), cols


def test_prof_argmin_wrapper_checks(dev):
    """P3's wrapper: a misaligned x takes the strided path (and agrees); a
    wrong dtype, shape, device or layout raises."""
    from pathtracerap_tpu_torch.kernels import prof as P

    x = torch.randn(512 * 512 + 1, device=dev)[1:].view(512, 512)
    bases = torch.tensor([3, 9, 1, 7], dtype=torch.int32, device=dev)
    assert not P.argmin_vec_path(x)
    n_general = P.argmin_int.variant_launches["general"]
    assert torch.equal(P.argmin_int(x, bases), P.argmin_int_plain(x, bases))
    assert P.argmin_int.variant_launches["general"] == n_general + 1
    with pytest.raises(ValueError, match="expected"):
        P.argmin_int(x.double(), bases)
    with pytest.raises(ValueError, match="expected"):
        P.argmin_int(x, bases.long())
    with pytest.raises(ValueError, match="expected"):
        P.argmin_int(x, bases.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        P.argmin_int(torch.randn(512, 1024, device=dev)[:, ::2], bases)


@pytest.mark.parametrize("engine", ["fused", "dense"])
def test_geometry_ring_on_the_card_equals_one_process(dev, engine):
    """The geometry ring's pure form for D = 2 and 3 on the card (kernel 1,
    or kernel 5, on each shard) against one process's per-bounce pallas
    render of the same tiles, bit for bit; both kernels launch."""
    from pathtracerap_tpu_torch.parallel import geometry as G
    from pathtracerap_tpu_torch.render.wavefront import render_accumulate

    scene = build_reference_scene().to_device(dev)
    cam, res, spp, bounces, tile = CameraConfig(), (64, 48), 2, 3, 512
    key = prng_key(0, dev)
    world = bake_world_triangles(scene, fused_tile=512 if engine == "fused" else None)
    ref = render_accumulate(scene, key, cam, res, spp, bounces, engine="pallas", tile_size=tile,
                            world=world)
    launches = TT.nearest_hit_fused if engine == "fused" else TT.nearest_hit
    for d in (2, 3):
        ring_world = G.ring_bake(scene, d, engine)
        before = launches.launches
        parts = [G.render_rank_ring(scene, key, cam, res, spp, bounces, r, d,
                                    G.ring_world(ring_world, r, d, engine), tile_size=tile)
                 for r in range(d)]
        torch.cuda.synchronize()
        assert launches.launches > before
        assert torch.equal(torch.cat(parts)[:res[0] * res[1]], ref), d
