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
    t, idx = TT.nearest_hit_fused(w16, world.fused_ops, lists, TT.RAY_TILE, world.tri_block)
    torch.cuda.synchronize()
    assert TT.nearest_hit_fused.launches == before + 1
    tp, ip = TT.nearest_hit_fused_plain(w16, world.fused_ops, world.block_aabb.shape[0], world.tri_block)
    same = idx == ip
    assert same.float().mean().item() >= 0.9999
    both = same & (ip >= 0)
    rel = ((t - tp).abs() / tp.abs().clamp_min(1e-30))[both]
    assert rel.max().item() <= 1e-5


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


def _check_bounce(world, pack, u, lists, unit, ray_tile):
    for parity in (True, False):
        before = TM.bounce.launches
        out, idx = TM.bounce(pack, u, lists, unit, world, ray_tile, parity)
        torch.cuda.synchronize()
        assert TM.bounce.launches == before + 1
        ref, ridx = TM.bounce_plain(pack, u, world, parity)
        live = pack[:, 9] > 0
        agree = (idx == ridx) & live
        assert (agree.sum() / live.sum()).item() >= 0.9999
        assert (out - ref).abs()[agree].max().item() <= 1e-4
        assert torch.equal(out[~live], pack[~live])


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


def test_bounce_trace_kernel_matches_plain(dev, world, wavefront):
    """Kernel 3 on the sub-block worklists of the same sorted wavefront:
    the winner's index on live rays, its t, and a miss for dead tiles."""
    pack, _ = wavefront
    ray_tile = TM.binned_ray_tile(world)
    lists, unit = TM.bounce_lists(world, TT._slab_margin(world.block_aabb), pack, ray_tile)
    before = TM.bounce_trace.launches
    t, col1 = TM.bounce_trace(pack, lists, unit, world, ray_tile)
    torch.cuda.synchronize()
    assert TM.bounce_trace.launches == before + 1
    tp, cp = TM.bounce_trace_plain(pack, world, ray_tile)
    live = pack[:, 9] > 0
    agree = (col1 == cp) & live
    assert (agree.sum() / live.sum()).item() >= 0.9999
    both = agree & (cp > 0)
    assert ((t - tp).abs() / tp.abs().clamp_min(1e-30))[both].max().item() <= 1e-5
    dead_tile = ~live.reshape(-1, ray_tile).any(dim=1).repeat_interleave(ray_tile)
    assert (col1[dead_tile] == 0).all() and (t[dead_tile] == 9999999.0).all()


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
    before = TM.sample_fused.launches
    out = TM.sample_fused(w16, prim, u, world, 5, parity, use_primary, emit_idx=emit_idx)
    torch.cuda.synchronize()
    assert TM.sample_fused.launches == before + 1
    ref = TM.sample_fused_plain(w16, prim, u, world, 5, parity, use_primary, emit_idx=emit_idx)
    if emit_idx:
        (out, idx), (ref, ridx) = out, ref
        assert idx.dtype == torch.int32 and idx.shape == (w16.shape[0], 5)
        live = (idx != 0) | (ridx != 0)
        assert ((idx == ridx) & live).sum().item() >= 0.9999 * live.sum().item()
    assert torch.isfinite(out).all()
    close = ((out - ref).abs() <= 1e-4).all(dim=1)
    assert close.float().mean().item() >= 0.999


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
    """Above 8 blocks the kernel gates each block on its AABB per tile; the
    plain version sweeps every block.  Nine spheres in a room: 17 blocks."""
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
    t, idx = TT.nearest_hit(*args, cull=cull, n_valid=world.n_valid)
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
    t, idx = TT.nearest_hit_fused(w16, world.fused_ops, lists, TT.RAY_TILE, world.tri_block)
    tp, ip = TT.nearest_hit_fused_plain(w16, world.fused_ops, lists.shape[1], world.tri_block)
    assert (idx == ip).float().mean().item() >= 0.9999
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
    fast = TT.nearest_hit_fused(w16, world.fused_ops, lists, TT.RAY_TILE, world.tri_block, False)
    before = TT.nearest_hit_fused.launches
    dbg = TT.nearest_hit_fused(w16, world.fused_ops, lists, TT.RAY_TILE, world.tri_block, True)
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
