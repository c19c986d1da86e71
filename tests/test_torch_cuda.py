"""The CUDA kernels against their plain PyTorch versions, on the GPU.

A CUDA kernel has no CPU mode, so these tests skip where no GPU is
present.  On the GPU machine (which has no JAX, so the JAX conftest is
left out):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

This file imports no JAX.
"""

import os

import numpy as np
import pytest
import torch

from pathtracerap_tpu_torch import CameraConfig, RenderConfig, Renderer, build_reference_scene, read_bmp
from pathtracerap_tpu_torch.kernels import megakernel as TM
from pathtracerap_tpu_torch.kernels import trace as TT
from pathtracerap_tpu_torch.ops.math import normalize, normalize_rsqrt
from pathtracerap_tpu_torch.ops.plucker import bake_world_triangles
from pathtracerap_tpu_torch.ops.rng import prng_key
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
