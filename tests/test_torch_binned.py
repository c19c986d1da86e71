"""The port's binned engine (plain kernel 2) and render facade against the
JAX package's, run in interpret mode on the CPU."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from pathtracerap_tpu.config import CameraConfig, RenderConfig
from pathtracerap_tpu.io.bmp import read_bmp
from pathtracerap_tpu.ops.plucker import bake_world_triangles as jax_bake
from pathtracerap_tpu.pallas import megakernel as JM
from pathtracerap_tpu.pallas.trace import _slab_margin as jax_slab_margin
from pathtracerap_tpu.render.camera import generate_rays as jax_generate_rays
from pathtracerap_tpu.scene.build import build_reference_scene as jax_reference_scene
from pathtracerap_tpu_torch import Renderer, convert, effective_engine
from pathtracerap_tpu_torch.kernels import megakernel as TM
from pathtracerap_tpu_torch.kernels.trace import _slab_margin, trace_pallas
from pathtracerap_tpu_torch.ops.math import normalize
from pathtracerap_tpu_torch.ops.plucker import bake_world_triangles
from pathtracerap_tpu_torch.ops.rng import prng_key
from pathtracerap_tpu_torch.render.camera import generate_rays
from pathtracerap_tpu_torch.scene import build_reference_scene

GOLDEN = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "assets", "golden", "reference_scene.bmp",
)


def _fields(obj) -> dict:
    return {f.name: (np.asarray(v) if v is not None and not isinstance(v, (int, tuple)) else v)
            for f in dataclasses.fields(obj) for v in [getattr(obj, f.name)]}


def _down(x, f):
    h, w, _ = x.shape
    return x[: h - h % f, : w - w % f].reshape(h // f, f, w // f, f, 3).mean(axis=(1, 3))


@pytest.fixture(scope="module")
def worlds():
    jw = jax.jit(jax_bake)(jax_reference_scene().to_device())
    return bake_world_triangles(build_reference_scene().to_device("cpu")), jw


@pytest.fixture(scope="module")
def rays():
    return generate_rays(RenderConfig().camera, (32, 16), device="cpu")


def test_ray_tile_and_sub_block_predicate(worlds):
    world, jw = worlds
    assert TM.use_sub_blocks(world)
    assert TM.binned_ray_tile(world) == JM._binned_ray_tile(jw) == 256
    big = dataclasses.replace(world, block_aabb=world.block_aabb.repeat(11, 1))  # 66 blocks
    assert not TM.use_sub_blocks(big) and TM.binned_ray_tile(big) == 512


def test_sort_keys_and_morton_bounds_match_jax(worlds, rays):
    world, jw = worlds
    lo, hi = TM.scene_morton_bounds(world.block_aabb)
    jlo, jhi = JM.scene_morton_bounds(jw.block_aabb)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    g = np.random.default_rng(3)
    pack = np.concatenate(
        [g.uniform(-600, 900, size=(4096, 3)), g.normal(size=(4096, 3)),
         g.uniform(size=(4096, 3)), g.integers(0, 3, size=(4096, 1))], axis=1,
    ).astype(np.float32)
    np.testing.assert_array_equal(
        TM._sort_keys(torch.from_numpy(pack), lo, hi).numpy(),
        np.asarray(JM._sort_keys(pack, jlo, jhi)),
    )


@pytest.fixture(scope="module")
def wavefront(worlds, rays):
    """Bounce 1 of a 2-sample wavefront, sorted, with its uniforms."""
    world, _ = worlds
    ro, rd = rays
    rd_n = normalize(rd)
    hits0 = trace_pallas(world, ro, rd_n)
    pack, u_flat = TM.first_wavefront(world, ro, rd_n, hits0, prng_key(5, "cpu"), 0, 2, ro.shape[0], 4, True, 0)
    pix = torch.arange(pack.shape[0])
    pack, pix = TM.sort_wavefront(pack, pix, *TM.scene_morton_bounds(world.block_aabb))
    return pack, u_flat[:, 4:8][pix]


@pytest.mark.parametrize("parity", [True, False])
def test_bounce_matches_jax_bounce_call(worlds, wavefront, parity):
    """Plain kernel 2 through the port's worklists against the JAX
    ``_bounce_call`` (the Pallas bounce kernel) on the same pack."""
    world, jw = worlds
    pack, u = wavefront
    ray_tile = TM.binned_ray_tile(world)
    lists, unit = TM.bounce_lists(world, _slab_margin(world.block_aabb), pack, ray_tile)
    assert unit == 128 and lists.shape == (pack.shape[0] // ray_tile, 32)
    out, idx = TM.bounce(pack, u, lists, unit, world, ray_tile, parity)
    ref = np.asarray(JM._bounce_call(
        jw, jax_slab_margin(jw.block_aabb), pack.numpy(), u.numpy(), parity, ray_tile))
    # positions at scene scale (~1000 units): 1e-6 relative; unit vectors
    # and colors at 1e-6
    np.testing.assert_allclose(out[:, 0:3].numpy(), ref[:, 0:3], atol=1e-3, rtol=0)
    np.testing.assert_allclose(out[:, 3:9].numpy(), ref[:, 3:9], atol=1e-6, rtol=0)
    np.testing.assert_array_equal(out[:, 9].numpy(), ref[:, 9])
    live = pack[:, 9] > 0
    assert (out[live & (idx < 0), 9] == 0).all()  # a live ray that misses is killed
    assert (idx[live] >= 0).any()


def test_bounce_passes_dead_rays_through(worlds, wavefront):
    world, _ = worlds
    pack, u = wavefront
    dead = pack.clone()
    dead[::2, 9] = 0.0
    out, _ = TM.bounce_plain(dead, u, world, True)
    assert torch.equal(out[::2], dead[::2])


@pytest.mark.parametrize("n_samples, resolution", [(2, (32, 16)), (5, (8, 8))])
def test_render_samples_binned_matches_jax(worlds, n_samples, resolution):
    """The whole binned engine at 4 bounces (5 samples: one group of 4
    plus one single sample), at the engines' own tolerance."""
    world, jw = worlds
    ro, rd = generate_rays(RenderConfig().camera, resolution, device="cpu")
    jro, jrd = jax_generate_rays(RenderConfig().camera, resolution)
    port = TM.render_samples_binned(world, ro, rd, prng_key(7, "cpu"), n_samples, 4)
    ref = np.asarray(JM.render_samples_binned(jw, jro, jrd, jax.random.PRNGKey(7),
                                              n_samples=n_samples, max_bounces=4))
    np.testing.assert_allclose(port.numpy(), ref, atol=1e-5, rtol=0)


def test_port_renderer_on_the_jax_bake(worlds, rays):
    """The JAX bake carried across by convert.world_from_numpy renders in
    the port exactly as the port's own bake does."""
    world, jw = worlds
    ro, rd = rays
    carried = convert.world_from_numpy(_fields(jw), "cpu")
    a = TM.render_samples_binned(carried, ro, rd, prng_key(2, "cpu"), 1, 3)
    b = TM.render_samples_binned(world, ro, rd, prng_key(2, "cpu"), 1, 3)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)


def test_renderer_matches_committed_golden():
    """tests/test_reference_golden.py:59 on the port: 100x80, 4 spp."""
    res = (100, 80)
    r = Renderer(
        build_reference_scene().to_device("cpu"),
        RenderConfig(resolution=res, samples_per_pixel=4, max_bounces=5, engine="fused"),
        device="cpu",
    )
    assert r.engine == "binned"
    img = r.render(seed=5).numpy()
    assert img.shape == (80, 100, 3) and np.isfinite(img).all()
    golden = read_bmp(GOLDEN).astype(np.float32) / 255.0
    a, b = _down(img, 4), _down(_down(golden, 10), 4)
    mad = float(np.abs(a - b).mean())
    corr = float(np.corrcoef(a.ravel(), b.ravel())[0, 1])
    assert mad < 0.08, f"mean|diff| vs golden = {mad:.4f}"
    assert corr > 0.9, f"correlation vs golden = {corr:.4f}"


def test_effective_engine_routing(worlds):
    world, jw = worlds
    from pathtracerap_tpu.render.wavefront import effective_engine as jax_effective_engine

    for engine in ("fused", "binned", "mxu", "pallas", "parity"):
        for jitter in (False, True):
            assert effective_engine(engine, world, jitter) == jax_effective_engine(engine, jw, jitter)
    one_block = dataclasses.replace(world, block_aabb=world.block_aabb[:1])
    assert effective_engine("fused", one_block, False) == "fused"
    assert effective_engine("fused", dataclasses.replace(world, fused_ops=None), False) == "pallas"


@pytest.mark.parametrize("engine, item", [("mxu", "A10"), ("parity", "A10"), ("pallas", "A11")])
def test_renderer_names_missing_engines(engine, item):
    """Every engine is ported: the per-bounce ``mxu`` and ``pallas`` (A11)
    and the parity DDA (A10) render; a name the package does not know
    raises."""
    scene = build_reference_scene().to_device("cpu")
    cfg = RenderConfig(resolution=(8, 8), samples_per_pixel=1, max_bounces=2, engine=engine)
    with pytest.raises(ValueError, match="unknown engine"):
        Renderer(scene, RenderConfig(engine=engine + "_x"), device="cpu")
    r = Renderer(scene, cfg, device="cpu")
    assert r.engine == engine
    img = r.render(seed=1)
    assert img.shape == (8, 8, 3) and torch.isfinite(img).all() and img.mean() > 0.0


def test_renderer_rejects_jittered_camera():
    """The jittered camera is ported: ``binned`` routes to ``fused`` under
    jitter (binning relies on the primary-hit cache) and renders through
    kernel 4's plain version, one launch per sample."""
    scene = build_reference_scene().to_device("cpu")
    cfg = RenderConfig(resolution=(8, 8), samples_per_pixel=2, max_bounces=2, engine="binned",
                       camera=CameraConfig(jitter=True))
    r = Renderer(scene, cfg, device="cpu")
    assert r.engine == "fused"
    TM.sample_fused_plain.calls = TM.bounce_plain.calls = 0
    img = r.render(seed=1)
    assert TM.sample_fused_plain.calls == 2 and TM.bounce_plain.calls == 0
    assert img.shape == (8, 8, 3) and torch.isfinite(img).all() and img.mean() > 0.0


def test_renderer_device_must_hold_the_scene():
    scene = build_reference_scene().to_device("cpu")
    cfg = RenderConfig(resolution=(8, 8), engine="fused")
    assert Renderer(scene, cfg, device=torch.device("cpu")).device == scene.device
    with pytest.raises(ValueError, match="scene is on"):
        Renderer(scene, cfg, device="meta")


def test_render_to_bmp(tmp_path):
    cfg = RenderConfig(resolution=(16, 8), samples_per_pixel=2, max_bounces=2, engine="binned")
    r = Renderer(build_reference_scene().to_device("cpu"), cfg, device="cpu")
    path = str(tmp_path / "out.bmp")
    img = r.render_to_bmp(path, seed=1)
    back = read_bmp(path)
    assert back.shape == (8, 16, 3)
    expect = np.clip(np.trunc(img.numpy() * 2 * np.float32(0.5) * 255), 0, 255).astype(np.uint8)
    assert np.abs(back.astype(int) - expect.astype(int)).max() <= 1
