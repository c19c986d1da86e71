"""The port's benchmark-suite scenes (tests/test_bench_suite.py on the port,
tiny shapes on the CPU), their host arrays against the JAX package's, and
the worklist kernels above JAX's streaming threshold of 313 blocks."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from pathtracerap_tpu import bench_suite as JB
from pathtracerap_tpu.config import RenderConfig as JRenderConfig
from pathtracerap_tpu.ops.plucker import bake_world_triangles as jax_bake
from pathtracerap_tpu.render.camera import generate_rays as jax_generate_rays
from pathtracerap_tpu.scene.build import build_reference_scene as jax_reference
from pathtracerap_tpu_torch import RenderConfig, Renderer, convert
from pathtracerap_tpu_torch.bench_suite import (
    _ROOM_CAMERA,
    build_highpoly_scene,
    build_multimesh_scene,
    run_config,
    suite_configs,
)
from pathtracerap_tpu_torch.kernels import megakernel as TM
from pathtracerap_tpu_torch.kernels import trace as TT
from pathtracerap_tpu_torch.ops.plucker import bake_world_triangles, trace_mxu
from pathtracerap_tpu_torch.ops.rng import prng_key
from pathtracerap_tpu_torch.render.camera import generate_rays
from pathtracerap_tpu_torch.render.wavefront import effective_engine

STREAM_BLOCKS = 313  # pathtracerap_tpu/pallas/megakernel.py:219


def _fields(obj) -> dict:
    return {f.name: (np.asarray(v) if v is not None and not isinstance(v, (int, tuple)) else v)
            for f in dataclasses.fields(obj) for v in [getattr(obj, f.name)]}


def test_suite_configs_cover_baseline():
    names = set(suite_configs().keys())
    assert names == set(JB.suite_configs().keys()) == {
        "cornell", "highpoly", "metallic", "multimesh", "gridparity", "megascene"}

    def plain(cfg):
        return {k: dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v
                for k, v in cfg.items()}

    for name, spec in suite_configs().items():
        ref = JB.suite_configs()[name]
        assert plain(spec["cfg"]) == plain(ref["cfg"]), name
        assert spec["measure_spp"] == ref["measure_spp"], name
        assert spec.get("engine") == ref.get("engine"), name


def test_multimesh_scene_renders():
    scene = build_multimesh_scene()
    assert scene.num_models == 6
    img = Renderer(
        scene.to_device("cpu"),
        RenderConfig(resolution=(32, 24), samples_per_pixel=1, max_bounces=3,
                     camera=_ROOM_CAMERA, engine="fused"),
        device="cpu",
    ).render().numpy()
    assert np.all(np.isfinite(img)) and img.max() > 0.01


def test_engine_routing_by_scene_size():
    """Many-block scenes route fused -> binned; a world of some 200k
    triangles keeps its pack above 313 blocks (the TPU's streamed range)
    and routes binned; the dense fallback starts above the pack budget."""
    world = bake_world_triangles(build_highpoly_scene(subdiv=128, use_asset=False).to_device("cpu"))
    assert world.fused_ops is not None
    assert world.block_aabb.shape[0] > 64
    assert effective_engine("fused", world, jitter=False) == "binned"
    assert effective_engine("fused", world, jitter=True) == "fused"

    world2 = bake_world_triangles(build_highpoly_scene(subdiv=224, use_asset=False).to_device("cpu"))
    assert world2.fused_ops is not None
    assert world2.block_aabb.shape[0] > STREAM_BLOCKS
    assert effective_engine("fused", world2, jitter=False) == "binned"
    nopack = dataclasses.replace(world2, fused_ops=None)
    assert effective_engine("fused", nopack, jitter=False) == "pallas"


def test_highpoly_regime_renders_on_binned_worklists():
    scene = build_highpoly_scene(subdiv=128, use_asset=False)
    r = Renderer(
        scene.to_device("cpu"),
        RenderConfig(resolution=(24, 16), samples_per_pixel=1, max_bounces=2,
                     camera=_ROOM_CAMERA, engine="fused"),
        device="cpu",
    )
    assert r.engine == "binned"
    img = r.render().numpy()
    assert np.all(np.isfinite(img)) and img.max() > 0.01


@pytest.mark.parametrize("name", ["cornell", "highpoly", "metallic", "multimesh", "megascene"])
def test_suite_scene_hosts_equal_jax(name):
    """Every suite scene's host arrays equal the JAX package's (the
    highpoly asset through the port's own OBJ import)."""
    port, ref = suite_configs()[name]["scene"](), JB.suite_configs()[name]["scene"]()
    for f in dataclasses.fields(port):
        np.testing.assert_array_equal(getattr(port, f.name), getattr(ref, f.name), err_msg=f.name)


def test_gridparity_names_its_item(monkeypatch):
    """The gridparity row runs the parity engine (ROADMAP A10), on the CPU
    when asked: here at a shrunken resolution."""
    import pathtracerap_tpu_torch.bench_suite as B

    real = B.suite_configs

    def small():
        cfgs = real()
        cfgs["gridparity"]["cfg"]["resolution"] = (8, 6)
        return cfgs

    monkeypatch.setattr(B, "suite_configs", small)
    # the plain DDA's many small ops: one intra-op thread (a parallel test
    # run's workers would otherwise fight over the cores on every op)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = run_config("gridparity", repeats=1, device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert out["engine"] == "parity" and out["resolution"] == [8, 6]
    assert 0.0 < out["image_mean"] < 1.0


def test_streamed_worklist_modes_match_jax(monkeypatch):
    """tests/test_megakernel.py:178 against the port: JAX's worklist
    kernels forced into their streamed mode (STREAM_BLOCKS = 2) and their
    SMEM row chunking (SMEM_LIST_INTS = 16) on the reference scene, 32x16,
    2 spp x 3 bounces.  The port's kernels read the pack from device
    memory at any block count: the same hits and the same image."""
    import pathtracerap_tpu.pallas.megakernel as JMK
    import pathtracerap_tpu.pallas.trace as JTR

    js = jax_reference().to_device()
    jw = jax.jit(jax_bake)(js)
    ro, rd = jax_generate_rays(JRenderConfig().camera, (32, 16))
    key = jax.random.PRNGKey(7)
    monkeypatch.setattr(JMK, "STREAM_BLOCKS", 2)
    monkeypatch.setattr(JTR, "SMEM_LIST_INTS", 16)
    h_j = JTR.trace_pallas(jw, ro, rd)
    img_j = np.asarray(JMK.render_samples_binned(jw, ro, rd, key, n_samples=2, max_bounces=3))

    world = bake_world_triangles(convert.scene_from_numpy(_fields(js), "cpu"))
    assert world.block_aabb.shape[0] > 2
    ro_t, rd_t = torch.from_numpy(np.array(ro)), torch.from_numpy(np.array(rd))
    h = TT.trace_pallas(world, ro_t, rd_t)
    img = TM.render_samples_binned(world, ro_t, rd_t, prng_key(7, "cpu"), 2, 3)
    np.testing.assert_allclose(h.t.numpy(), np.asarray(h_j.t), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(h.mat_type.numpy(), np.asarray(h_j.mat_type))
    np.testing.assert_allclose(img.numpy(), img_j, atol=1e-6)


def test_primary_worklists_above_313_blocks():
    """Above 313 blocks (a 200k-triangle sphere in the room: 391 blocks)
    the primary trace equals the brute-force tracer, and every hit's block
    is on its ray tile's frustum worklist, which lists real blocks only
    with its -1 padding at the end."""
    world = bake_world_triangles(build_highpoly_scene(subdiv=224, use_asset=False).to_device("cpu"))
    nb = world.block_aabb.shape[0]
    assert nb > STREAM_BLOCKS
    ro, rd = generate_rays(_ROOM_CAMERA, (8, 8), device="cpu")
    h, idx = TT.trace_pallas(world, ro, rd, return_idx=True)
    ref = trace_mxu(world, ro, rd)
    np.testing.assert_array_equal(h.t.numpy(), ref.t.numpy())
    assert (h.t < TT.F_MAX).all()
    _, lists = TT.primary_inputs(world, ro, rd)
    assert lists.shape == (1, nb)
    row = lists[0]
    listed = row[row >= 0]
    assert (row[listed.numel():] == -1).all() and (listed < nb).all()
    assert set((idx.long() // world.tri_block).tolist()) <= set(listed.tolist())
