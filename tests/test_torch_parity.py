"""The port's parity DDA engine (the plain version of kernel G1) against the
JAX package's, on the CPU.

Mirrors tests/test_ops.py:34, :63, :80 (Moeller-Trumbore, the slab test,
``trace_parity`` on the Cornell box and the reference scene),
tests/test_render_golden.py:36's parity case (``render_sample`` against
JAX's and the scalar oracle), tests/test_debug_viz.py:20, :35,
tests/test_refraction.py:173, and the suite's gridparity row against JAX's
stepwise driver.  Inputs come from seeded numpy and go to both packages.
The port computes the traversal as XLA's CPU backend does (fused
multiply-adds where XLA fuses them, 1 / rd as |v| / v, a correctly
rounded sqrt), so t, normal, material, index of refraction and the stats
agree on every ray here; ``MAX_DIFFERING`` allows for rays that XLA's CPU
``rsqrt`` or a fusion the port cannot see would move (ROADMAP queue C):
0.1 %, none of which these inputs show.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracerap_tpu import bench_suite as JB
from pathtracerap_tpu.config import CameraConfig as JCamera
from pathtracerap_tpu.config import RenderConfig as JRenderConfig
from pathtracerap_tpu.ops import intersect as JI
from pathtracerap_tpu.ops.rng import sample_uniforms
from pathtracerap_tpu.oracle.reference import render_scalar
from pathtracerap_tpu.render import debug_viz as JV
from pathtracerap_tpu.render.camera import generate_rays as jax_generate_rays
from pathtracerap_tpu.render.wavefront import render_sample as jax_render_sample
from pathtracerap_tpu.scene.build import build_cornell_box_scene as jax_cornell
from pathtracerap_tpu.scene.build import build_reference_scene as jax_reference
from pathtracerap_tpu.scene.dsl import load_scene_file as jax_load_scene_file
from pathtracerap_tpu_torch import CameraConfig, RenderConfig, Renderer, convert, read_bmp
from pathtracerap_tpu_torch.bench_suite import render_gridparity
from pathtracerap_tpu_torch.kernels.dda import grid_trace
from pathtracerap_tpu_torch.ops import intersect as PI
from pathtracerap_tpu_torch.ops.rng import prng_key
from pathtracerap_tpu_torch.render.debug_viz import render_aovs, write_aov_bmps
from pathtracerap_tpu_torch.render.wavefront import _make_tracer, render_sample
from pathtracerap_tpu_torch.scene.dsl import load_scene_file

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GLASS = os.path.join(ROOT, "scenes", "glass_sphere.scn")
CORNELL_CAMERA = dict(position=(0.0, 0.0, 150.0), plane_x=(-40.0, 40.0), plane_y=(-30.0, 30.0),
                      plane_z=100.0)
MAX_DIFFERING = 0.001  # share of rays allowed to differ (XLA's CPU rsqrt, queue C)


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """The plain DDA issues thousands of small tensor ops; under a parallel
    test run every worker's intra-op thread pool competes for the same
    cores and each op's fork/join waits on the others (minutes, where one
    thread takes seconds)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields(obj) -> dict:
    return {f.name: (np.asarray(v) if v is not None and not isinstance(v, (int, tuple)) else v)
            for f in dataclasses.fields(obj) for v in [getattr(obj, f.name)]}


@pytest.fixture(scope="module")
def scenes():
    """{name: (JAX SceneDevice, the port's SceneDevice on the CPU)}."""
    out = {}
    for name, build in (("cornell", jax_cornell), ("reference", jax_reference)):
        js = build().to_device()
        out[name] = (js, convert.scene_from_numpy(_fields(js), "cpu"))
    return out


def _t(x):
    return torch.from_numpy(np.array(x))


def test_moller_trumbore_matches_jax(rng):
    n = 500
    v0 = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    v1 = v0 + rng.normal(size=(n, 3)).astype(np.float32)
    v2 = v0 + rng.normal(size=(n, 3)).astype(np.float32)
    ro = rng.uniform(-3, 3, size=(n, 3)).astype(np.float32)
    centroid = (v0 + v1 + v2) / 3.0
    rd = np.where((np.arange(n) % 2 == 0)[:, None], centroid - ro + 0.1 * rng.normal(size=(n, 3)),
                  rng.normal(size=(n, 3))).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    v2[:10] = v0[:10] + 2.0 * (v1[:10] - v0[:10])  # degenerate: det == 0
    acc_j, t_j = jax.jit(JI.moller_trumbore)(ro, rd, v0, v1, v2)
    acc_p, t_p = PI.moller_trumbore(*map(_t, (ro, rd, v0, v1, v2)))
    np.testing.assert_array_equal(acc_p.numpy(), np.asarray(acc_j))
    assert acc_p.sum() > 10 and not acc_p[:10].any()
    ok = acc_p.numpy()
    np.testing.assert_allclose(t_p.numpy()[ok], np.asarray(t_j)[ok], rtol=0, atol=1e-5)


def test_slab_matches_jax(rng):
    n = 300
    ro = rng.uniform(-3, 3, size=(n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    rd[:20, 0] = 0.0  # the zero-component branches
    rd[20:30, :2] = 0.0
    bb_min = np.array([-1, -1, -1], np.float32)
    bb_max = np.array([1, 2, 1], np.float32)
    with np.errstate(divide="ignore"):
        inv = (1.0 / rd).astype(np.float32)
    ok_j, t_j = jax.jit(JI.slab_test)(ro, rd, inv, bb_min, bb_max)
    ok_p, t_p = PI.slab_test(*map(_t, (ro, rd, inv, bb_min, bb_max)))
    np.testing.assert_array_equal(ok_p.numpy(), np.asarray(ok_j))
    np.testing.assert_array_equal(t_p.numpy(), np.asarray(t_j))


def _compare_hits(jh, js, ph, ps):
    """Rays that differ in any field (t and normal beyond atol 1e-5), held
    to MAX_DIFFERING; returns their count."""
    t_off = np.abs(ph.t.numpy() - np.asarray(jh.t)) > 1e-5
    n_off = (np.abs(ph.normal.numpy() - np.asarray(jh.normal)) > 1e-5).any(axis=1)
    other = ((ph.mat_type.numpy() != np.asarray(jh.mat_type))
             | (ph.mat_color.numpy() != np.asarray(jh.mat_color)).any(axis=1)
             | (ph.mat_ri.numpy() != np.asarray(jh.mat_ri))
             | (ps["steps"].numpy() != np.asarray(js["steps"]))
             | (ps["tri_tests"].numpy() != np.asarray(js["tri_tests"])))
    differ = t_off | n_off | other
    assert differ.mean() <= MAX_DIFFERING, f"{differ.sum()} of {differ.size} rays differ"
    return int(differ.sum())


def _trace_both(js, ps, ro, rd):
    jh, jst = jax.jit(lambda s, o, d: JI.trace_parity(s, o, d, return_stats=True))(js, ro, rd)
    ph, pst = PI.trace_parity(ps, _t(ro), _t(rd), return_stats=True)
    return jh, jst, ph, pst


@pytest.mark.parametrize("name, camera", [("cornell", CORNELL_CAMERA), ("reference", {})])
def test_trace_parity_primaries_match_jax(scenes, name, camera):
    """tests/test_ops.py:80 on the port: 64x48 primaries, every field and
    stat (0 of 3,072 rays differ)."""
    js, ps = scenes[name]
    ro, rd = jax_generate_rays(JCamera(**camera), (64, 48))
    jh, jst, ph, pst = _trace_both(js, ps, ro, rd)
    assert (ph.t.numpy() < 9999999.0).mean() > 0.9
    assert _compare_hits(jh, jst, ph, pst) == 0
    assert pst["steps"].sum() > 0 and pst["tri_tests"].sum() > 0


@pytest.mark.parametrize("name", ["cornell", "reference"])
def test_trace_parity_random_rays_match_jax(scenes, name, rng):
    """Rays from anywhere in and around the scene toward random targets,
    some with zero direction components."""
    js, ps = scenes[name]
    spread = 150.0 if name == "cornell" else 600.0
    n = 1024
    ro = rng.uniform(-spread, spread, size=(n, 3)).astype(np.float32)
    rd = (rng.uniform(-spread, spread, size=(n, 3)) - ro).astype(np.float32)
    rd[:64, 0] = 0.0
    rd[64:128, 1:] = 0.0
    jh, jst, ph, pst = _trace_both(js, ps, ro, rd)
    assert (ph.t.numpy() < 9999999.0).any()
    assert _compare_hits(jh, jst, ph, pst) == 0


def test_grid_trace_on_the_cpu_is_the_plain_version(scenes):
    _, ps = scenes["cornell"]
    ro, rd = (_t(x) for x in jax_generate_rays(JCamera(**CORNELL_CAMERA), (16, 8)))
    a, sa = grid_trace(ps, ro, rd, return_stats=True)
    b, sb = PI.trace_parity(ps, ro, rd, return_stats=True)
    for f in ("t", "normal", "mat_type", "mat_color", "mat_ri"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert torch.equal(sa["steps"], sb["steps"]) and torch.equal(sa["tri_tests"], sb["tri_tests"])
    with pytest.raises(ValueError, match="no kernel"):
        grid_trace(ps, ro.to("meta"), rd.to("meta"))


def test_grid_trace_scene_tables_made_once_a_scene(scenes):
    """G1's checked scene tables and normal matrices are made on a scene's
    first trace and reused; a scene made by ``replace`` or a
    ``model_to_world`` written in place gets them anew, and the checks
    still refuse a wrong table."""
    from pathtracerap_tpu_torch.kernels.dda import _scene_args

    cpu = torch.device("cpu")
    _, base = scenes["cornell"]
    ps = base.replace(model_to_world=base.model_to_world.clone())
    first = _scene_args(ps, cpu)
    assert _scene_args(ps, cpu) is first
    nmat = slice(24, 33)  # the normal matrix in a model's row
    assert torch.equal(first["models"][:, nmat], PI.normal_matrix(ps.model_to_world).reshape(-1, 9))
    other = ps.replace(mat_color=ps.mat_color.clone())
    assert not other.kernel_tables and _scene_args(other, cpu) is not first
    assert _scene_args(ps, cpu) is first
    ps.model_to_world.mul_(2.0)
    again = _scene_args(ps, cpu)
    assert again is not first
    assert torch.equal(again["models"][:, nmat], PI.normal_matrix(ps.model_to_world).reshape(-1, 9))
    with pytest.raises(ValueError, match="expected"):
        _scene_args(ps.replace(mat_type=ps.mat_type.long()), cpu)


def test_render_sample_parity_matches_jax_and_oracle(scenes):
    """tests/test_render_golden.py:36's parity case on the port: one sample
    of 5 bounces at 48x32 against JAX's render_sample (atol 1e-5) and the
    scalar oracle on the same uniforms (99.5 % of pixels within 5e-3)."""
    js, ps = scenes["cornell"]
    ro, rd = jax_generate_rays(JCamera(**CORNELL_CAMERA), (48, 32))
    n = ro.shape[0]
    key = jax.random.PRNGKey(7)
    jc = np.asarray(jax.jit(jax_render_sample, static_argnames=("max_bounces", "engine", "parity"))(
        js, ro, rd, key, 0, 5, engine="parity", parity=True))
    pc = render_sample(_make_tracer(ps, "parity"), _t(ro), _t(rd), prng_key(7, "cpu"), 0, 5,
                       parity=True).numpy()
    np.testing.assert_allclose(pc, jc, rtol=0, atol=1e-5)
    uniforms = np.stack([np.asarray(sample_uniforms(key, 0, 5 - b, n)) for b in range(5)])
    expect = render_scalar(jax_cornell(), np.asarray(ro), np.asarray(rd), uniforms, 5)
    close = np.all(np.abs(pc - expect) < 5e-3, axis=1)
    assert close.mean() >= 0.995, f"only {close.mean():.3f} of pixels match the oracle"
    np.testing.assert_allclose(pc[close], expect[close], atol=5e-3)


def test_renderer_parity_matches_jax(scenes):
    """Renderer(engine="parity") on the reference scene (no world bake;
    the primaries traced once and shared) against JAX's at 8x6, 2 spp,
    2 bounces."""
    from pathtracerap_tpu.render.wavefront import Renderer as JRenderer

    js, ps = scenes["reference"]
    kw = dict(resolution=(8, 6), samples_per_pixel=2, max_bounces=2, engine="parity")
    r = Renderer(ps, RenderConfig(**kw), device="cpu")
    assert r.engine == "parity" and r.world is None
    img = r.render(seed=3).numpy()
    ref = np.asarray(JRenderer(js, JRenderConfig(**kw)).render(seed=3))
    np.testing.assert_allclose(img, ref, rtol=0, atol=1e-5)


def test_gridparity_row_matches_jax_stepwise(scenes):
    """The suite's gridparity render (one RNG tile over every ray) against
    JAX's _render_parity_stepwise at 16x12, 2 spp, 5 bounces."""
    js, ps = scenes["reference"]
    kw = dict(resolution=(16, 12), samples_per_pixel=2, max_bounces=5, engine="parity")
    img = render_gridparity(ps, RenderConfig(**kw)).numpy()
    ref = JB._render_parity_stepwise(js, JRenderConfig(**kw))
    np.testing.assert_allclose(img, ref, rtol=0, atol=1e-5)


CFG = dict(resolution=(24, 16), camera=CORNELL_CAMERA)


def test_aovs_have_sane_content(scenes):
    """tests/test_debug_viz.py:20 on the port, and the AOVs equal JAX's."""
    js, ps = scenes["cornell"]
    aovs = render_aovs(ps, RenderConfig(resolution=CFG["resolution"],
                                         camera=CameraConfig(**CORNELL_CAMERA)))
    assert aovs["depth"].shape == (16, 24)
    assert aovs["hit"].mean() > 0.9
    d = aovs["depth"][aovs["hit"]]
    assert np.isfinite(d).all() and d.min() > 0
    assert aovs["dda_steps"].max() > 1
    assert aovs["tri_tests"].max() > 1
    n = aovs["normal"][aovs["hit"]]
    np.testing.assert_allclose(np.linalg.norm(n, axis=-1), 1.0, atol=1e-4)
    ref = JV.render_aovs(js, JRenderConfig(resolution=CFG["resolution"],
                                           camera=JCamera(**CORNELL_CAMERA)))
    for k, v in ref.items():
        np.testing.assert_allclose(aovs[k], v, rtol=0, atol=1e-5, equal_nan=True, err_msg=k)


def test_aov_bmps_written(scenes, tmp_path):
    """tests/test_debug_viz.py:35 on the port."""
    _, ps = scenes["cornell"]
    cfg = RenderConfig(resolution=CFG["resolution"], camera=CameraConfig(**CORNELL_CAMERA))
    paths = write_aov_bmps(ps, cfg, str(tmp_path / "aovs"))
    assert set(paths) == {"depth", "normal", "mat_type", "albedo", "hit", "dda_steps", "tri_tests"}
    for p in paths.values():
        assert read_bmp(p).shape == (16, 24, 3)


def test_parity_engine_carries_refractive_index():
    """tests/test_refraction.py:173 on the port: the glass scene file, and
    the same hit records as JAX's."""
    p = load_scene_file(GLASS)
    dev = p.scene.to_device("cpu")
    cam = dict(position=(0.0, 0.0, 110.0), plane_x=(-45.0, 45.0), plane_y=(-38.0, 30.0),
               plane_z=60.0)
    ro, rd = jax_generate_rays(JCamera(**cam), (32, 24))
    rec = PI.trace_parity(dev, _t(ro), _t(rd))
    hit = rec.t.numpy() < 9999999.0
    ri, mt = rec.mat_ri.numpy(), rec.mat_type.numpy()
    refr = hit & (mt == 3)  # REFRACTIVE
    assert refr.any(), "camera should see the glass sphere"
    np.testing.assert_allclose(ri[refr], 1.5, atol=1e-6)
    diff_hits = hit & (mt == 0)
    assert diff_hits.any()
    np.testing.assert_allclose(ri[diff_hits], 1.0, atol=1e-6)
    jrec = JI.trace_parity(jax_load_scene_file(GLASS).scene.to_device(), jnp.asarray(ro),
                           jnp.asarray(rd))
    np.testing.assert_array_equal(ri, np.asarray(jrec.mat_ri))
    np.testing.assert_allclose(rec.t.numpy(), np.asarray(jrec.t), rtol=0, atol=1e-5)
