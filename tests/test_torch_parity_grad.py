"""The parity engine's live-ray mask, its winner indices and its backward
against the JAX package, on the CPU; and the f32 parity golden.

``trace_parity(..., alive=)`` (the plain version of kernel G1) gives a dead
ray the miss record and no work, and live rays JAX's records;
``HitRecord.model`` is the model whose ``closer`` fired last in JAX's scan
over models, re-derived here from JAX's per-model outputs;
``render_for_params(engine="parity")`` (G1 under ``no_grad``, the winner's
attributes gathered under autograd) gives JAX's loss and ``jax.grad``'s
gradients in parity and quality mode, as tests/test_torch_pallas_engine.py
holds the pallas engine.  JAX's quality-mode ``model_to_world`` gradient
holds NaN (ROADMAP C2); the port's is compared where JAX's is finite and
is finite everywhere.  Inputs come from seeded numpy and go to both
packages.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracerap_tpu.config import CameraConfig as JCameraConfig
from pathtracerap_tpu.diff import grad as JG
from pathtracerap_tpu.ops import intersect as JI
from pathtracerap_tpu.ops.math import transform_position as jax_transform_position
from pathtracerap_tpu.render.camera import generate_rays as jax_generate_rays
from pathtracerap_tpu.scene.build import build_cornell_box_scene as jax_cornell
from pathtracerap_tpu.scene.build import build_reference_scene as jax_reference
from pathtracerap_tpu_torch import CameraConfig, convert, read_bmp
from pathtracerap_tpu_torch.diff import grad as TG
from pathtracerap_tpu_torch.kernels.dda import grid_trace
from pathtracerap_tpu_torch.ops import intersect as PI
from pathtracerap_tpu_torch.ops.rng import prng_key
from pathtracerap_tpu_torch.render.wavefront import render_accumulate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, "assets", "golden")
CORNELL_CAMERA = dict(position=(0.0, 0.0, 150.0), plane_x=(-40.0, 40.0), plane_y=(-30.0, 30.0),
                      plane_z=100.0)
SCENES = {"cornell": (jax_cornell, CORNELL_CAMERA), "reference": (jax_reference, {})}
RES, SPP, BOUNCES, TILE = (16, 8), 2, 3, 64  # two RNG tiles
PARAMS = ("mat_color", "model_to_world")


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """As tests/test_torch_parity.py: the plain DDA's many small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields(obj) -> dict:
    return {f.name: (np.asarray(v) if v is not None and not isinstance(v, (int, tuple)) else v)
            for f in dataclasses.fields(obj) for v in [getattr(obj, f.name)]}


@functools.lru_cache(maxsize=None)
def _scene(name):
    """(JAX scene, the port's copy of it on the CPU)."""
    js = SCENES[name][0]().to_device()
    return js, convert.scene_from_numpy(_fields(js), "cpu")


def _rays(name, rng, n=768):
    """Primaries at 24x16 and n rays from anywhere toward anywhere, some
    with zero direction components."""
    ro, rd = jax_generate_rays(JCameraConfig(**SCENES[name][1]), (24, 16))
    spread = 150.0 if name == "cornell" else 600.0
    o = rng.uniform(-spread, spread, size=(n, 3)).astype(np.float32)
    d = (rng.uniform(-spread, spread, size=(n, 3)) - o).astype(np.float32)
    d[:48, 0] = 0.0
    d[48:96, 1:] = 0.0
    return np.concatenate([np.asarray(ro), o]), np.concatenate([np.asarray(rd), d])


@pytest.mark.parametrize("name", ["cornell", "reference"])
def test_plain_alive_mask(name, rng):
    """A dead ray gets the miss record (t = FLOAT_MAX, zero normal and
    colour, mat_type 0, mat_ri 1.5, model and triangle -1) and 0 steps and
    tests; the live rays' records and stats are JAX's trace_parity's (t and
    normal within atol 1e-5, the rest exact)."""
    js, ps = _scene(name)
    ro, rd = _rays(name, rng)
    alive = rng.uniform(size=ro.shape[0]) < 0.6
    jh, jst = jax.jit(lambda s, o, d: JI.trace_parity(s, o, d, return_stats=True))(js, ro, rd)
    ph, pst = grid_trace(ps, torch.from_numpy(ro), torch.from_numpy(rd),
                         alive=torch.from_numpy(alive), return_stats=True)
    live, dead = alive, ~alive
    # t and normal within atol 1e-5, as tests/test_torch_parity.py holds them
    for f in ("t", "normal"):
        np.testing.assert_allclose(getattr(ph, f).numpy()[live], np.asarray(getattr(jh, f))[live],
                                   rtol=0, atol=1e-5, err_msg=f)
    for f in ("mat_type", "mat_color", "mat_ri"):
        np.testing.assert_array_equal(getattr(ph, f).numpy()[live], np.asarray(getattr(jh, f))[live],
                                      err_msg=f)
    for f in ("steps", "tri_tests"):
        np.testing.assert_array_equal(pst[f].numpy()[live], np.asarray(jst[f])[live], err_msg=f)
        assert (pst[f].numpy()[dead] == 0).all(), f
    assert (ph.t.numpy()[dead] == PI.F_MAX).all() and (ph.normal.numpy()[dead] == 0).all()
    assert (ph.mat_type.numpy()[dead] == 0).all() and (ph.mat_color.numpy()[dead] == 0).all()
    assert (ph.mat_ri.numpy()[dead] == 1.5).all()
    assert (ph.model.numpy()[dead] == -1).all() and (ph.tri.numpy()[dead] == -1).all()
    assert (ph.t.numpy()[live] < PI.F_MAX).any() and (pst["tri_tests"].numpy()[live] > 0).any()


@pytest.mark.parametrize("name", ["cornell", "reference"])
def test_model_index_is_jax_scans_last_closer(name, rng):
    """HitRecord.model is the model whose ``closer`` fired last in JAX's
    scan over models (trace_parity, pathtracerap_tpu/ops/intersect.py:300),
    re-derived from JAX's per-model outputs on the same rays; -1 where none
    did.  HitRecord.tri is a triangle of that model's mesh whose averaged
    vertex normal, carried to the world, is the record's normal."""
    js, ps = _scene(name)
    ro, rd = _rays(name, rng)
    one = jax.jit(JI._dda_one_model)
    best_t = np.full(ro.shape[0], PI.F_MAX, np.float32)
    expect = np.full(ro.shape[0], -1, np.int32)
    for i in range(ps.num_models):
        is_int, t_m, _, ro_m, rd_m, _ = one(js, jnp.int32(i), ro, rd)
        world_pt = jax_transform_position(ro_m + rd_m * t_m[:, None], js.model_to_world[i])
        world_d = np.asarray(jnp.linalg.norm(world_pt - ro, axis=-1))
        closer = np.asarray(is_int) & (best_t > world_d)
        best_t = np.where(closer, world_d, best_t)
        expect = np.where(closer, i, expect)
    rec = PI.trace_parity(ps, torch.from_numpy(ro), torch.from_numpy(rd))
    np.testing.assert_array_equal(rec.model.numpy(), expect)
    hit = expect >= 0
    assert hit.any()
    tri = rec.tri.numpy()
    assert ((tri >= 0) == hit).all()
    vidx = ps.tri_vidx.long()
    mesh = ps.model_mesh.numpy()[expect[hit]]
    host = SCENES[name][0]()
    start, end = host.mesh_tri_start[mesh], host.mesh_tri_end[mesh]
    assert ((tri[hit] >= start) & (tri[hit] < end)).all()
    nm = PI.normal_matrix(ps.model_to_world)
    n_model = PI.averaged_normal(ps.vertex_nrm, vidx[torch.from_numpy(tri).long().clamp(min=0)])
    for k in np.unique(expect[hit]):
        sel = torch.from_numpy(expect == k)
        world = PI.normalize(PI.mat3_apply(nm[k], n_model[sel]))
        np.testing.assert_array_equal(world.numpy(), rec.normal[sel].numpy())


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grad(name, parity):
    js, _ = _scene(name)
    params = JG.extract_params(js, PARAMS)
    target = jnp.zeros((RES[0] * RES[1], 3), jnp.float32)

    def loss(p):
        return JG.image_loss(p, js, target, jax.random.PRNGKey(4),
                             JCameraConfig(**SCENES[name][1]), RES, SPP, BOUNCES, tile_size=TILE,
                             engine="parity", parity=parity)

    value, grads = jax.jit(jax.value_and_grad(loss))(params)
    return float(value), {k: np.asarray(v) for k, v in grads.items()}


def _port_loss_and_grad(name, parity):
    _, ps = _scene(name)
    return TG.loss_and_grad(TG.extract_params(ps, PARAMS), ps, torch.zeros((RES[0] * RES[1], 3)),
                            prng_key(4, "cpu"), CameraConfig(**SCENES[name][1]), RES, SPP,
                            BOUNCES, tile_size=TILE, engine="parity", parity=parity)


@pytest.mark.parametrize("parity", [True, False], ids=["parity", "quality"])
@pytest.mark.parametrize("name", ["cornell", "reference"])
def test_parity_diff_engine_matches_jax(name, parity):
    """render_for_params(engine="parity") against jax.grad through JAX's
    parity engine, 16x8 x 2 spp x 3 bounces on two 64-ray RNG tiles: the
    loss within rtol 1e-6, the mat_color gradient at rtol 1e-4 / atol 1e-7
    (tests/test_torch_pallas_engine.py:132-134); model_to_world's where
    JAX's is finite, and finite everywhere (C2: JAX's quality-mode one holds
    NaN)."""
    value, grads = _jax_loss_and_grad(name, parity)
    calls = PI.trace_parity.calls
    loss, g = _port_loss_and_grad(name, parity)
    assert PI.trace_parity.calls - calls == 1 + SPP * (BOUNCES - 1)
    np.testing.assert_allclose(loss.item(), value, rtol=1e-6)
    np.testing.assert_allclose(g["mat_color"].numpy(), grads["mat_color"], rtol=1e-4, atol=1e-7)
    assert (g["mat_color"] != 0).sum() > 0
    jm, pm = grads["model_to_world"], g["model_to_world"].numpy()
    finite = np.isfinite(jm)
    np.testing.assert_allclose(pm[finite], jm[finite], rtol=1e-4, atol=1e-7)
    assert np.isfinite(pm).all()
    if parity:
        assert finite.all() and (pm == 0).all()  # the normal reaches no colour in parity mode
    else:
        assert (pm != 0).any()


def test_parity_diff_forward_is_the_render():
    """The differentiable forward's image equals render_accumulate's on the
    parity engine bit for bit: the gathered attributes are the trace's."""
    _, ps = _scene("reference")
    for parity in (True, False):
        img = TG.render_for_params(TG.extract_params(ps, PARAMS), ps, prng_key(2, "cpu"),
                                   CameraConfig(), RES, SPP, BOUNCES, tile_size=TILE,
                                   engine="parity", parity=parity)
        acc = render_accumulate(ps, prng_key(2, "cpu"), CameraConfig(), RES, SPP, BOUNCES,
                                engine="parity", parity=parity, tile_size=TILE)
        assert torch.equal(img.detach(), acc / SPP), parity


def _down(x, f):
    h, w, _ = x.shape
    return x[: h - h % f, : w - w % f].reshape(h // f, f, w // f, f, 3).mean(axis=(1, 3))


@pytest.mark.parametrize("other, lower, upper", [
    ("reference_scene.bmp", None, 0.05), ("reference_scene_parity.bmp", 0.05, None)])
def test_f32_parity_golden_relations(other, lower, upper):
    """assets/golden/reference_scene_parity_f32.bmp (JAX's parity engine on
    the CPU in f32, tests/make_parity_golden_f32.py) sits near the fused
    golden (mean |diff| < 0.05) and away from the TPU's parity golden
    (> 0.05), read as tests/test_reference_golden.py reads them (both
    downsampled by 8)."""
    q = read_bmp(os.path.join(GOLDEN_DIR, "reference_scene_parity_f32.bmp")).astype(np.float32)
    g = read_bmp(os.path.join(GOLDEN_DIR, other)).astype(np.float32)
    assert q.shape == g.shape == (800, 1000, 3)
    dq, dg = _down(q / 255.0, 8), _down(g / 255.0, 8)
    mad = float(np.abs(dq - dg).mean())
    assert lower is None or mad > lower, mad
    assert upper is None or mad < upper, mad
    assert float(np.corrcoef(dq.ravel(), dg.ravel())[0, 1]) > 0.945
