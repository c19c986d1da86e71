"""The port's scalar NumPy oracle (``pathtracerap_tpu_torch/oracle``), on the
port's ``SceneHost``.

Mirrors tests/test_ops.py:34, :63, :80, :142 and :160 with the port's ops
against the port's oracle, at the JAX tests' tolerances, and holds the
port's oracle equal to the JAX package's on the same scene and rays (the
same NumPy arithmetic: equal bit for bit).  Inputs come from seeded numpy.
"""

import numpy as np
import pytest
import torch

from pathtracerap_tpu import constants
from pathtracerap_tpu.oracle import reference as joracle
from pathtracerap_tpu.scene.build import build_cornell_box_scene as jax_cornell
from pathtracerap_tpu_torch.oracle import reference as oracle
from pathtracerap_tpu_torch.ops import intersect as PI
from pathtracerap_tpu_torch.ops.sampling import cosine_hemisphere, metal_scatter
from pathtracerap_tpu_torch.scene.build import build_cornell_box_scene


@pytest.fixture(scope="module")
def cornell():
    return build_cornell_box_scene()


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """The plain DDA's many small ops on one thread, as a parallel test
    run's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _triangles(rng, n):
    v0 = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    v1 = v0 + rng.normal(size=(n, 3)).astype(np.float32)
    v2 = v0 + rng.normal(size=(n, 3)).astype(np.float32)
    ro = rng.uniform(-3, 3, size=(n, 3)).astype(np.float32)
    centroid = (v0 + v1 + v2) / 3.0
    rd = np.where((np.arange(n) % 2 == 0)[:, None], centroid - ro + 0.1 * rng.normal(size=(n, 3)),
                  rng.normal(size=(n, 3))).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro, rd, v0, v1, v2


def _scene_rays(rng, n):
    ro = rng.uniform(-150, 150, size=(n, 3)).astype(np.float32)
    rd = (rng.uniform(-180, 180, size=(n, 3)).astype(np.float32) - ro).astype(np.float32)
    return ro, rd


def test_moller_trumbore_vs_oracle():
    """tests/test_ops.py:34."""
    ro, rd, v0, v1, v2 = _triangles(np.random.default_rng(34), 500)
    acc, t = (x.numpy() for x in PI.moller_trumbore(*map(_t, (ro, rd, v0, v1, v2))))
    hits = 0
    for i in range(ro.shape[0]):
        acc_o, t_o = oracle.mt_scalar(ro[i], rd[i], v0[i], v1[i], v2[i])
        assert acc[i] == acc_o, f"ray {i} accept mismatch"
        if acc_o:
            hits += 1
            np.testing.assert_allclose(t[i], t_o, rtol=2e-4, atol=2e-4)
    assert hits > 10


def test_slab_vs_oracle():
    """tests/test_ops.py:63, zero direction components included."""
    rng = np.random.default_rng(63)
    ro = rng.uniform(-3, 3, size=(300, 3)).astype(np.float32)
    rd = rng.normal(size=(300, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    rd[:20, 0] = 0.0
    bb_min = np.array([-1, -1, -1], np.float32)
    bb_max = np.array([1, 2, 1], np.float32)
    with np.errstate(divide="ignore"):
        inv = (1.0 / rd).astype(np.float32)
    ok, tmin = (x.numpy() for x in PI.slab_test(*map(_t, (ro, rd, inv, bb_min, bb_max))))
    for i in range(ro.shape[0]):
        ok_o, t_o = oracle.slab_scalar(ro[i], rd[i], inv[i], bb_min, bb_max)
        assert ok[i] == ok_o
        if ok_o:
            np.testing.assert_allclose(tmin[i], t_o, rtol=1e-5, atol=1e-5)


def test_trace_parity_vs_scalar_oracle(cornell):
    """tests/test_ops.py:80: the plain grid DDA against ``trace_scalar``."""
    ro, rd = _scene_rays(np.random.default_rng(80), 200)
    hits = PI.trace_parity(cornell.to_device("cpu"), _t(ro), _t(rd))
    t, nrm, mtype = hits.t.numpy(), hits.normal.numpy(), hits.mat_type.numpy()
    agree = 0
    for i in range(ro.shape[0]):
        o = oracle.trace_scalar(cornell, ro[i], rd[i])
        if abs(o["t"] - t[i]) < 5e-3 * max(1.0, abs(o["t"])):
            agree += 1
            if o["t"] < constants.FLOAT_MAX:
                assert mtype[i] == o["mat_type"], i
                np.testing.assert_allclose(nrm[i], o["normal"], atol=5e-3)
    assert agree >= ro.shape[0] - 2, f"only {agree}/{ro.shape[0]} rays agree"


def test_cosine_hemisphere_matches_oracle_and_distribution():
    """tests/test_ops.py:142."""
    rng = np.random.default_rng(142)
    normal = np.array([0.3, 0.8, -0.52], np.float32)
    normal /= np.linalg.norm(normal)
    n = 400
    u0 = rng.uniform(0, 1, n).astype(np.float32)
    u1 = rng.uniform(0, 1, n).astype(np.float32)
    out = cosine_hemisphere(_t(normal).expand(n, 3), _t(u0), _t(u1)).numpy()
    for i in range(0, n, 37):
        np.testing.assert_allclose(out[i], oracle._cosine_hemisphere(normal, u0[i], u1[i]),
                                   atol=1e-5)
    cos_t = out @ normal
    assert np.all(cos_t >= -1e-6)
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, atol=1e-5)
    assert abs(cos_t.mean() - 2.0 / 3.0) < 0.03


def test_metal_scatter_matches_oracle():
    """tests/test_ops.py:160."""
    rng = np.random.default_rng(160)
    n = 200
    normal = np.array([0.0, 1.0, 0.0], np.float32)
    d = np.array([0.6, -0.64, 0.48], np.float32)
    d /= np.linalg.norm(d)
    u2 = rng.uniform(0, 1, n).astype(np.float32)
    u3 = rng.uniform(0, 1, n).astype(np.float32)
    out = metal_scatter(_t(normal).expand(n, 3), _t(d).expand(n, 3), _t(u2), _t(u3)).numpy()
    for i in range(0, n, 23):
        np.testing.assert_allclose(out[i], oracle._metal_scatter(normal, d, u2[i], u3[i]),
                                   atol=1e-5)
    mirror = d - 2 * (d @ normal) * normal
    assert (out @ mirror).mean() > 0.9


def test_oracles_equal_on_the_same_inputs(cornell):
    """The port's oracle on the port's SceneHost equals JAX's on JAX's: the
    scalar primitives, the scene trace and a 3-bounce render."""
    rng = np.random.default_rng(7)
    ro, rd, v0, v1, v2 = _triangles(rng, 64)
    for i in range(ro.shape[0]):
        assert oracle.mt_scalar(ro[i], rd[i], v0[i], v1[i], v2[i]) == joracle.mt_scalar(
            ro[i], rd[i], v0[i], v1[i], v2[i])
        u = rng.uniform(0, 1, 2).astype(np.float32)
        np.testing.assert_array_equal(oracle._cosine_hemisphere(rd[i], *u),
                                      joracle._cosine_hemisphere(rd[i], *u))
        np.testing.assert_array_equal(oracle._metal_scatter(rd[i], ro[i] / 3, *u),
                                      joracle._metal_scatter(rd[i], ro[i] / 3, *u))
    jc = jax_cornell()
    sro, srd = _scene_rays(rng, 48)
    for i in range(sro.shape[0]):
        a, b = oracle.trace_scalar(cornell, sro[i], srd[i]), joracle.trace_scalar(jc, sro[i], srd[i])
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    uniforms = rng.uniform(0, 1, size=(3, sro.shape[0], 4)).astype(np.float32)
    np.testing.assert_array_equal(oracle.render_scalar(cornell, sro, srd, uniforms, 3),
                                  joracle.render_scalar(jc, sro, srd, uniforms, 3))
