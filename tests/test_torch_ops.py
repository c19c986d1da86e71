"""The port's math, sampling, camera and shading against the JAX package.

Inputs are made with numpy from a seed and fed to both; outputs agree at
atol 1e-6 (XLA's CPU backend fuses some multiply-adds and rounds
transcendentals its own way, so last-ulp differences remain)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracerap_tpu.config import CameraConfig
from pathtracerap_tpu.ops import math as jmath
from pathtracerap_tpu.ops import sampling as jsamp
from pathtracerap_tpu.ops.intersect import HitRecord as JHit
from pathtracerap_tpu.render import camera as jcam
from pathtracerap_tpu.render import shade as jshade
from pathtracerap_tpu_torch.ops import math as tmath
from pathtracerap_tpu_torch.ops import rng
from pathtracerap_tpu_torch.ops import sampling as tsamp
from pathtracerap_tpu_torch.ops.intersect import HitRecord as THit
from pathtracerap_tpu_torch.render import camera as tcam
from pathtracerap_tpu_torch.render import shade as tshade

ATOL = 1e-6
N = 512


@pytest.fixture(scope="module")
def data():
    g = np.random.default_rng(7)
    a = g.normal(size=(N, 3)).astype(np.float32)
    b = g.normal(size=(N, 3)).astype(np.float32)
    n = a / np.linalg.norm(a, axis=1, keepdims=True)
    d = b / np.linalg.norm(b, axis=1, keepdims=True)
    u = g.uniform(0, 1, size=(N, 4)).astype(np.float32)
    m = g.normal(size=(N, 3, 3)).astype(np.float32) + 3 * np.eye(3, dtype=np.float32)
    return dict(a=a, b=b, n=n, d=d, u=u, m=m)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=atol, rtol=0)


@pytest.mark.parametrize(
    "fn, x, y",
    [("dot3", "a", "b"), ("cross3", "a", "b"),
     ("reflect_parity", "d", "n"), ("reflect_standard", "d", "n")],
)
def test_binary_math(data, fn, x, y):
    a, b = data[x], data[y]
    _close(getattr(tmath, fn)(_t(a), _t(b)), getattr(jmath, fn)(a, b))


def test_normalize_and_guarded(data):
    a = data["a"].copy()
    a[:4] = 0.0  # zero rows: guarded form returns +x
    _close(tmath.normalize(_t(data["a"])), jmath.normalize(data["a"]))
    _close(tmath.normalize(_t(a), eps=1e-6), jmath.normalize(a, eps=1e-6))
    _close(tmath.normalize_guarded(_t(a)), jmath.normalize_guarded(a))
    assert torch.equal(tmath.normalize_guarded(_t(a))[:4], torch.tensor([[1.0, 0, 0]] * 4))


def test_inv3x3(data):
    m = data["m"]
    _close(tmath.inv3x3(_t(m)), jmath.inv3x3(m), atol=1e-5)


def test_cosine_hemisphere(data):
    n, u = data["n"], data["u"]
    _close(tsamp.cosine_hemisphere(_t(n), _t(u[:, 0]), _t(u[:, 1])),
           jsamp.cosine_hemisphere(n, u[:, 0], u[:, 1]))


def test_metal_scatter(data):
    n, d, u = data["n"], data["d"], data["u"]
    _close(tsamp.metal_scatter(_t(n), _t(d), _t(u[:, 2]), _t(u[:, 3])),
           jsamp.metal_scatter(n, d, u[:, 2], u[:, 3]))


@pytest.mark.parametrize("parity", [True, False])
def test_coat_scatter(data, parity):
    n, d, u = data["n"], data["d"], data["u"]
    _close(tsamp.coat_scatter(_t(n), _t(d), _t(u[:, 0]), _t(u[:, 1]), _t(u[:, 2]), parity=parity),
           jsamp.coat_scatter(n, d, u[:, 0], u[:, 1], u[:, 2], parity=parity))


def test_refract_scatter(data):
    n, d, u = data["n"], data["d"], data["u"]
    ior = np.full((N, 1), 1.5, np.float32)
    ior[::3] = 2.4
    dt, ot = tsamp.refract_scatter(_t(n), _t(d), _t(ior), _t(u[:, 3]))
    dj, oj = jsamp.refract_scatter(n, d, ior, u[:, 3])
    _close(dt, dj)
    _close(ot, oj, atol=0)


@pytest.mark.parametrize("resolution", [(32, 16), (19, 7)])
def test_generate_rays(resolution):
    cam = CameraConfig()
    ro_j, rd_j = jcam.generate_rays(cam, resolution)
    ro_t, rd_t = tcam.generate_rays(cam, resolution, device="cpu")
    _close(ro_t, ro_j, atol=0)
    _close(rd_t, rd_j, atol=0)


def test_generate_rays_jitter_not_ported():
    """The jittered camera is ported: with a key its rays equal JAX's
    ``generate_rays(camera, resolution, key)``; without one they are the
    jitterless rays, as in JAX."""
    cam = CameraConfig(jitter=True)
    ro_j, rd_j = jcam.generate_rays(cam, (9, 4), jax.random.PRNGKey(3))
    ro_t, rd_t = tcam.generate_rays(cam, (9, 4), rng.prng_key(3, "cpu"))
    _close(ro_t, ro_j, atol=0)
    _close(rd_t, rd_j, atol=0)
    _close(tcam.generate_rays(cam, (9, 4), device="cpu")[1], jcam.generate_rays(cam, (9, 4))[1],
           atol=0)
    assert not torch.equal(rd_t, tcam.generate_rays(cam, (9, 4), device="cpu")[1])


def _shade_inputs(data):
    g = np.random.default_rng(11)
    orig = (g.normal(size=(N, 3)) * 300).astype(np.float32)
    direc = data["b"] * np.float32(3.0)  # unnormalized, as the camera makes them
    color = g.uniform(0.1, 1, size=(N, 3)).astype(np.float32)
    remaining = g.integers(0, 4, size=N).astype(np.int32)  # 0: dead lanes
    t = g.uniform(1, 800, size=N).astype(np.float32)
    t[::5] = 9999999.0  # miss lanes
    hit = t < 9999999.0
    normal = np.where(hit[:, None], data["n"], 0.0).astype(np.float32)  # zero on misses
    mat_type = g.integers(0, 7, size=N).astype(np.int32)  # every material
    mat_color = g.uniform(0, 1, size=(N, 3)).astype(np.float32)
    geom = np.where(hit[:, None], data["d"], 0.0).astype(np.float32)
    ri = g.uniform(1.2, 2.0, size=N).astype(np.float32)
    return orig, direc, color, remaining, t, normal, mat_type, mat_color, geom, ri


@pytest.mark.parametrize("parity", [True, False])
def test_shade(data, parity):
    orig, direc, color, remaining, t, normal, mt, mc, geom, ri = _shade_inputs(data)
    u = data["u"]
    js = jshade.shade(
        jshade.RayState(orig=jnp.asarray(orig), dir=jnp.asarray(direc), color=jnp.asarray(color),
                        remaining=jnp.asarray(remaining)),
        JHit(t=jnp.asarray(t), normal=jnp.asarray(normal), mat_type=jnp.asarray(mt),
             mat_color=jnp.asarray(mc), geom_normal=jnp.asarray(geom), mat_ri=jnp.asarray(ri)),
        jnp.asarray(u), parity=parity,
    )
    ts = tshade.shade(
        tshade.RayState(orig=_t(orig), dir=_t(direc), color=_t(color), remaining=_t(remaining)),
        THit(t=_t(t), normal=_t(normal), mat_type=_t(mt), mat_color=_t(mc),
             geom_normal=_t(geom), mat_ri=_t(ri)),
        _t(u), parity=parity,
    )
    # positions are at scene scale (hundreds of units): 1e-6 relative
    _close(ts.orig, js.orig, atol=1e-6 * 1000)
    _close(ts.dir, js.dir)
    _close(ts.color, js.color)
    np.testing.assert_array_equal(ts.remaining.numpy(), np.asarray(js.remaining))
    assert torch.isfinite(ts.dir).all() and torch.isfinite(ts.orig).all()
    dead = remaining <= 0
    assert torch.equal(ts.orig[dead], _t(orig)[dead]) and torch.equal(ts.color[dead], _t(color)[dead])


def test_gather_contribution(data):
    c = data["a"]
    ref = jshade.gather_contribution(jshade.RayState(orig=c, dir=c, color=c, remaining=c[:, 0]))
    port = tshade.gather_contribution(tshade.RayState(orig=_t(c), dir=_t(c), color=_t(c),
                                                      remaining=_t(c[:, 0])))
    _close(port, ref)
