"""The per-bounce ``pallas`` engine, render and diff, against the JAX
package: ``render_accumulate(engine="pallas")`` on the Cornell box and the
reference scene, with the fused pack (kernel 1's plain version) and
without it (kernel 5's), over several RNG tiles; and JAX's default diff
engine on the Cornell box (loss, gradients, the train step)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracerap_tpu.config import CameraConfig as JCameraConfig
from pathtracerap_tpu.diff import grad as JG
from pathtracerap_tpu.ops.plucker import bake_world_triangles as jax_bake
from pathtracerap_tpu.render.wavefront import render_accumulate as jax_render_accumulate
from pathtracerap_tpu.scene.build import build_cornell_box_scene as jax_cornell
from pathtracerap_tpu.scene.build import build_reference_scene as jax_reference
from pathtracerap_tpu_torch import CameraConfig, RenderConfig, Renderer, convert
from pathtracerap_tpu_torch.diff import grad as TG
from pathtracerap_tpu_torch.kernels import megakernel as TM
from pathtracerap_tpu_torch.kernels import trace as TT
from pathtracerap_tpu_torch.ops import plucker as TP
from pathtracerap_tpu_torch.ops.rng import prng_key
from pathtracerap_tpu_torch.render.wavefront import render_accumulate

CAM = dict(position=(0.0, 0.0, 150.0), plane_x=(-40.0, 40.0), plane_y=(-30.0, 30.0),
           plane_z=100.0)  # tests/test_grad.py:20-25
RES, SPP, BOUNCES = (16, 8), 4, 3
DIFF_SPP, DIFF_BOUNCES, DIFF_TILE = 2, 2, 256  # tests/test_grad.py:26-27, :39
SCENES = {"cornell": (jax_cornell, CAM), "reference": (jax_reference, {})}


def _fields(obj) -> dict:
    return {f.name: (np.asarray(v) if v is not None and not isinstance(v, (int, tuple)) else v)
            for f in dataclasses.fields(obj) for v in [getattr(obj, f.name)]}


@functools.lru_cache(maxsize=None)
def _scene(name):
    """(JAX scene, the port's copy of it on the CPU)."""
    js = SCENES[name][0]().to_device()
    return js, convert.scene_from_numpy(_fields(js), "cpu")


@pytest.mark.parametrize("pack", [True, False], ids=["pack", "nopack"])
@pytest.mark.parametrize("name", ["cornell", "reference"])
def test_render_accumulate_pallas_matches_jax(name, pack):
    """16x8 x 4 spp x 3 bounces with 64-ray RNG tiles (two of them): the
    port traces each bounce's whole wavefront at once and draws the same
    per-tile uniforms as JAX's tile scan."""
    js, scene = _scene(name)
    tile = None if not pack else 512
    jw = jax.jit(functools.partial(jax_bake, fused_tile=tile))(js)
    world = TP.bake_world_triangles(scene, fused_tile=tile)
    assert (world.fused_ops is not None) == pack == (jw.fused_ops is not None)
    cam = SCENES[name][1]
    ref = jax_render_accumulate(js, jax.random.PRNGKey(3), JCameraConfig(**cam), RES, SPP, BOUNCES,
                                engine="pallas", world=jw, tile_size=64)
    calls = TT.nearest_hit_plain.calls, TT.nearest_hit_fused_plain.calls
    acc = render_accumulate(scene, prng_key(3, "cpu"), CameraConfig(**cam), RES, SPP, BOUNCES,
                            engine="pallas", world=world, tile_size=64)
    dense = TT.nearest_hit_plain.calls - calls[0]
    listed = TT.nearest_hit_fused_plain.calls - calls[1]
    # one primary trace, then bounces 1 .. 2 of every sample
    assert (dense, listed) == ((0, 1 + SPP * 2) if pack else (1 + SPP * 2, 0))
    np.testing.assert_allclose(acc.numpy(), np.asarray(ref), atol=1e-5)
    assert acc.mean() > 0.0


def test_renderer_pallas_matches_mxu():
    """tests/test_pallas_trace.py:37 on the port: Renderer(engine="pallas")
    against engine="mxu", the Cornell box, 16x8 x 4 spp x 3 bounces."""
    _, scene = _scene("cornell")
    cfg = dict(resolution=RES, samples_per_pixel=SPP, max_bounces=BOUNCES,
               camera=CameraConfig(**CAM))
    img_p = Renderer(scene, RenderConfig(engine="pallas", **cfg), device="cpu").render()
    img_m = Renderer(scene, RenderConfig(engine="mxu", **cfg), device="cpu").render()
    np.testing.assert_allclose(img_p.numpy(), img_m.numpy(), atol=1e-5)


def test_renderer_pallas_jittered_matches_jax():
    """The quality camera on the per-bounce engine: every sample traces
    its own jittered primaries, drawn per RNG tile as JAX's tile scan."""
    js, scene = _scene("cornell")
    jcam = JCameraConfig(**CAM, jitter=True)
    jw = jax.jit(jax_bake)(js)
    ref = jax_render_accumulate(js, jax.random.PRNGKey(5), jcam, RES, 2, BOUNCES, engine="pallas",
                                parity=False, world=jw, tile_size=64)
    acc = render_accumulate(scene, prng_key(5, "cpu"), CameraConfig(**CAM, jitter=True), RES, 2,
                            BOUNCES, engine="pallas", parity=False, tile_size=64)
    np.testing.assert_allclose(acc.numpy(), np.asarray(ref), atol=1e-5)


@pytest.fixture(scope="module")
def jax_default_loss():
    """JAX's default diff engine on the Cornell box: the loss and the
    mat_color and vertex_pos gradients, zero target, PRNGKey(4)."""
    js, _ = _scene("cornell")
    params = JG.extract_params(js, ("mat_color", "vertex_pos"))
    target = jnp.zeros((RES[0] * RES[1], 3), jnp.float32)

    def loss(p):
        return JG.image_loss(p, js, target, jax.random.PRNGKey(4), JCameraConfig(**CAM), RES,
                             DIFF_SPP, DIFF_BOUNCES, tile_size=DIFF_TILE)

    value, grads = jax.jit(jax.value_and_grad(loss))(params)
    return float(value), {k: np.asarray(v) for k, v in grads.items()}


def _port_loss_and_grad(engine=TG.DEFAULT_DIFF_ENGINE, key=4, **kwargs):
    _, scene = _scene("cornell")
    params = TG.extract_params(scene, ("mat_color", "vertex_pos"))
    target = torch.zeros((RES[0] * RES[1], 3))
    return TG.loss_and_grad(params, scene, target, prng_key(key, "cpu"), CameraConfig(**CAM), RES,
                            DIFF_SPP, DIFF_BOUNCES, tile_size=DIFF_TILE, engine=engine, **kwargs)


def test_default_diff_engine_matches_jax(jax_default_loss):
    """The port's default engine is JAX's (``pallas``): loss within rtol
    1e-6, gradients at rtol 1e-4 (tests/test_grad.py:160's tolerance).  In
    parity mode color is a pure albedo product, so the vertex gradient is
    exactly zero on both sides."""
    assert TG.DEFAULT_DIFF_ENGINE == JG.DEFAULT_DIFF_ENGINE == "pallas"
    value, grads = jax_default_loss
    calls = TT.nearest_hit_fused_plain.calls
    loss, g = _port_loss_and_grad()
    assert TT.nearest_hit_fused_plain.calls > calls
    np.testing.assert_allclose(loss.item(), value, rtol=1e-6)
    for k in ("mat_color", "vertex_pos"):
        np.testing.assert_allclose(g[k].numpy(), grads[k], rtol=1e-4, atol=1e-7, err_msg=k)
    assert (g["mat_color"] != 0).sum() > 0 and (g["vertex_pos"] == 0).all()


def test_pallas_diff_grads_match_mxu_engine():
    """tests/test_grad.py:160 on the port: the kernel forward with the
    frozen-index recompute gives the gradients of differentiating straight
    through the brute-force tracer; in quality mode too, where the vertex
    gradient is not zero."""
    for parity in (True, False):
        l_p, g_p = _port_loss_and_grad("pallas", parity=parity)
        l_m, g_m = _port_loss_and_grad("mxu", parity=parity)
        np.testing.assert_allclose(l_p.item(), l_m.item(), rtol=1e-6)
        for k in ("mat_color", "vertex_pos"):
            np.testing.assert_allclose(g_p[k].numpy(), g_m[k].numpy(), rtol=1e-4, atol=1e-7,
                                       err_msg=f"{k} parity={parity}")
    assert (g_p["vertex_pos"] != 0).any()


def test_material_color_gradients_match_finite_difference():
    """tests/test_grad.py:44 on the port's default engine: central finite
    differences of the loss in a few mat_color entries (the same key, so
    the same frozen path topology)."""
    _, scene = _scene("cornell")
    target = torch.zeros((RES[0] * RES[1], 3))
    cam = CameraConfig(**CAM)

    def f(mat_color):
        return TG.image_loss({"mat_color": mat_color}, scene, target, prng_key(0, "cpu"), cam, RES,
                             DIFF_SPP, DIFF_BOUNCES, tile_size=DIFF_TILE)

    base = scene.mat_color.clone()
    _, g = TG.loss_and_grad({"mat_color": base}, scene, target, prng_key(0, "cpu"), cam, RES,
                            DIFF_SPP, DIFF_BOUNCES, tile_size=DIFF_TILE)
    g = g["mat_color"].numpy()
    assert np.isfinite(g).all() and np.abs(g).max() > 0.0
    rng = np.random.default_rng(0)
    checked = 0
    for _ in range(6):
        i, c = int(rng.integers(0, base.shape[0])), int(rng.integers(0, 3))
        if abs(g[i, c]) < 1e-6:
            continue
        eps = 1e-3
        hi, lo = base.clone(), base.clone()
        hi[i, c] += eps
        lo[i, c] -= eps
        fd = (f(hi).item() - f(lo).item()) / (2 * eps)
        np.testing.assert_allclose(g[i, c], fd, rtol=5e-2, atol=1e-4)
        checked += 1
    assert checked >= 2


def test_default_train_step_reduces_loss():
    """tests/test_grad.py:125 on the port: five steps of make_train_step
    with its default engine toward the render of darkened materials."""
    _, scene = _scene("cornell")
    cam = CameraConfig(**CAM)
    key = prng_key(2, "cpu")
    params = TG.extract_params(scene, ("mat_color",))
    target = TG.render_for_params({"mat_color": params["mat_color"] * 0.5}, scene, key, cam, RES,
                                  DIFF_SPP, DIFF_BOUNCES, tile_size=DIFF_TILE)
    step = TG.make_train_step(scene, cam, RES, DIFF_SPP, DIFF_BOUNCES, lr=0.2, tile_size=DIFF_TILE)
    losses, p = [], params
    for _ in range(5):
        loss, p = step(p, target.detach(), key)
        losses.append(loss.item())
    assert losses[-1] < losses[0] * 0.7, losses


def test_fused_diff_falls_back_to_pallas_without_pack(monkeypatch):
    """``render_for_params(engine="fused")`` on a world the bake left
    without a pack takes the per-bounce pallas path (kernel 5), as JAX's
    does (``diff/grad.py:79-86``): the same image as ``engine="pallas"``."""
    _, scene = _scene("cornell")
    params = TG.extract_params(scene)
    args = (scene, prng_key(1, "cpu"), CameraConfig(**CAM), RES, DIFF_SPP, DIFF_BOUNCES)
    monkeypatch.setattr(TP, "PACK_MAX_TRIANGLES", 0)
    calls = TT.nearest_hit_plain.calls, TM.sample_fused_plain.calls
    img = TG.render_for_params(params, *args, tile_size=DIFF_TILE, engine="fused")
    assert TT.nearest_hit_plain.calls > calls[0] and TM.sample_fused_plain.calls == calls[1]
    ref = TG.render_for_params(params, *args, tile_size=DIFF_TILE, engine="pallas")
    assert torch.equal(img, ref) and img.max() > 0
