"""PTAP_DEBUG mode on the port: the explicit det == 0 mask form of kernels
1, 2 and 4 (their plain versions here) and the invariant checks of
``utils/debug.checked_trace``.

The first five tests mirror ``tests/test_debug_mode.py`` on the Cornell box
at its tolerances.  The rest hold the port's debug forms to JAX's
``debug=True`` (``trace_pallas``, ``render_samples_binned``,
``render_samples_fused``, run in interpret mode) at 32x16, at the
tolerances of the port's trace, binned and fused tests: t at rtol 1e-6,
images at atol 1e-5 (XLA's CPU rsqrt, ROADMAP queue C).
"""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from pathtracerap_tpu.config import CameraConfig as JCameraConfig
from pathtracerap_tpu.config import RenderConfig as JRenderConfig
from pathtracerap_tpu.ops.plucker import bake_world_triangles as jax_bake
from pathtracerap_tpu.pallas import megakernel as JM
from pathtracerap_tpu.pallas import trace as JT
from pathtracerap_tpu.render.camera import generate_rays as jax_generate_rays
from pathtracerap_tpu.scene import build as JB
from pathtracerap_tpu_torch import CameraConfig, RenderConfig, Renderer, build_cornell_box_scene
from pathtracerap_tpu_torch.kernels import megakernel as TM
from pathtracerap_tpu_torch.kernels import trace as TT
from pathtracerap_tpu_torch.ops.plucker import bake_world_triangles
from pathtracerap_tpu_torch.ops.rng import prng_key
from pathtracerap_tpu_torch.render import wavefront
from pathtracerap_tpu_torch.render.camera import generate_rays
from pathtracerap_tpu_torch.scene import build_reference_scene
from pathtracerap_tpu_torch.utils import debug

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAMERA = dict(position=(0.0, 0.0, 150.0), plane_x=(-40.0, 40.0), plane_y=(-30.0, 30.0),
              plane_z=100.0)  # tests/test_debug_mode.py:22
ATOL = 1e-5


@pytest.fixture(scope="module")
def world():
    return bake_world_triangles(build_cornell_box_scene().to_device("cpu"))


@pytest.fixture(scope="module")
def worlds():
    """(port, JAX) worlds of the Cornell box and of the reference scene."""
    return {
        "cornell": (bake_world_triangles(build_cornell_box_scene().to_device("cpu")),
                    jax.jit(jax_bake)(JB.build_cornell_box_scene().to_device())),
        "reference": (bake_world_triangles(build_reference_scene().to_device("cpu")),
                      jax.jit(jax_bake)(JB.build_reference_scene().to_device())),
    }


# --------------------------------------------------------------------------
# tests/test_debug_mode.py on the port
# --------------------------------------------------------------------------


def test_debug_kernel_matches_fast_kernel_on_degenerates(world):
    ro, rd = debug.degenerate_rays(world)
    fast = TT.trace_pallas(world, ro, rd, debug=False)
    dbg = TT.trace_pallas(world, ro, rd, debug=True)
    np.testing.assert_allclose(fast.t.numpy(), dbg.t.numpy(), rtol=1e-6)
    np.testing.assert_array_equal(fast.mat_type.numpy(), dbg.mat_type.numpy())


def test_debug_megakernel_image_matches_fast(world):
    ro, rd = generate_rays(CameraConfig(**CAMERA), (16, 8), device="cpu")
    key = prng_key(0, "cpu")
    fast = TM.render_samples_fused(world, ro, rd, key, 2, 3, debug=False)
    dbg = TM.render_samples_fused(world, ro, rd, key, 2, 3, debug=True)
    np.testing.assert_allclose(fast.numpy(), dbg.numpy(), atol=1e-6)


def test_checked_trace_passes_on_healthy_scene(world):
    ro, rd = generate_rays(CameraConfig(**CAMERA), (16, 8), device="cpu")
    rec = debug.checked_trace(world, ro, rd)
    assert bool((rec.t < 1e30).any())


def test_checked_trace_fires_on_broken_invariant(world):
    """Marking every triangle invalid while leaving its geometry hittable
    violates the padding-rejection invariant: the check must raise."""
    broken = dataclasses.replace(world, valid=torch.zeros_like(world.valid))
    ro, rd = generate_rays(CameraConfig(**CAMERA), (16, 8), device="cpu")
    with pytest.raises(debug.TraceInvariantError, match="padding"):
        debug.checked_trace(broken, ro, rd)
    assert issubclass(debug.TraceInvariantError, RuntimeError)


def test_renderer_facade_debug_env(monkeypatch):
    """PTAP_DEBUG=1 runs the invariant checks inside render, on the first
    8,192 primaries, and the render is the same."""
    monkeypatch.setenv("PTAP_DEBUG", "1")
    seen = []
    checked = wavefront.checked_trace
    monkeypatch.setattr(wavefront, "checked_trace",
                        lambda w, ro, rd: seen.append(ro.shape[0]) or checked(w, ro, rd))
    scene = build_cornell_box_scene().to_device("cpu")
    cfg = RenderConfig(resolution=(16, 8), samples_per_pixel=1, max_bounces=2,
                       camera=CameraConfig(**CAMERA), engine="fused")
    img = Renderer(scene, cfg, device="cpu").render()
    assert seen == [16 * 8] and torch.isfinite(img).all()
    monkeypatch.setenv("PTAP_DEBUG", "0")
    assert torch.equal(Renderer(scene, cfg, device="cpu").render(), img)


# --------------------------------------------------------------------------
# the debug forms against JAX's debug=True
# --------------------------------------------------------------------------


def test_resolve_debug_follows_the_environment(monkeypatch):
    monkeypatch.delenv("PTAP_DEBUG", raising=False)
    assert not debug.debug_enabled() and not debug.resolve_debug(None)
    assert debug.resolve_debug(True) and not debug.resolve_debug(False)
    monkeypatch.setenv("PTAP_DEBUG", "1")
    assert debug.resolve_debug(None) and not debug.resolve_debug(False)


@pytest.mark.parametrize("scene", ["cornell", "reference"])
def test_debug_trace_matches_jax_debug(worlds, scene):
    """Kernel 1's debug form (plain) against JAX's ``trace_pallas(debug=True)``
    on the 32x16 camera rays and the degenerate rays."""
    port, jw = worlds[scene]
    cam = CAMERA if scene == "cornell" else {}
    jro, jrd = jax_generate_rays(JCameraConfig(**cam), (32, 16))
    dro, drd = debug.degenerate_rays(port)
    ro = np.concatenate([np.asarray(jro), dro.numpy()])
    rd = np.concatenate([np.asarray(jrd), drd.numpy()])
    jh, jidx = JT.trace_pallas(jw, ro, rd, return_idx=True, debug=True)
    calls = TT.nearest_hit_fused_plain.calls
    h, idx = TT.trace_pallas(port, torch.from_numpy(ro), torch.from_numpy(rd), return_idx=True,
                             debug=True)
    assert TT.nearest_hit_fused_plain.calls == calls + 1
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(h.t.numpy(), np.asarray(jh.t), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(h.mat_type.numpy(), np.asarray(jh.mat_type))


@pytest.mark.parametrize("parity", [True, False])
def test_debug_bounce_matches_jax_debug(worlds, parity):
    """Kernel 2's debug form (plain) against JAX's ``_bounce_call(debug=True)``
    on a sorted bounce-1 wavefront of the reference scene."""
    port, jw = worlds["reference"]
    ro, rd = generate_rays(RenderConfig().camera, (32, 16), device="cpu")
    rd = TT.normalize(rd)
    hits0 = TT.trace_pallas(port, ro, rd)
    pack, u_flat = TM.first_wavefront(port, ro, rd, hits0, prng_key(5, "cpu"), 0, 2, ro.shape[0],
                                      4, True, 0)
    pix = torch.arange(pack.shape[0])
    pack, pix = TM.sort_wavefront(pack, pix, *TM.scene_morton_bounds(port.block_aabb))
    u = u_flat[:, 4:8][pix]
    ray_tile = TM.binned_ray_tile(port)
    lists, unit = TM.bounce_lists(port, TT._slab_margin(port.block_aabb), pack, ray_tile)
    calls = TM.bounce_plain.calls
    out, _ = TM.bounce(pack, u, lists, unit, port, ray_tile, parity, debug=True)
    assert TM.bounce_plain.calls == calls + 1
    ref = np.asarray(JM._bounce_call(jw, JT._slab_margin(jw.block_aabb), pack.numpy(), u.numpy(),
                                     parity, ray_tile, debug=True))
    np.testing.assert_allclose(out[:, 0:3].numpy(), ref[:, 0:3], atol=1e-3, rtol=0)
    np.testing.assert_allclose(out[:, 3:9].numpy(), ref[:, 3:9], atol=1e-6, rtol=0)
    np.testing.assert_array_equal(out[:, 9].numpy(), ref[:, 9])


def test_debug_binned_render_matches_jax_debug(worlds):
    port, jw = worlds["reference"]
    ro, rd = generate_rays(RenderConfig().camera, (32, 16), device="cpu")
    jro, jrd = jax_generate_rays(JRenderConfig().camera, (32, 16))
    out = TM.render_samples_binned(port, ro, rd, prng_key(7, "cpu"), 5, 4, debug=True)
    ref = JM.render_samples_binned(jw, jro, jrd, jax.random.PRNGKey(7), n_samples=5,
                                   max_bounces=4, debug=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("jitter", [False, True])
def test_debug_fused_render_matches_jax_debug(worlds, jitter):
    """Kernel 4's debug form (plain): the Cornell box from its primary rows,
    and the reference scene with jittered primaries traced in the kernel."""
    scene = "reference" if jitter else "cornell"
    port, jw = worlds[scene]
    cam = dict(CAMERA) if scene == "cornell" else {}
    cfg, jcfg = CameraConfig(**cam, jitter=jitter), JCameraConfig(**cam, jitter=jitter)
    ro, rd = generate_rays(cfg, (32, 16), device="cpu")
    jro, jrd = jax_generate_rays(jcfg, (32, 16))
    step = ((cfg.plane_x[1] - cfg.plane_x[0]) / 32, (cfg.plane_y[1] - cfg.plane_y[0]) / 16)
    step = step if jitter else None
    calls = TM.sample_fused_plain.calls
    out = TM.render_samples_fused(port, ro, rd, prng_key(4, "cpu"), 3, 4, parity=not jitter,
                                  jitter_step=step, debug=True)
    assert TM.sample_fused_plain.calls > calls
    ref = JM.render_samples_fused(jw, jro, jrd, jax.random.PRNGKey(4), n_samples=3, max_bounces=4,
                                  parity=not jitter, jitter_step=step, debug=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_checked_trace_is_not_compiled_out():
    """Under ``python -O`` a bare assert would vanish; the checks stay."""
    code = (
        "import dataclasses, sys, torch\n"
        "sys.modules['jax'] = None\n"
        "from pathtracerap_tpu_torch import CameraConfig, build_cornell_box_scene\n"
        "from pathtracerap_tpu_torch.ops.plucker import bake_world_triangles\n"
        "from pathtracerap_tpu_torch.render.camera import generate_rays\n"
        "from pathtracerap_tpu_torch.utils.debug import TraceInvariantError, checked_trace\n"
        "w = bake_world_triangles(build_cornell_box_scene().to_device('cpu'))\n"
        "w = dataclasses.replace(w, valid=torch.zeros_like(w.valid))\n"
        f"ro, rd = generate_rays(CameraConfig(**{CAMERA!r}), (8, 4), device='cpu')\n"
        "try:\n"
        "    checked_trace(w, ro, rd)\n"
        "except TraceInvariantError:\n"
        "    print('raised')\n"
    )
    proc = subprocess.run([sys.executable, "-O", "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "raised"
