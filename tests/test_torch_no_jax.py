"""The port renders and trains where JAX is absent: the machine with the GPU
has none.  It imports nothing of the JAX package either, not even its
jax-free host modules: it keeps its own copies (``tests/test_torch_host.py``
holds them equal).  That covers its utilities (checkpoint/resume, metrics,
profiling, debug checks), its profiling scripts and kernels, the parity DDA
engine, scene files and the AOV visualizer."""

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "pathtracerap_tpu_torch")
SCRIPTS = [os.path.join(ROOT, name) for name in ("chip_smoke.py", "profile_render.py")]

_RENDER_WITHOUT_JAX = """
import sys
sys.modules["jax"] = None
sys.modules["flax"] = None
import numpy as np
from pathtracerap_tpu_torch import CameraConfig, RenderConfig, Renderer, build_reference_scene
cfg = RenderConfig(resolution=(16, 16), samples_per_pixel=1, max_bounces=2, engine="fused")
img = Renderer(build_reference_scene().to_device("cpu"), cfg, device="cpu").render().numpy()
assert img.shape == (16, 16, 3) and np.isfinite(img).all() and 0.0 < img.mean() < 1.0
cfg = RenderConfig(resolution=(8, 8), samples_per_pixel=1, max_bounces=2, engine="fused",
                   parity=False, camera=CameraConfig(jitter=True))
r = Renderer(build_reference_scene().to_device("cpu"), cfg, device="cpu")
assert r.engine == "fused" and np.isfinite(r.render().numpy()).all()
cfg = RenderConfig(resolution=(8, 8), samples_per_pixel=1, max_bounces=2, engine="pallas")
assert np.isfinite(Renderer(build_reference_scene().to_device("cpu"), cfg, device="cpu").render().numpy()).all()
import torch
from pathtracerap_tpu_torch import extract_params, make_train_step
from pathtracerap_tpu_torch.bench_suite import suite_configs
from pathtracerap_tpu_torch.ops.rng import prng_key
assert "megascene" in suite_configs()
scene = build_reference_scene().to_device("cpu")
for engine in ("fused", "pallas"):
    step = make_train_step(scene, CameraConfig(), (16, 8), 1, 2, engine=engine)
    params = extract_params(scene)
    loss, new = step(params, torch.zeros(16 * 8, 3), prng_key(0, "cpu"))
    assert torch.isfinite(loss) and not torch.equal(new["mat_color"], params["mat_color"])
import io, tempfile
from pathtracerap_tpu_torch.scripts import (
    prof_kernel_parts, prof_kernel_parts2, prof_mega_sweep, prof_r5_shade,
)
from pathtracerap_tpu_torch.kernels import prof
from pathtracerap_tpu_torch.utils import MetricsLogger, load_checkpoint, profile_trace
from pathtracerap_tpu_torch.utils.debug import checked_trace
w = torch.randn(64, 16)
assert prof.parts("select", w, torch.randn(16, 64), torch.randn(16, 16), 8, 8, 2).shape == (64,)
cfg = RenderConfig(resolution=(8, 8), samples_per_pixel=2, samples_per_chunk=1, max_bounces=2,
                   engine="fused")
with tempfile.TemporaryDirectory() as tmp:
    log = MetricsLogger(cfg, stream=io.StringIO())
    with profile_trace(tmp):
        r = Renderer(build_reference_scene().to_device("cpu"), cfg, device="cpu")
        r.render(checkpoint_path=tmp + "/c.ckpt", metrics=log)
    assert load_checkpoint(tmp + "/c.ckpt").samples_done == 2 and len(log.chunks) == 2
from pathtracerap_tpu_torch.render.camera import generate_rays
checked_trace(r.world, *generate_rays(cfg.camera, (8, 8), device="cpu"))
# the parity DDA engine (kernels/dda.py, scene/grid.py), scene files (scene/dsl.py)
# and the AOV visualizer (render/debug_viz.py); its plain version's many small
# ops on one intra-op thread, as a parallel test run's workers share the cores
torch.set_num_threads(1)
from pathtracerap_tpu_torch.kernels.dda import grid_trace
from pathtracerap_tpu_torch.render.debug_viz import write_aov_bmps
from pathtracerap_tpu_torch.scene.dsl import load_scene_file, render_config_from_parsed
from pathtracerap_tpu_torch.scene.grid import build_uniform_grid
parsed = load_scene_file("scenes/diffuse_reference.scn")
pcfg = render_config_from_parsed(parsed, resolution=(8, 6), samples_per_pixel=1, max_bounces=2,
                                 engine="parity")
pscene = parsed.scene.to_device("cpu")
assert np.isfinite(Renderer(pscene, pcfg, device="cpu").render().numpy()).all()
hits = grid_trace(pscene, *(t.contiguous() for t in generate_rays(pcfg.camera, (8, 6), device="cpu")))
assert (hits.t < 9999999.0).any()
with tempfile.TemporaryDirectory() as tmp:
    assert len(write_aov_bmps(pscene, pcfg, tmp)) == 7
assert build_uniform_grid(np.zeros((1, 3, 3), np.float32), np.zeros(3), np.ones(3)).dims == (25, 25, 25)
loaded = sorted(m for m in sys.modules if m.startswith("pathtracerap_tpu.") and sys.modules[m])
print(" ".join(loaded))
"""

# modules of the JAX package the port may load: none
ALLOWED: set = set()


def test_port_renders_with_jax_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", _RENDER_WITHOUT_JAX], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded = set(proc.stdout.split())
    assert loaded <= ALLOWED, loaded - ALLOWED


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield from SCRIPTS


def test_port_sources_never_import_jax():
    jax = re.compile(r"^\s*(import|from)\s+(jax|flax|jaxlib)\b", re.M)
    # the JAX package itself, but not pathtracerap_tpu_torch
    reference = re.compile(r"^\s*(import|from)\s+pathtracerap_tpu(\.|\s|$)", re.M)
    for path in _sources():
        with open(path) as f:
            text = f.read()
        assert not jax.search(text), path
        assert not reference.search(text), path
