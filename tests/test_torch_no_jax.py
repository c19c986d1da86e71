"""The port runs where JAX is absent: the machine with the GPU has none."""

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "pathtracerap_tpu_torch")

_RENDER_WITHOUT_JAX = """
import sys
sys.modules["jax"] = None
sys.modules["flax"] = None
import numpy as np
from pathtracerap_tpu_torch import RenderConfig, Renderer, build_reference_scene
cfg = RenderConfig(resolution=(16, 16), samples_per_pixel=1, max_bounces=2, engine="fused")
img = Renderer(build_reference_scene().to_device("cpu"), cfg, device="cpu").render().numpy()
assert img.shape == (16, 16, 3) and np.isfinite(img).all() and 0.0 < img.mean() < 1.0
loaded = sorted(m for m in sys.modules if m.startswith("pathtracerap_tpu.") and sys.modules[m])
print(" ".join(loaded))
"""

# jax-free host modules of the JAX package the port may use
ALLOWED = {"pathtracerap_tpu.constants", "pathtracerap_tpu.config", "pathtracerap_tpu.io",
           "pathtracerap_tpu.io.obj", "pathtracerap_tpu.io.bmp", "pathtracerap_tpu.io.ply",
           "pathtracerap_tpu.native"}


def test_port_renders_with_jax_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", _RENDER_WITHOUT_JAX], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded = set(proc.stdout.split())
    assert loaded <= ALLOWED, loaded - ALLOWED


def test_port_sources_never_import_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|jaxlib)\b", re.M)
    for dirpath, _, files in os.walk(PKG):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(dirpath, name)) as f:
                    assert not pattern.search(f.read()), os.path.join(dirpath, name)
