"""The port renders and trains where JAX is absent: the machine with the GPU
has none.  It imports nothing of the JAX package either, not even its
jax-free host modules: it keeps its own copies (``tests/test_torch_host.py``
holds them equal).  That covers its utilities (checkpoint/resume, metrics,
profiling, debug checks), its profiling scripts and kernels, the parity DDA
engine, scene files, the AOV visualizer, the command line, the data-parallel
layer, the geometry ring, the PLY loader, the scalar oracle and the native
host library, whose build reads the port's own copy of its source."""

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
# the command line, the data-parallel layer (one rank), the PLY loader and the oracle
import contextlib
from pathtracerap_tpu_torch import cli
from pathtracerap_tpu_torch.io.ply import load_ply, save_ply
from pathtracerap_tpu_torch.oracle import render_scalar
from pathtracerap_tpu_torch.parallel import default_mesh, render_image_dp
from pathtracerap_tpu_torch.parallel.dryrun import run_local_ranks
from pathtracerap_tpu_torch.utils.failure import liveness_probe
with contextlib.redirect_stdout(io.StringIO()) as info:
    assert cli.main(["info", "--scene", "scenes/glass_sphere.scn", "--device", "cpu"]) == 0
assert '"models"' in info.getvalue()
cscene = build_reference_scene().to_device("cpu")
dcfg = RenderConfig(resolution=(16, 8), samples_per_pixel=1, max_bounces=2, engine="fused")
dp = render_image_dp(cscene, dcfg, mesh=default_mesh("cpu"))
assert torch.equal(dp, Renderer(cscene, dcfg, device="cpu").render()) and liveness_probe() == 1
# the geometry ring (one rank) and the native host library
from pathtracerap_tpu_torch import native
from pathtracerap_tpu_torch.io.obj import load_obj
from pathtracerap_tpu_torch.parallel import render_image_geometry_sharded
gcfg = RenderConfig(resolution=(16, 8), samples_per_pixel=1, max_bounces=2, engine="pallas")
ring = render_image_geometry_sharded(cscene, gcfg, mesh=default_mesh("cpu"), tile_size=64)
assert torch.isfinite(ring).all() and ring.max() > 0
assert load_obj("assets/meshes/ceiling_light.obj", backend="native").num_triangles > 0
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


_NATIVE_BUILD = """
import os, pathlib, sys
seen = []
def hook(event, args):
    if event == "open" and isinstance(args[0], (str, bytes, os.PathLike)):
        seen.append(os.fsdecode(args[0]))
    elif event == "subprocess.Popen":
        seen.extend(os.fsdecode(a) for a in args[1] if isinstance(a, (str, bytes, os.PathLike)))
sys.addaudithook(hook)
sys.modules["jax"] = None
import numpy as np
from pathtracerap_tpu_torch import native
from pathtracerap_tpu_torch.io.bmp import write_bmp
from pathtracerap_tpu_torch.io.obj import load_obj
from pathtracerap_tpu_torch.scene.grid import build_uniform_grid
native.BUILD_DIR = pathlib.Path(sys.argv[1])
assert native.available(), native.build_error
mesh = load_obj("assets/meshes/ceiling_light.obj", backend="native")
build_uniform_grid(mesh.positions[mesh.triangles], mesh.bbox_min, mesh.bbox_max, backend="native")
write_bmp(os.path.join(sys.argv[1], "x.bmp"), np.zeros((2, 2, 3), np.uint8), backend="native")
print("\\n".join(seen))
"""


def test_native_build_reads_only_the_port(tmp_path):
    """The native library builds (in a fresh build directory) from the
    port's ``host/ptap_native.cc``: no file under ``native/`` or the JAX
    package is opened or handed to the compiler."""
    proc = subprocess.run([sys.executable, "-c", _NATIVE_BUILD, str(tmp_path)], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    seen = [os.path.realpath(os.path.join(ROOT, p)) for p in proc.stdout.splitlines() if p]
    source = os.path.join(PKG, "host", "ptap_native.cc")
    assert source in seen  # the hook saw the compiler's input
    for banned in (os.path.join(ROOT, "native"), os.path.join(ROOT, "pathtracerap_tpu")):
        assert not [p for p in seen if p == banned or p.startswith(banned + os.sep)], banned
    assert list(tmp_path.glob("libptap_native_*.so"))


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
