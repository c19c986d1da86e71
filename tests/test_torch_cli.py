"""The port's command line (``python -m pathtracerap_tpu_torch.cli``) against
the JAX package's, on the CPU (``--device cpu``).

Mirrors tests/test_dsl_cli.py:177, :198, :214 and :253 on the same scene
text: ``render``'s BMP against the one JAX's CLI writes for the same flags
(mean byte within 0.5, at least 99 % of the bytes within 1: the chaotic
5-bounce paths of a few pixels may round the other way), ``info``'s JSON
key for key, ``invert``'s printed losses (rtol 1e-4) and final
``mat_color`` (1e-4), kill and resume, and ``--dp`` over two ranks (two
CLI processes under ``gloo``, launched with a deadline) against the
one-rank run.  Also ``benchmark`` and ``visualize``, a ``.ply`` mesh in a
scene file, and the refusal to run on a card that is not there.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from pathtracerap_tpu.cli import main as jax_cli
from pathtracerap_tpu.io.bmp import read_bmp as jax_read_bmp
from pathtracerap_tpu_torch.cli import main as cli
from pathtracerap_tpu_torch.io.bmp import read_bmp
from pathtracerap_tpu_torch.io.ply import save_ply
from pathtracerap_tpu_torch.parallel.dryrun import run_local_ranks
from pathtracerap_tpu_torch.scene.build import make_box_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_dsl_cli.py:18's scene
SCENE_TEXT = """
# materials
DIFFUSE white
color: [0.9, 0.9, 0.9]

EMISSIVE lamp
color: [0.99, 0.99, 0.99]

METAL chrome
color: [0.8, 0.8, 0.9]

BOX room
min: [-100, -100, -100]
max: [100, 100, 100]
material: white

SPHERE ball
radius: 20
subdiv: 8
translate: [0, -40, 0]
material: chrome

BOX panel
min: [-30, -2, -30]
max: [30, 2, 30]
translate: [0, 95, 0]
material: lamp

CAMERA
position: [0, 0, 90]
plane_x: [-40, 40]
plane_y: [-40, 40]
plane_z: 60

RENDER
resolution: [24, 24]
spp: 4
bounces: 3
engine: mxu
"""
INVERT = ["invert", "--steps", "3", "--spp", "2", "--bounces", "2"]
CPU = ["--device", "cpu"]


@pytest.fixture()
def scene_file(tmp_path):
    path = tmp_path / "scene.txt"
    path.write_text(SCENE_TEXT)
    return str(path)


def _losses(out):
    return [float(l.split("loss=")[1]) for l in out.splitlines() if l.startswith("step ")]


def _final_params(out):
    tail = out.split("optimized mat_color:")[1]
    return np.asarray([float(x) for x in re.findall(r"-?\d+\.\d+", tail)], np.float32)


def _ranks(args, n=2, timeout=120):
    """The CLI as ``n`` ranks (torchrun's variables set); rank 0's output."""
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    results = run_local_ranks(
        lambda r: [sys.executable, "-m", "pathtracerap_tpu_torch.cli"] + args, n,
        timeout=timeout, env=env, cwd=ROOT)
    assert all(rc == 0 for rc, _ in results), "\n".join(t[-3000:] for _, t in results)
    return results[0][1]


def test_cli_render_and_info_match_jax(tmp_path, capsys, scene_file):
    """tests/test_dsl_cli.py:177."""
    out, ref = tmp_path / "port.bmp", tmp_path / "jax.bmp"
    assert cli(["render", "--scene", scene_file, "--out", str(out), "--quiet"] + CPU) == 0
    assert jax_cli(["render", "--scene", scene_file, "--out", str(ref), "--quiet"]) == 0
    img, jimg = read_bmp(str(out)), jax_read_bmp(str(ref))
    assert img.shape == jimg.shape == (24, 24, 3)
    d = np.abs(img.astype(int) - jimg.astype(int))
    assert abs(img.astype(float).mean() - jimg.astype(float).mean()) < 0.5
    assert (d <= 1).mean() >= 0.99, (d <= 1).mean()
    capsys.readouterr()

    assert cli(["info", "--scene", scene_file] + CPU) == 0
    stats = json.loads(capsys.readouterr().out)
    assert jax_cli(["info", "--scene", scene_file]) == 0
    assert stats == json.loads(capsys.readouterr().out)
    assert stats["models"] == 3


def test_cli_render_prints_as_jax_does(tmp_path, capsys, scene_file):
    out = tmp_path / "o.bmp"
    assert cli(["render", "--scene", scene_file, "--out", str(out)] + CPU) == 0
    printed = capsys.readouterr()
    assert printed.out.strip() == f"wrote {out} (24x24, 4 spp, engine=mxu)"
    assert "[metrics] render" in printed.err


def test_cli_invert_self_demo_matches_jax(capsys, scene_file):
    """tests/test_dsl_cli.py:198: the loss falls, and the printed losses and
    final colours are JAX's."""
    assert cli(INVERT + ["--scene", scene_file] + CPU) == 0
    out = capsys.readouterr().out
    assert jax_cli(INVERT + ["--scene", scene_file]) == 0
    jout = capsys.readouterr().out
    losses, jlosses = _losses(out), _losses(jout)
    assert len(losses) == 3 and losses[2] < losses[0]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    np.testing.assert_allclose(_final_params(out), _final_params(jout), rtol=0, atol=1e-4)


def test_cli_invert_checkpoint_resume_matches_unbroken(tmp_path, capsys, scene_file):
    """tests/test_dsl_cli.py:214: kill and resume gives the unbroken run's
    parameters; a checkpoint of another config or target is refused."""
    common = ["invert", "--scene", scene_file, "--spp", "2", "--bounces", "2"] + CPU
    assert cli(common + ["--steps", "4"]) == 0
    unbroken = _final_params(capsys.readouterr().out)
    ck = str(tmp_path / "invert.ckpt.npz")
    assert cli(common + ["--steps", "2", "--checkpoint", ck]) == 0
    capsys.readouterr()
    assert cli(common + ["--steps", "4", "--checkpoint", ck]) == 0
    out = capsys.readouterr().out
    assert "resuming from step 2" in out
    np.testing.assert_allclose(_final_params(out), unbroken, rtol=1e-6, atol=1e-7)
    with pytest.raises(SystemExit, match="different invert config"):
        cli(common + ["--steps", "4", "--checkpoint", ck, "--lr", "0.05"])
    target = tmp_path / "target.bmp"
    assert cli(["render", "--scene", scene_file, "--out", str(target), "--quiet"] + CPU) == 0
    with pytest.raises(SystemExit, match="different target image"):
        cli(common + ["--steps", "4", "--checkpoint", ck, "--target", str(target)])
    with pytest.raises(SystemExit, match="render is 32x24"):
        cli(common + ["--steps", "1", "--target", str(target), "--width", "32", "--height", "24"])


def test_cli_invert_dp_two_ranks_match_one(capsys, scene_file):
    """tests/test_dsl_cli.py:253: ``--dp`` over two CLI processes lowers the
    loss and prints the one-rank run's losses within rtol 1e-5."""
    out = _ranks(INVERT + ["--scene", scene_file, "--dp"] + CPU)
    losses = _losses(out)
    assert len(losses) == 3 and losses[2] < losses[0]
    assert cli(INVERT + ["--scene", scene_file, "--dp"] + CPU) == 0
    np.testing.assert_allclose(losses, _losses(capsys.readouterr().out), rtol=1e-5)


def test_cli_render_dp_two_ranks_writes_the_same_bmp(tmp_path, scene_file):
    """``render --dp`` over two ranks: rank 0 alone writes, and the BMP is
    the single-process CLI's, byte for byte."""
    dp, one = tmp_path / "dp.bmp", tmp_path / "one.bmp"
    out = _ranks(["render", "--scene", scene_file, "--out", str(dp), "--dp"] + CPU)
    assert f"wrote {dp} (DP over 2 devices)" in out
    assert cli(["render", "--scene", scene_file, "--out", str(one), "--quiet"] + CPU) == 0
    assert dp.read_bytes() == one.read_bytes()


def test_cli_benchmark_has_jax_keys(capsys, scene_file):
    assert cli(["benchmark", "--scene", scene_file, "--repeats", "1"] + CPU) == 0
    port = json.loads(capsys.readouterr().out)
    assert jax_cli(["benchmark", "--scene", scene_file, "--repeats", "1"]) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert port.keys() == ref.keys()
    for k in ("engine", "resolution", "spp", "bounces"):
        assert port[k] == ref[k], k
    # Mrays/s are rounded to 2 places: a loaded CPU may read 0.0
    assert port["best_wall_s"] > 0 and port["mrays_per_s"] >= 0
    assert cli(["benchmark", "--scene", scene_file, "--repeats", "1", "--scaling"] + CPU) == 0
    rep = json.loads(capsys.readouterr().out)
    assert [r["devices"] for r in rep["rows"]] == [1] and rep["rows"][0]["efficiency"] == 1.0


def test_cli_visualize_writes_jax_aovs(tmp_path, capsys, scene_file):
    """``visualize`` through the grid DDA: the same BMP names, printed as
    JAX prints them, and the same first-hit masks."""
    pdir, jdir = tmp_path / "port", tmp_path / "jax"
    assert cli(["visualize", "--scene", scene_file, "--out-dir", str(pdir)] + CPU) == 0
    printed = capsys.readouterr().out.splitlines()
    assert jax_cli(["visualize", "--scene", scene_file, "--out-dir", str(jdir)]) == 0
    jprinted = capsys.readouterr().out.splitlines()
    assert [l.split(":")[0] for l in printed] == [l.split(":")[0] for l in jprinted]
    assert len(printed) == 7
    np.testing.assert_array_equal(read_bmp(str(pdir / "hit.bmp")),
                                  jax_read_bmp(str(jdir / "hit.bmp")))


def test_cli_renders_a_ply_mesh_from_a_scene_file(tmp_path, capsys):
    save_ply(str(tmp_path / "box.ply"), make_box_mesh(size=(0.2, 0.2, 0.2)))
    scene = SCENE_TEXT.replace("SPHERE ball\nradius: 20\nsubdiv: 8\n",
                               "MESH ball\nfile: box.ply\n")
    path = tmp_path / "ply_scene.txt"
    path.write_text(scene)
    out = tmp_path / "ply.bmp"
    assert cli(["render", "--scene", str(path), "--out", str(out), "--quiet"] + CPU) == 0
    img = read_bmp(str(out))
    assert img.shape == (24, 24, 3) and img.max() > 0
    assert cli(["info", "--scene", str(path)] + CPU) == 0
    stats = json.loads(capsys.readouterr().out)
    assert jax_cli(["info", "--scene", str(path)]) == 0
    assert stats == json.loads(capsys.readouterr().out)
    assert stats["triangles"] == 12 + 12 + 12


def test_cli_without_a_card_exits_nonzero(scene_file):
    """The card is the default: with none, and no ``--device cpu``, every
    command exits non-zero with a message and does not carry on."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli(["info", "--scene", scene_file])
    proc = subprocess.run([sys.executable, "-m", "pathtracerap_tpu_torch.cli", "render",
                           "--scene", scene_file, "--out", os.devnull], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
