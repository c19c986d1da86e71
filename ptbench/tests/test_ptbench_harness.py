"""The harness: found by name, strict about names, refusing the CPU, free of
JAX, and failing ``correct`` on a broken timed path and on the control.

The runs here go round ``run.main``'s look for a card: they call
``run.run_cell`` on the CPU at 32x16, where the port runs its kernels'
plain versions.  ``test_one_run_on_the_card`` runs the command itself on
a card (the ``cuda`` marker; it skips without one).

Run: ``python -m pytest ptbench/tests -q`` from the repository's root; on
a card, ``python -m pytest ptbench/tests -q -m cuda``.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from ptbench import calibrate, faults, run, scenes, spec

ROOT = spec.ROOT
CELLS = tuple(w["name"] for w in spec.load_benchmark()["workloads"])
SEED = 2**31 + 99
SMALL = [32, 16]


def small_cell(name, root=ROOT):
    c = spec.cell(spec.load_benchmark(root), name, root)
    c["config"]["resolution"] = list(SMALL)
    return c


TINY_CONFIG = {
    "name": "tiny-box", "source": "a test scene", "precision": "float32",
    "resolution": [16, 8], "max_bounces": 2, "engine": "fused",
    "camera": {"position": [0.0, 0.0, 150.0], "plane_x": [-40.0, 40.0], "plane_y": [-40.0, 40.0],
               "plane_z": 100.0},
    "meshes": {"room": {"box": [400.0, 400.0, 400.0]}, "panel": {"box": [120.0, 8.0, 120.0]}},
    "instances": [{"mesh": "room", "material": "DIFFUSE", "color": [0.8, 0.8, 0.8]},
                  {"mesh": "panel", "material": "EMISSIVE", "color": [0.99, 0.99, 0.99],
                   "translate": [0.0, 150.0, 0.0]}],
    "reduced": [], "assumed": [],
}
TINY_TRAFFIC = {"kind": "render", "spp": 1, "rate": "render_mrays_per_s", "tail": "frame_p95_ms",
                "tail_pct": 95, "check_units": 1, "trace_units": 2,
                "limits": {"mismatch_share": 0.01, "mean_abs_diff": 0.001}}


def test_a_cell_configuration_and_metric_added_as_files(tmp_path):
    """A new configuration, traffic mix and per-layer metric need only new
    files under ptbench/ and new entries in BENCHMARK.json."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "ptbench"), root / "ptbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = spec.load_benchmark()
    (root / "ptbench" / "configs" / "tiny-box.json").write_text(json.dumps(TINY_CONFIG))
    (root / "ptbench" / "workloads" / "tiny-frames.json").write_text(json.dumps(TINY_TRAFFIC))
    (root / "ptbench" / "metrics" / "tiny_units.py").write_text(
        "def read(ctx):\n    return float(ctx.units)\n")
    bench["configs"].append({"name": "tiny-box", "source": "a test scene",
                             "file": "ptbench/configs/tiny-box.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "tiny-render", "config": "tiny-box",
                               "traffic": "tiny-frames", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] in ("render_mrays_per_s", "frame_p95_ms"):
            m["workloads"].append("tiny-render")
    bench["per_layer"].append({"name": "tiny_units", "unit": "launches", "better": "lower",
                               "source": "device_trace", "layer": "test",
                               "moves": "render_mrays_per_s", "workloads": ["tiny-render"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    c = spec.cell(spec.load_benchmark(str(root)), "tiny-render", str(root))
    assert [m["name"] for m in c["per_layer"]] == ["tiny_units"]
    assert {m["name"] for m in c["end_to_end"]} == {"render_mrays_per_s", "frame_p95_ms",
                                                    "setup_s"}
    timed = run.run_cell(c, SEED, 0.2, False, torch.device("cpu"), root=str(root))
    assert timed["correct"] and set(timed["metrics"]) == {"render_mrays_per_s", "frame_p95_ms",
                                                          "setup_s"}
    traced = run.run_cell(c, SEED, 0.2, True, torch.device("cpu"), root=str(root))
    assert traced["correct"] and traced["metrics"] == {"tiny_units": {"value": 2.0,
                                                                      "unit": "launches"}}


@pytest.mark.parametrize("section, field, value", [
    ("workloads", "name", "reference render"),
    ("workloads", "name", "reference,render"),
    ("workloads", "traffic", "frames/2spp"),
    ("configs", "name", "cornell–box"),
    ("end_to_end", "unit", "rays per second"),
    ("per_layer", "unit", "µs"),
    ("per_layer", "name", "x" * 65),
])
def test_names_and_units_outside_the_alphabet_are_refused(section, field, value):
    bench = spec.load_benchmark()
    bench[section][0][field] = value
    with pytest.raises(ValueError):
        spec.validate(bench)


def test_a_name_given_twice_is_refused():
    bench = spec.load_benchmark()
    bench["per_layer"][0]["name"] = bench["end_to_end"][0]["name"]
    with pytest.raises(ValueError):
        spec.validate(bench)


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "cornell-render", "--seed", str(SEED), "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


def test_only_the_benchmark_in_a_directory_gives_no_result(tmp_path):
    shutil.copytree(os.path.join(ROOT, "ptbench"), tmp_path / "ptbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    p = subprocess.run([sys.executable, "-m", "ptbench.run", "--workload", "cornell-render",
                        "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def _tops(code):
    out = subprocess.run([sys.executable, "-c", code + "; import json, sys; "
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, check=True, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_imports_by_whole_top_level_name():
    readers = "; ".join(f"ptbench.spec.reader({n!r})" for n in
                        [m["name"] for m in spec.load_benchmark()["per_layer"]])
    harness = _tops("import ptbench.run, ptbench.spec, ptbench.cells, ptbench.calibrate, "
                    "ptbench.faults, ptbench.reference.train; " + readers + "; "
                    "import pathtracerap_tpu_torch, pathtracerap_tpu_torch.diff")
    assert "pathtracerap_tpu_torch" in harness
    assert not harness & {"jax", "jaxlib", "flax", "pathtracerap_tpu"}
    reference = _tops("import ptbench.reference.pathtrace, ptbench.reference.train")
    assert not reference & {"jax", "jaxlib", "flax", "pathtracerap_tpu", "pathtracerap_tpu_torch"}


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault):
    c = small_cell(name)
    with faults.fault(c["traffic"]["kind"], fault):
        result = run.run_cell(c, SEED, 0.3, False, torch.device("cpu"))
    assert result["correct"] is False, result["checks"]


def test_window_steps_are_compared_with_the_reference():
    c = small_cell("reference-train")
    result = run.run_cell(c, SEED, 0.3, False, torch.device("cpu"))
    assert {"window_loss_gap", "window_step_gap"} <= set(result["checks"])
    traced = run.run_cell(c, SEED, 0.3, True, torch.device("cpu"))
    assert {"window_loss_gap", "window_step_gap"} <= set(traced["checks"])


def test_a_mesh_that_differs_from_the_configuration_is_refused(tmp_path):
    c = small_cell("reference-train")["config"]
    mesh = next(iter(c["meshes"].values()))
    (tmp_path / "assets" / "meshes").mkdir(parents=True)
    with open(os.path.join(ROOT, mesh["obj"])) as f:
        text = f.read()
    (tmp_path / mesh["obj"]).write_text(text.replace("v ", "v  ", 1) + "# an edit\n")
    with pytest.raises(ValueError, match="SHA-256"):
        scenes.checked_path(str(tmp_path), mesh)
    assert scenes.checked_path(ROOT, mesh) == os.path.join(ROOT, mesh["obj"])


@pytest.mark.parametrize("name", CELLS)
def test_the_bfloat16_control_is_not_correct(name):
    c = small_cell(name)
    nums = calibrate.control(c, SEED, torch.device("cpu"))
    limits = c["traffic"]["limits"]
    assert any(v > limits[k] for k, v in nums.items()), nums


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark measures the card only")


@pytest.mark.cuda
def test_one_run_on_the_card(card):
    p = subprocess.run([sys.executable, "-m", "ptbench.run", "--workload", "cornell-render",
                        "--seed", str(SEED), "--seconds", "2", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(result)[-1] == "checks" and result["correct"] is True
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    assert set(result["metrics"]) == {"render_mrays_per_s", "frame_p95_ms", "setup_s"}
