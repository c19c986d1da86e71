"""The port's paths at the sizes users run them, on the GPU: the renders,
train steps and suite rows route to their engines, launch their kernels and
call no plain version; the images hold their goldens; a checkpointed render
resumes bit for bit; the metrics, the profiler trace, the profiling
scripts, the command line, the native host library and two ranks on one
card (data-parallel and geometry ring) give what one process gives.

Kernel against plain version at small shapes: ``tests/test_torch_cuda.py``.
These tests skip where no GPU is present.  On the GPU machine (which has no
JAX, so the JAX conftest is left out):

    python -m pytest --noconftest -m cuda tests/test_torch_card_paths.py

This file imports no JAX.
"""

import glob
import io
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_distributed_worker as W
from pathtracerap_tpu_torch import (
    CameraConfig, RenderConfig, Renderer, build_reference_scene, read_bmp,
)
from pathtracerap_tpu_torch.bench_suite import _ROOM_CAMERA, INSIDE_CAMERA, suite_configs
from pathtracerap_tpu_torch.ops.rng import prng_key

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "assets", "golden")
MESHES = os.path.join(ROOT, "assets", "meshes")
CORNELL_CAMERA = suite_configs()["cornell"]["cfg"]["camera"]
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
# the world above the fused pack's budget, at the suite megascene's settings
BEYOND_SUBDIV, BEYOND_TRIANGLES = W.smoke().BEYOND_SUBDIV, 2_163_864
RANK_TIMEOUT_S = 420  # the two ranks' deadline together, start-up and kernel load included


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def beyond(dev):
    from pathtracerap_tpu_torch.bench_suite import build_highpoly_scene

    return build_highpoly_scene(subdiv=BEYOND_SUBDIV, use_asset=False).to_device(dev)


def _scene(name, dev, request):
    return request.getfixturevalue("beyond") if name == "beyond" else W.card_scene(name, dev)


def _finite_mean(img):
    img = img.cpu().numpy() if torch.is_tensor(img) else img
    return bool(np.isfinite(img).all()) and 0.01 < float(img.mean()) < 1.0


def _golden_relation(img, name, f=8):
    """(mean |diff|, correlation) of an (H, W, 3) image against a golden BMP,
    both averaged over f x f pixels."""
    def down(x):
        h, w, _ = x.shape
        return x[: h - h % f, : w - w % f].reshape(h // f, f, w // f, f, 3).mean(axis=(1, 3))

    a, b = down(img), down(read_bmp(os.path.join(GOLDEN, name)).astype(np.float32) / 255.0)
    return float(np.abs(a - b).mean()), float(np.corrcoef(a.ravel(), b.ravel())[0, 1])


def _check_launches(counts, launched=(), exact=None):
    assert counts["plain"] == 0, counts
    for k in launched:
        assert counts[k] > 0, (k, counts)
    for k, v in (exact or {}).items():
        assert counts[k] == v, (k, counts)


# name -> (scene, resolution, spp, bounces, RenderConfig fields, engine,
# kernels launched, exact launch counts)
RENDERS = {
    "quality": ("reference", (1000, 800), 24, 5,
                dict(engine="fused", parity=False, camera=CameraConfig(jitter=True)), "fused",
                ("sample_fused",), {"trace_list": 0}),
    "cornell": ("cornell", (256, 256), 64, 4, dict(engine="fused", camera=CORNELL_CAMERA), "fused",
                (), {"trace_list": 1, "sample_fused": 8, "rng": 8}),
    "beyond": ("beyond", (512, 512), 2, 6, dict(engine="fused", camera=_ROOM_CAMERA), "pallas",
               ("nearest_hit",), dict.fromkeys(("trace_list", "bounce", "bounce_trace",
                                                "sample_fused"), 0)),
    "beyond_inside": ("beyond", (512, 512), 2, 6, dict(engine="fused", camera=INSIDE_CAMERA),
                      "pallas", ("nearest_hit",), {}),
}


@pytest.mark.parametrize("name", RENDERS)
def test_render_routes_and_launches(dev, request, name):
    """Renderer at the main paths' sizes: its engine, the kernels it
    launches, no plain version, a finite image of mean in (0.01, 1)."""
    scene, res, spp, bounces, fields, engine, launched, exact = RENDERS[name]
    cfg = RenderConfig(resolution=res, samples_per_pixel=spp, max_bounces=bounces, **fields)
    r = Renderer(_scene(scene, dev, request), cfg, device=dev)
    assert r.engine == engine
    if scene == "beyond":
        assert r.world.fused_ops is None and r.world.n_valid == BEYOND_TRIANGLES
    img, counts = W.launched(r.render)
    _check_launches(counts, launched, exact)
    assert img.shape == (res[1], res[0], 3) and _finite_mean(img)


@pytest.mark.parametrize("row, engine, launched, exact", [
    ("megascene", "binned", ("trace_list", "bounce"), {}),
    ("gridparity", "parity", (), {"grid_dda": 3 * (1 + 2 * 4)}),  # three renders of 9 traces
], ids=["megascene", "gridparity"])
def test_suite_row_on_the_card(dev, row, engine, launched, exact):
    from pathtracerap_tpu_torch.bench_suite import run_config

    res, counts = W.launched(run_config, row, device=dev)
    assert res["engine"] == engine
    _check_launches(counts, launched, exact)
    assert 0.01 < res["image_mean"] < 1.0


# name -> (scene, resolution, spp, bounces, make_train_step or loss_and_grad
# keywords, params, a step (or its gradient), kernels launched, exact counts)
STEPS = {
    "reference_mat_color": ("reference", (1000, 800), 8, 5, dict(tile_size=8192, engine="fused"),
                            ("mat_color",), True, ("trace_list", "bounce_trace"), {}),
    "reference_vertex_quality": ("reference", (1000, 800), 8, 5,
                                 dict(tile_size=8192, engine="fused", parity=False),
                                 ("vertex_pos",), False, ("bounce_trace",), {}),
    "cornell_mat_color": ("cornell", (256, 256), 8, 4, dict(engine="fused"), ("mat_color",), True,
                          (), {"sample_fused": 8, "bounce_trace": 0}),
    "cornell_vertex_quality": ("cornell", (256, 256), 8, 4, dict(engine="fused", parity=False),
                               ("vertex_pos",), False, ("sample_fused",), {}),
    # the defaults: the per-bounce pallas diff engine, kernel 1 on every bounce
    "cornell_default": ("cornell", (256, 256), 8, 4, {}, ("mat_color",), True, (),
                        {"trace_list": 1 + 8 * 3, "sample_fused": 0, "nearest_hit": 0}),
    # no fused pack: the fused engine falls back to the pallas diff engine
    "beyond_mat_color": ("beyond", (256, 256), 2, 4, dict(engine="fused"), ("mat_color",), True,
                         ("nearest_hit",), dict.fromkeys(("trace_list", "bounce", "bounce_trace",
                                                          "sample_fused"), 0)),
    "parity_mat_color": ("reference", (1000, 800), 2, 5, dict(tile_size=2048, engine="parity"),
                         ("mat_color",), True, (), {"grid_dda": 1 + 2 * 4}),
    "parity_quality": ("reference", (1000, 800), 2, 5,
                       dict(tile_size=2048, engine="parity", parity=False),
                       ("mat_color", "model_to_world"), False, (), {"grid_dda": 1 + 2 * 4}),
}


@pytest.mark.parametrize("name", STEPS)
def test_train_step_launches_and_moves(dev, request, name):
    """make_train_step (or loss_and_grad) at the main paths' sizes, zero
    target: the kernels it launches, no plain version, a finite positive
    loss and finite nonzero gradients."""
    from pathtracerap_tpu_torch.diff import extract_params, loss_and_grad, make_train_step

    scene_name, res, spp, bounces, kw, names, is_step, launched, exact = STEPS[name]
    scene = _scene(scene_name, dev, request)
    camera = _ROOM_CAMERA if scene_name == "beyond" else W.card_camera(scene_name)
    params = extract_params(scene, names)
    target = torch.zeros((res[0] * res[1], 3), device=dev)
    if is_step:
        step = make_train_step(scene, camera, res, spp, bounces, lr=0.05, **kw)
        (loss, new), counts = W.launched(step, params, target, prng_key(0, dev))
        grads = {k: (params[k] - new[k]) / 0.05 for k in names}
    else:
        (loss, grads), counts = W.launched(loss_and_grad, params, scene, target, prng_key(0, dev),
                                           camera, res, spp, bounces, **kw)
    _check_launches(counts, launched, exact)
    assert math.isfinite(loss.item()) and loss.item() > 0
    for k in names:
        assert torch.isfinite(grads[k]).all() and (grads[k] != 0).any(), k


def test_quality_render_on_gpu_matches_cpu(dev):
    """The jittered quality render at 32x16 x 2 spp x 5 bounces through
    kernel 4 against the same render on CPU tensors: mean |diff| <= 1e-4,
    99.5 % of components within 1e-5."""
    cfg = RenderConfig(resolution=(32, 16), samples_per_pixel=2, max_bounces=5, engine="fused",
                       parity=False, camera=CameraConfig(jitter=True))
    r = Renderer(build_reference_scene().to_device(dev), cfg, device=dev)
    a, counts = W.launched(r.render, seed=3)
    _check_launches(counts, ("sample_fused",))
    b = Renderer(build_reference_scene().to_device("cpu"), cfg, device="cpu").render(seed=3)
    d = (a.cpu() - b).abs()
    assert d.mean().item() <= 1e-4 and (d <= 1e-5).float().mean().item() >= 0.995


def test_parity_render_through_g1_equals_plain(dev):
    """The parity render at 200x160 x 2 spp x 5 bounces through G1 and
    through its plain version on the same CUDA tensors, bit for bit."""
    from pathtracerap_tpu_torch.ops.intersect import trace_parity
    from pathtracerap_tpu_torch.render.camera import generate_rays
    from pathtracerap_tpu_torch.render.wavefront import _make_tracer, _render_tile

    scene = build_reference_scene().to_device(dev)
    ro, rd = generate_rays(CameraConfig(), (200, 160), device=dev)

    def render(tracer):
        return _render_tile(tracer, ro, rd, 0, prng_key(0, dev), 2, 5, True, tile_size=2048)

    kern, counts = W.launched(render, _make_tracer(scene, "parity"))
    _check_launches(counts, exact={"grid_dda": 1 + 2 * 4})
    plain = render(lambda o, d, alive=None: trace_parity(scene, o.contiguous(), d.contiguous(),
                                                         alive=alive))
    assert torch.equal(kern.view(torch.int32), plain.view(torch.int32))


def test_parity_render_holds_its_goldens(dev):
    """render_accumulate(engine="parity") on the reference scene at 1000x800
    x 2 spp x 5 bounces (2048-ray RNG tiles), averaged over 8x8 pixels:
    against the parity golden mean |diff| < 0.08 and correlation > 0.9;
    against the fused golden < 0.09 and > 0.945 (its parity golden's
    bfloat16 offset, ROADMAP queue C, is not held); against the f32 parity
    golden < 0.005 and > 0.999.  Then Renderer(engine="parity"): no world,
    G1 alone, the parity golden's bounds."""
    from pathtracerap_tpu_torch.render.wavefront import render_accumulate

    scene = build_reference_scene().to_device(dev)
    acc, counts = W.launched(render_accumulate, scene, prng_key(0, dev), CameraConfig(), (1000, 800),
                             2, 5, engine="parity", tile_size=2048)
    _check_launches(counts, exact={"grid_dda": 9})
    img = (acc.reshape(800, 1000, 3) / 2).cpu().numpy()
    assert np.isfinite(img).all()
    for golden, mad, corr in (("reference_scene_parity.bmp", 0.08, 0.9),
                              ("reference_scene.bmp", 0.09, 0.945),
                              ("reference_scene_parity_f32.bmp", 0.005, 0.999)):
        m, c = _golden_relation(img, golden)
        assert m < mad and c > corr, (golden, m, c)
    cfg = RenderConfig(resolution=(1000, 800), samples_per_pixel=2, max_bounces=5, engine="parity")
    r = Renderer(scene, cfg, device=dev)
    assert r.engine == "parity" and r.world is None
    img, counts = W.launched(r.render)
    _check_launches(counts, exact={"grid_dda": 9})
    img = img.cpu().numpy()
    assert _finite_mean(img)
    m, c = _golden_relation(img, "reference_scene_parity.bmp")
    assert m < 0.08 and c > 0.9


def test_render_aovs_on_the_card(dev, tmp_path):
    """render_aovs at 1000x800 through G1 (one launch), the checks of
    tests/test_debug_viz.py:20, and write_aov_bmps' seven BMPs."""
    from pathtracerap_tpu_torch.render.debug_viz import render_aovs, write_aov_bmps

    scene = build_reference_scene().to_device(dev)
    cfg = RenderConfig(resolution=(1000, 800), engine="parity")
    a, counts = W.launched(render_aovs, scene, cfg)
    _check_launches(counts, exact={"grid_dda": 1})
    assert a["depth"].shape == (800, 1000) and a["normal"].shape == (800, 1000, 3)
    assert a["hit"].mean() > 0.9
    d = a["depth"][a["hit"]]
    assert np.isfinite(d).all() and d.min() > 0
    assert a["dda_steps"].max() > 1 and a["tri_tests"].max() > 1
    assert np.abs(np.linalg.norm(a["normal"][a["hit"]], axis=-1) - 1.0).max() < 1e-4
    paths = write_aov_bmps(scene, cfg, str(tmp_path))
    assert len(paths) == 7 and all(os.path.getsize(p) > 1000 * 800 * 3 for p in paths.values())


@pytest.mark.parametrize("scene_name, res, bounces, engine, kernel", [
    ("reference", (1000, 800), 5, "binned", "bounce"),
    ("cornell", (256, 256), 4, "fused", "sample_fused"),
], ids=["reference", "cornell"])
def test_resumed_render_equals_unbroken(dev, tmp_path, monkeypatch, scene_name, res, bounces,
                                        engine, kernel):
    """Renderer.render(checkpoint_path=...) at 8 spp in chunks of 4, stopped
    after its first chunk as a killed process would be, then resumed: the
    checkpoints hold 4 and 8 samples, and the image equals the unbroken
    render's bit for bit, on its engine's kernels alone."""
    from pathtracerap_tpu_torch.render import wavefront
    from pathtracerap_tpu_torch.utils import InjectedFault, load_checkpoint

    cfg = RenderConfig(resolution=res, samples_per_pixel=8, samples_per_chunk=4,
                       max_bounces=bounces, engine="fused", camera=W.card_camera(scene_name))
    r = Renderer(W.card_scene(scene_name, dev), cfg, device=dev)
    assert r.engine == engine
    full = r.render()
    path = str(tmp_path / "render.ckpt")
    real, calls = wavefront.render_accumulate, []

    def first_chunk_only(*args, **kwargs):
        if calls:
            raise InjectedFault("stopped after the first chunk")
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(wavefront, "render_accumulate", first_chunk_only)
    with pytest.raises(InjectedFault):
        r.render(checkpoint_path=path)
    monkeypatch.undo()
    assert load_checkpoint(path).samples_done == 4
    resumed, counts = W.launched(r.render, checkpoint_path=path)
    _check_launches(counts, (kernel,))
    assert torch.equal(resumed, full)
    assert load_checkpoint(path).samples_done == 8


def test_metrics_and_profile_trace_on_the_card(dev, tmp_path):
    """The main-path render (1000x800 x 24 spp x 5, chunks of 8) with a
    MetricsLogger: the card's name, a line a chunk, a live-ray curve that
    falls from 1; the same render at 4 spp under profile_trace: every
    ``ptap.*`` span and the card's kernels in the trace;
    device_memory_report reads the card."""
    from pathtracerap_tpu_torch.utils import MetricsLogger, profile_trace
    from pathtracerap_tpu_torch.utils.profiling import device_memory_report

    cfg = RenderConfig(resolution=(1000, 800), samples_per_pixel=24, samples_per_chunk=8,
                       max_bounces=5, engine="fused")
    r = Renderer(build_reference_scene().to_device(dev), cfg, device=dev)
    log = MetricsLogger(cfg, stream=io.StringIO())
    img, counts = W.launched(r.render, metrics=log)
    _check_launches(counts, ("bounce",))
    assert torch.isfinite(img).all()
    assert log.finalize(24).device == torch.cuda.get_device_name(dev)
    assert len(log.chunks) == 3
    curve = log.live_ray_curve
    assert len(curve) == 5 and curve[0] == 1.0 and all(a >= b for a, b in zip(curve, curve[1:]))
    r = Renderer(r.scene, RenderConfig(resolution=(1000, 800), samples_per_pixel=4, max_bounces=5,
                                       engine="fused"), device=dev)
    r.render()
    with profile_trace(str(tmp_path)):
        r.render()
        torch.cuda.synchronize()
    (path,) = glob.glob(str(tmp_path / "trace_*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    for span in ("render", "trace_primary", "rng", "shade", "sort", "worklists", "bounce",
                 "accumulate"):
        assert "ptap." + span in names, span
    assert any(e.get("cat") == "kernel" for e in events)
    assert device_memory_report()["cuda:0"]["bytes_limit"] > 0


def test_profiling_scripts_run_on_the_card(dev, capsys):
    """The four profiling scripts' main() at full size: P3 correct in its
    script, every profiling kernel configuration launched, no plain
    version."""
    from pathtracerap_tpu_torch.kernels import prof as KP
    from pathtracerap_tpu_torch.scripts import (
        prof_kernel_parts, prof_kernel_parts2, prof_mega_sweep, prof_r5_shade,
    )

    KP.parts.variant_launches.clear()
    out = {}
    counts = W.kernel_counts()
    for mod in (prof_kernel_parts, prof_kernel_parts2, prof_r5_shade, prof_mega_sweep):
        out[mod.__name__] = mod.main()
    capsys.readouterr()
    assert W.kernel_counts()["plain"] == counts["plain"]
    assert out[prof_r5_shade.__name__]["argmin_int_correct"]
    assert KP.parts.variant_launches.keys() == KP.PARTS_CONFIGS
    assert all(W.kernel_counts()[k] > counts[k] for k in ("prof_empty", "prof_argmin"))


def test_prof_parts_kernels_on_tensor_cores_without_spills(dev):
    """Every instantiation of the parts kernel (P1, P2) spills nothing;
    each bf16 one issues wgmma or mma.sync (HGMMA or HMMA in its SASS, as
    chip_smoke.py's ``sass_counts`` reads ``cuobjdump -sass``), the f32 one
    neither."""
    from pathtracerap_tpu_torch.kernels import _build

    hmma, hgmma = W.smoke().sass_counts("HMMA"), W.smoke().sass_counts("HGMMA")
    parts = {k: v for k, v in _build.kernel_resources().items()
             if "parts_wgmma_kernel" in k or "parts_f32_kernel" in k}
    assert any("parts_f32_kernel" in k for k in parts) and len(parts) > 1
    for name, res in parts.items():
        assert res["spill_stores"] == 0 and res["spill_loads"] == 0, name
        tensor = hmma.get(name, 0) + hgmma.get(name, 0) > 0
        assert tensor == ("parts_f32_kernel" not in name), name


def test_glass_render_holds_its_golden(dev):
    """scenes/glass_sphere.scn in quality mode at its golden's settings
    (fused, 96x72 x 8 spp x 6): mean |diff| < 0.04, correlation > 0.97
    over 4x4 pixels, through its engine's kernels."""
    from pathtracerap_tpu_torch.scene.dsl import load_scene_file, render_config_from_parsed

    p = load_scene_file(os.path.join(ROOT, "scenes", "glass_sphere.scn"))
    cfg = render_config_from_parsed(p, engine="fused", parity=False, samples_per_pixel=8,
                                    resolution=(96, 72), max_bounces=6)
    r = Renderer(p.scene.to_device(dev), cfg, device=dev)
    img, counts = W.launched(r.render)
    _check_launches(counts, ("sample_fused" if r.engine == "fused" else "bounce",))
    img = img.cpu().numpy()
    assert img.shape == (72, 96, 3) and np.isfinite(img).all()
    m, c = _golden_relation(img, "glass_sphere.bmp", f=4)
    assert m < 0.04 and c > 0.97, (m, c)


def test_cli_render_writes_the_renderers_bmp(dev, tmp_path, capsys):
    """``cli render --engine fused --spp 24`` at 1000x800 x 5 bounces: its
    BMP's bytes are those of Renderer.render() quantized and written as the
    CLI writes them."""
    from pathtracerap_tpu_torch import cli
    from pathtracerap_tpu_torch.io.bmp import quantize_image, write_bmp

    out, ref = str(tmp_path / "cli.bmp"), str(tmp_path / "ref.bmp")
    rc, counts = W.launched(cli.main, ["render", "--engine", "fused", "--spp", "24", "--width",
                                       "1000", "--height", "800", "--bounces", "5", "--out", out])
    capsys.readouterr()
    assert rc == 0
    _check_launches(counts, ("trace_list", "bounce"))
    cfg = RenderConfig(resolution=(1000, 800), samples_per_pixel=24, max_bounces=5, engine="fused")
    image = Renderer(build_reference_scene().to_device(dev), cfg, device=dev).render().cpu().numpy()
    assert np.isfinite(image).all()
    write_bmp(ref, quantize_image(image * 24, 24), parity=True)
    with open(out, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()


def test_cli_invert_matches_make_train_step(dev, capsys):
    """``cli invert`` (3 steps at 200x160 x 2 spp on the card): the loss
    falls, through kernel 1, and make_train_step prints the same losses
    within rtol 1e-5."""
    from pathtracerap_tpu_torch import cli
    from pathtracerap_tpu_torch.diff import extract_params, make_train_step, render_for_params

    rc, counts = W.launched(cli.main, ["invert", "--width", "200", "--height", "160", "--spp", "2",
                                       "--steps", "3"])
    printed = [float(ln.split("loss=")[1]) for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("step ")]
    assert rc == 0 and len(printed) == 3 and printed[-1] < printed[0]
    _check_launches(counts, ("trace_list",))
    scene = build_reference_scene().to_device(dev)
    cfg = RenderConfig(resolution=(200, 160), samples_per_pixel=2)
    key = prng_key(cfg.seed, dev)
    with torch.no_grad():
        target = render_for_params(extract_params(scene, ("mat_color",)), scene, key, cfg.camera,
                                   cfg.resolution, 2, cfg.max_bounces)
    params = {"mat_color": scene.mat_color * 0.5}
    step = make_train_step(scene, cfg.camera, cfg.resolution, 2, cfg.max_bounces, lr=0.1)
    own = []
    for _ in range(3):
        loss, params = step(params, target, key)
        own.append(float(f"{float(loss):.6f}"))  # as the CLI prints it
    np.testing.assert_allclose(printed, own, rtol=LOSS_RTOL, atol=0)


def test_cli_info_and_visualize(dev, tmp_path, capsys):
    """``info``'s JSON keys and the reference scene's counts; ``visualize``
    writes seven BMPs through one launch of G1."""
    from pathtracerap_tpu_torch import cli

    assert cli.main(["info"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert list(info) == ["models", "meshes", "triangles", "grids", "voxels", "per_voxel_entries",
                          "ell_width", "config"]
    assert info["models"] == 11 and info["triangles"] == 1039
    rc, counts = W.launched(cli.main, ["visualize", "--out-dir", str(tmp_path)])
    lines = capsys.readouterr().out.splitlines()
    assert rc == 0 and len(lines) == 7
    assert all(os.path.getsize(ln.split(": ", 1)[1]) > 0 for ln in lines)
    _check_launches(counts, exact={"grid_dda": 1})


def test_dryrun_entry_starts(dev):
    proc = subprocess.run([sys.executable, "-m", "pathtracerap_tpu_torch.parallel.dryrun", "--help"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "--ranks" in proc.stdout, proc.stderr[-3000:]


def _grid_builds(host):
    for g in range(host.grid_mesh.shape[0]):
        mi = int(host.grid_mesh[g])
        ts, te = int(host.mesh_tri_start[mi]), int(host.mesh_tri_end[mi])
        yield (host.vertex_pos[host.tri_vidx[ts:te]], host.mesh_bbox_min[mi],
               host.mesh_bbox_max[mi], tuple(host.grid_dims), ts)


def test_native_host_library_matches_python(dev, tmp_path):
    """The native host library, built on this machine with g++, against
    numpy: the reference assets' OBJ loads, the grids of the parity scene,
    of the highpoly blob under 25^3 voxels and of the megascene, and a
    1000x800 BMP in both modes, equal."""
    from pathtracerap_tpu_torch import native
    from pathtracerap_tpu_torch.bench_suite import suite_configs
    from pathtracerap_tpu_torch.io.bmp import quantize_image, write_bmp
    from pathtracerap_tpu_torch.io.obj import load_obj
    from pathtracerap_tpu_torch.scene.build import SceneBuilder
    from pathtracerap_tpu_torch.scene.grid import build_uniform_grid
    from pathtracerap_tpu_torch.scene.types import Material, MaterialType

    assert native.available(), native.build_error
    for name in ("enclosing_box.obj", "ceiling_light.obj", "blender_monkey.obj"):
        path = os.path.join(MESHES, name)
        m_n, m_p = load_obj(path, backend="native"), load_obj(path, backend="python")
        for f in ("positions", "normals", "uvs", "triangles", "bbox_min", "bbox_max"):
            assert np.array_equal(getattr(m_n, f), getattr(m_p, f)), (name, f)
    blob = SceneBuilder(grid_dims=(25, 25, 25))
    blob.add_instance(blob.add_mesh_file(os.path.join(MESHES, "highpoly_blob.obj")),
                      Material(MaterialType.DIFFUSE, (0.8, 0.3, 0.2)))
    for host in (build_reference_scene(), blob.build(), suite_configs()["megascene"]["scene"]()):
        for args in _grid_builds(host):
            a = build_uniform_grid(*args, backend="native")
            b = build_uniform_grid(*args, backend="python")
            for f in ("voxel_width", "voxel_tri_start", "voxel_tri_count", "tri_indices"):
                assert np.array_equal(getattr(a, f), getattr(b, f)), f
    image = quantize_image(np.random.default_rng(0).uniform(0, 2, (800, 1000, 3))
                           .astype(np.float32), 1)
    for parity in (True, False):
        paths = [str(tmp_path / f"{b}.bmp") for b in ("native", "python")]
        for path, backend in zip(paths, ("native", "python")):
            write_bmp(path, image, parity=parity, backend=backend)
        with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
            assert a.read() == b.read(), parity


def test_highpoly_frame_split_equals_unsplit(dev, monkeypatch):
    """The benchmark's highpoly configuration (149,733 triangles in 293
    blocks, block worklists, 512x512 x 1 spp x 8 bounces): frames with
    kernel 2's lists split by bounce_chunk and with each tile's whole list
    in one thread block, in turns, each repeating bit for bit and equal to
    the other; kernel 2 launches once a bounce of each slab, every launch
    of the split frame split, none of the other."""
    from pathtracerap_tpu_torch.kernels import megakernel as TM
    from ptbench import cells, scenes

    with open(os.path.join(ROOT, "ptbench", "configs", "highpoly.json")) as f:
        config = json.load(f)
    cfg = RenderConfig(resolution=tuple(config["resolution"]), samples_per_pixel=1,
                       max_bounces=config["max_bounces"], camera=cells.camera(config),
                       engine=config["engine"])
    r = Renderer(scenes.port_scene(scenes.scene_inputs(config)).to_device(dev), cfg, device=dev)
    assert not TM.use_sub_blocks(r.world) and r.world.block_aabb.shape[0] == 293
    frames = {"split": [], "unsplit": []}
    for name in ("split", "unsplit", "unsplit", "split"):
        if name == "unsplit":
            monkeypatch.setattr(TM, "bounce_chunk", lambda unit, lw, nt: max(lw, 1))
        before = (TM.bounce.launches, TM.bounce.split_launches)
        frames[name].append(r.render(seed=7).view(torch.int32))
        launches, split = TM.bounce.launches - before[0], TM.bounce.split_launches - before[1]
        assert launches == 2 * (cfg.max_bounces - 1)  # two slabs
        assert split == (launches if name == "split" else 0)
        monkeypatch.undo()
    for name, (a, b) in frames.items():
        assert torch.equal(a, b), name
    assert torch.equal(frames["split"][0], frames["unsplit"][0])


# --------------------------------------------------------------------------
# two ranks on one card (tests/_torch_distributed_worker.py's card job)
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ranks(dev, tmp_path_factory):
    """The card job's two ranks under gloo on cuda:0: each rank's results
    and rank 0's arrays."""
    prefix = str(tmp_path_factory.mktemp("ranks") / "card")
    torch.cuda.empty_cache()
    results = W.run_job(prefix, n=2, timeout=RANK_TIMEOUT_S, job="card")
    for r, (rc, text) in enumerate(results):
        assert rc == 0, f"rank {r} exited {rc}: {text[-3000:]}"
    metas = []
    for r in range(2):
        with open(f"{prefix}.rank{r}.json") as f:
            metas.append(json.load(f))
    return metas, dict(np.load(prefix + ".npz"))


def test_data_parallel_render_and_step_equal_one_process(dev, ranks):
    """The two ranks (gloo, both on the card, the liveness probe counting
    both): the data-parallel binned render bit for bit against
    Renderer.render(), the sharded mat_color step (overlap_chunks 1 and 2)
    within rtol 1e-5 of the one-process step; every rank on kernels 1, 2
    and 3 and no plain version."""
    from pathtracerap_tpu_torch.diff import extract_params, make_sharded_train_step
    from pathtracerap_tpu_torch.parallel import default_mesh

    metas, arrays = ranks
    for m in metas:
        assert m["device"].startswith("cuda") and m["backend"] == "gloo" and m["liveness"] == 2
        _check_launches(m["dp_render"], ("trace_list", "bounce"))
    scene = build_reference_scene().to_device(dev)
    res, spp, bounces = W.CARD_RES, W.CARD_SPP, W.CARD_BOUNCES
    cfg = RenderConfig(resolution=res, samples_per_pixel=spp, max_bounces=bounces, engine="fused")
    assert np.array_equal(arrays["dp_render"], Renderer(scene, cfg, device=dev).render().cpu().numpy())
    for chunks in (1, 2):
        step = make_sharded_train_step(scene, CameraConfig(), res, spp, bounces, default_mesh(dev),
                                       engine="fused", overlap_chunks=chunks)
        loss, new = step(extract_params(scene, ("mat_color",)),
                         torch.zeros((res[0] * res[1], 3), device=dev), prng_key(0, dev))
        got = [m[f"step_chunks{chunks}"] for m in metas]
        assert abs(got[0]["loss"] - loss.item()) <= LOSS_RTOL * abs(loss.item())
        np.testing.assert_allclose(arrays[f"step_chunks{chunks}"], new["mat_color"].cpu().numpy(),
                                   rtol=LOSS_RTOL, atol=1e-7)
        for g in got:
            _check_launches(g, ("trace_list", "bounce_trace"))


def _ring_single(dev, name):
    """One process's per-bounce pallas render at the ring's tile: the image."""
    from pathtracerap_tpu_torch.ops.plucker import bake_world_triangles
    from pathtracerap_tpu_torch.render.wavefront import render_accumulate

    scene_name, res, spp, bounces, engine = W.CARD_RING_RENDERS[name]
    scene = W.card_scene(scene_name, dev)
    world = bake_world_triangles(scene, fused_tile=512 if engine == "fused" else None)
    acc = render_accumulate(scene, prng_key(0, dev), W.card_camera(scene_name), res, spp, bounces,
                            engine="pallas", tile_size=W.CARD_RING_TILE, world=world)
    return (acc / spp).reshape(res[1], res[0], 3).cpu().numpy()


@pytest.mark.parametrize("name", W.CARD_RING_RENDERS)
def test_geometry_ring_render_equals_one_process(dev, ranks, name):
    """Each ring render (the reference scene's fused ring at 1000x800 x 2 x
    5; the megascene's fused and dense rings at its suite settings) bit
    for bit against one process's pallas render at the same tile; every
    rank on its engine's kernel, holding at most its shard of the pack
    (and, in card memory after the bake, the tables and one shard), with
    D - 1 transfers a trace call."""
    metas, arrays = ranks
    _, res, spp, bounces, engine = W.CARD_RING_RENDERS[name]
    img = arrays[f"ring_{name}"]
    assert _finite_mean(img)
    assert np.array_equal(img, _ring_single(dev, name))
    block = 512 * 24 * 4 + 8 * 4 if engine == "fused" else 0
    for m in metas:
        c = m[f"ring_{name}"]
        _check_launches(c, ("trace_list" if engine == "fused" else "nearest_hit",))
        assert c["shard_bytes"] <= c["world_sharded_bytes"] / 2 + block
        assert c["held_bytes"] <= c["tables_bytes"] + c["world_sharded_bytes"] / 2 + block
        assert c["transfers"] == 1 + spp * (bounces - 1)


def test_geometry_ring_fused_against_dense(ranks):
    """The megascene's fused and dense rings within 1e-5 of each other on
    all but a 1e-3 share of the pixels (phantom accepts of the dense
    kernel's gate)."""
    _, arrays = ranks
    d = np.abs(arrays["ring_megascene_fused"] - arrays["ring_megascene_dense"]).max(axis=-1)
    assert (d > 1e-5).sum() <= 1e-3 * d.size


@pytest.mark.parametrize("name", W.CARD_RING_STEPS)
def test_geometry_ring_step_equals_one_process(dev, ranks, name):
    """Each ring step (mat_color at 1000x800 x 2 x 5; the re-baking
    vertex_pos step on the Cornell box at 200x160 x 2 x 3, quality mode):
    the loss within rtol 1e-5 and the parameters within rtol 1e-4 of the
    single-process sum-loss step; every rank on kernel 1."""
    from pathtracerap_tpu_torch.diff import extract_params, loss_and_grad

    metas, arrays = ranks
    scene_name, res, spp, bounces, tile, names, parity, target, seed = W.CARD_RING_STEPS[name]
    scene = W.card_scene(scene_name, dev)
    params = extract_params(scene, names)
    loss, grads = loss_and_grad(params, scene, torch.full((res[0] * res[1], 3), target, device=dev),
                                prng_key(seed, dev), W.card_camera(scene_name), res, spp, bounces,
                                tile_size=tile, reduce="sum", parity=parity)
    got = metas[0][f"ring_step_{name}"]
    assert abs(got["loss"] - loss.item()) <= LOSS_RTOL * abs(loss.item())
    for k in names:
        np.testing.assert_allclose(arrays[f"ring_step_{name}_{k}"],
                                   (params[k] - 0.05 * grads[k]).cpu().numpy(), rtol=GRAD_RTOL,
                                   atol=1e-6, err_msg=k)
    for m in metas:
        _check_launches(m[f"ring_step_{name}"], ("trace_list",))


def test_dryrun_geometry_half_on_the_card(ranks):
    """parallel/dryrun.py's geometry half on each rank: the ring image equal
    to the replicated render, a ring step that moves the parameters, a
    nonzero vertex gradient."""
    metas, _ = ranks
    for m in metas:
        g = m["dryrun_geometry"]
        assert g["ring_image_equal"] and g["ring_step_delta"] > 0 and g["ring_vertex_max_grad"] > 0
