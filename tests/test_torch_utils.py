"""The port's utilities against the JAX package's: checkpoint/resume through
``Renderer.render(checkpoint_path=...)`` and ``render_accumulate``'s
``sample_offset`` / ``init_accum``, failure recovery, metrics, the live-ray
curve and the profiler hooks.

Mirrors ``tests/test_dsl_cli.py:91,113,154`` (on ``mxu`` and ``fused`` with
the Cornell box and ``binned`` with the reference scene),
``tests/test_failure.py:23,42,63,88,102`` and ``tests/test_megakernel.py:72``.
Images against JAX at atol 1e-5, the port engines' tolerance (XLA's CPU
rsqrt, ROADMAP queue C); a resumed render against the unbroken one bit
for bit.
"""

import dataclasses
import glob
import inspect
import io
import json

import jax
import numpy as np
import pytest
import torch

from pathtracerap_tpu.config import CameraConfig as JCameraConfig
from pathtracerap_tpu.config import RenderConfig as JRenderConfig
from pathtracerap_tpu.ops.plucker import bake_world_triangles as jax_bake
from pathtracerap_tpu.render import diagnostics as jdiag
from pathtracerap_tpu.render import wavefront as jwave
from pathtracerap_tpu.scene import build as JB
from pathtracerap_tpu.utils import checkpoint as jckpt
from pathtracerap_tpu.utils import metrics as jmetrics
from pathtracerap_tpu_torch import (
    CameraConfig, RenderConfig, Renderer, build_cornell_box_scene, build_reference_scene,
)
from pathtracerap_tpu_torch.ops.plucker import bake_world_triangles
from pathtracerap_tpu_torch.ops.rng import prng_key
from pathtracerap_tpu_torch.render import wavefront
from pathtracerap_tpu_torch.render.diagnostics import live_ray_curve
from pathtracerap_tpu_torch.scene.types import SceneHost
from pathtracerap_tpu_torch.utils import (
    FaultInjector, Heartbeat, InjectedFault, MetricsLogger, RenderCheckpoint, annotate,
    load_checkpoint, profile_trace, run_with_recovery, save_checkpoint,
)
from pathtracerap_tpu_torch.utils.profiling import device_memory_report

CAM = dict(position=(0.0, 0.0, 150.0), plane_x=(-40.0, 40.0), plane_y=(-30.0, 30.0),
           plane_z=100.0)  # tests/test_dsl_cli.py:123
ATOL = 1e-5
# engine -> (scene, camera): the engines' own scenes (fused keeps one block)
CASES = {"mxu": ("cornell", CAM), "fused": ("cornell", CAM), "binned": ("reference", {})}


@pytest.fixture(scope="module")
def scenes():
    return {
        "cornell": (build_cornell_box_scene().to_device("cpu"),
                    JB.build_cornell_box_scene().to_device()),
        "reference": (build_reference_scene().to_device("cpu"),
                      JB.build_reference_scene().to_device()),
    }


def _cfg(engine, **over):
    cam = CASES.get(engine, ("cornell", CAM))[1]
    kw = dict(resolution=(16, 8), samples_per_pixel=6, samples_per_chunk=2, max_bounces=2,
              camera=CameraConfig(**cam), engine=engine)
    kw.update(over)
    return RenderConfig(**kw)


# --------------------------------------------------------------------------
# checkpoint / resume (tests/test_dsl_cli.py:91, :113, :154)
# --------------------------------------------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    path = str(tmp_path / "r.ckpt")
    accum = np.random.default_rng(0).random((64, 3)).astype(np.float32)
    ck = RenderCheckpoint(accum=accum, samples_done=5, seed=3, config=RenderConfig().to_dict(),
                          extra={"opt": np.arange(4.0)})
    save_checkpoint(path, ck)
    back = load_checkpoint(path)
    np.testing.assert_array_equal(back.accum, accum)
    assert back.samples_done == 5 and back.seed == 3
    assert back.config == RenderConfig().to_dict()
    np.testing.assert_array_equal(back.extra["opt"], np.arange(4.0))
    assert load_checkpoint(str(tmp_path / "missing.ckpt")) is None
    assert not glob.glob(str(tmp_path / "*.tmp"))  # the atomic write left no temp file


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_loads_across_packages(tmp_path, writer):
    path = str(tmp_path / "x.ckpt")
    accum = np.random.default_rng(1).random((32, 3)).astype(np.float32)
    jax_writes = writer == "jax"
    cls = jckpt.RenderCheckpoint if jax_writes else RenderCheckpoint
    save = jckpt.save_checkpoint if jax_writes else save_checkpoint
    load = load_checkpoint if jax_writes else jckpt.load_checkpoint
    save(path, cls(accum=accum, samples_done=4, seed=9, config=JRenderConfig().to_dict(),
                   extra={"lr": np.float32([0.05])}))
    back = load(path)
    np.testing.assert_array_equal(back.accum, accum)
    assert (back.samples_done, back.seed, back.config) == (4, 9, RenderConfig().to_dict())
    np.testing.assert_array_equal(back.extra["lr"], np.float32([0.05]))


def _first_chunk_checkpoint(path, scene, cfg, world):
    acc = wavefront.render_accumulate(scene, prng_key(cfg.seed, "cpu"), cfg.camera,
                                      cfg.resolution, 2, cfg.max_bounces, engine=cfg.engine,
                                      world=world)
    save_checkpoint(path, RenderCheckpoint(accum=acc.numpy(), samples_done=2, seed=cfg.seed,
                                           config=cfg.to_dict()))


@pytest.mark.parametrize("engine", list(CASES))
def test_render_resume_is_exact(tmp_path, scenes, engine):
    """Interrupted + resumed render == unbroken chunked render, bit for bit."""
    scene = scenes[CASES[engine][0]][0]
    cfg = _cfg(engine)
    full = Renderer(scene, cfg, device="cpu").render()
    ckpt = str(tmp_path / "resume.ckpt")
    r = Renderer(scene, cfg, device="cpu")
    _first_chunk_checkpoint(ckpt, scene, cfg, r.world)
    resumed = Renderer(scene, cfg, device="cpu").render(checkpoint_path=ckpt)
    assert torch.equal(resumed, full)
    assert load_checkpoint(ckpt).samples_done == cfg.samples_per_pixel


@pytest.mark.parametrize("engine", list(CASES))
def test_render_stopped_after_a_chunk_resumes_exactly(tmp_path, scenes, engine, monkeypatch):
    """A render killed after its first chunk's checkpoint, then run again
    with the same path, equals the unbroken render."""
    scene = scenes[CASES[engine][0]][0]
    cfg = _cfg(engine)
    full = Renderer(scene, cfg, device="cpu").render()
    ckpt = str(tmp_path / "stop.ckpt")
    real = wavefront.render_accumulate
    calls = []

    def dies_after_one(*args, **kwargs):
        if calls:
            raise InjectedFault("stopped after chunk 1")
        calls.append(kwargs["sample_offset"])
        return real(*args, **kwargs)

    monkeypatch.setattr(wavefront, "render_accumulate", dies_after_one)
    with pytest.raises(InjectedFault):
        Renderer(scene, cfg, device="cpu").render(checkpoint_path=ckpt)
    assert load_checkpoint(ckpt).samples_done == 2
    monkeypatch.setattr(wavefront, "render_accumulate", real)
    assert torch.equal(Renderer(scene, cfg, device="cpu").render(checkpoint_path=ckpt), full)


def test_jax_checkpoint_resumes_in_the_port(tmp_path, scenes):
    """The JAX package's first chunk, resumed by the port's Renderer."""
    scene, jscene = scenes["cornell"]
    cfg = _cfg("mxu")
    jcfg = JRenderConfig(resolution=(16, 8), samples_per_pixel=6, samples_per_chunk=2,
                         max_bounces=2, camera=JCameraConfig(**CAM), engine="mxu")
    assert jcfg.to_dict() == cfg.to_dict()
    ckpt = str(tmp_path / "jax.ckpt")
    acc = jwave.render_accumulate(jscene, jax.random.PRNGKey(cfg.seed), jcfg.camera,
                                  jcfg.resolution, n_samples=2, max_bounces=2, engine="mxu",
                                  world=jax.jit(jax_bake)(jscene))
    jckpt.save_checkpoint(ckpt, jckpt.RenderCheckpoint(
        accum=np.asarray(acc), samples_done=2, seed=cfg.seed, config=jcfg.to_dict()))
    resumed = Renderer(scene, cfg, device="cpu").render(checkpoint_path=ckpt)
    full = Renderer(scene, cfg, device="cpu").render()
    np.testing.assert_allclose(resumed.numpy(), full.numpy(), atol=ATOL, rtol=0)
    ref = np.asarray(jwave.Renderer(jscene, jcfg).render())
    np.testing.assert_allclose(resumed.numpy(), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("what", ["config", "seed"])
def test_checkpoint_mismatch_refused(tmp_path, scenes, what):
    scene = scenes["cornell"][0]
    cfg = _cfg("mxu", samples_per_pixel=4, samples_per_chunk=0)
    other = dataclasses.replace(cfg, max_bounces=3) if what == "config" else cfg
    ckpt = str(tmp_path / "bad.ckpt")
    save_checkpoint(ckpt, RenderCheckpoint(accum=np.zeros((16 * 8, 3), np.float32),
                                           samples_done=2, seed=1 if what == "seed" else 0,
                                           config=other.to_dict()))
    with pytest.raises(ValueError, match="different render config"):
        Renderer(scene, cfg, device="cpu").render(checkpoint_path=ckpt)


# --------------------------------------------------------------------------
# render_accumulate(sample_offset, init_accum) against JAX, every engine
# --------------------------------------------------------------------------


ENGINES = {  # engine -> (scene, camera, jitter)
    "mxu": ("cornell", CAM, False), "pallas": ("reference", {}, False),
    "binned": ("reference", {}, False), "fused": ("cornell", CAM, False),
    "fused_quality": ("reference", {}, True),
}


@pytest.mark.parametrize("engine", list(ENGINES))
def test_render_accumulate_offset_and_init_match_jax(scenes, engine):
    name, cam, jitter = ENGINES[engine]
    scene, jscene = scenes[name]
    eng = "fused" if engine == "fused_quality" else engine
    init = np.random.default_rng(2).random((32 * 16, 3)).astype(np.float32)
    kw = dict(n_samples=3, max_bounces=3, engine=eng, parity=not jitter, sample_offset=5)
    ref = jwave.render_accumulate(jscene, jax.random.PRNGKey(6), JCameraConfig(**cam, jitter=jitter),
                                  (32, 16), init_accum=init, world=jax.jit(jax_bake)(jscene), **kw)
    world = bake_world_triangles(scene)
    cam_t = CameraConfig(**cam, jitter=jitter)
    out = wavefront.render_accumulate(scene, prng_key(6, "cpu"), cam_t, (32, 16),
                                      init_accum=torch.from_numpy(init), world=world, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    bare = wavefront.render_accumulate(scene, prng_key(6, "cpu"), cam_t, (32, 16), world=world, **kw)
    assert torch.equal(out, bare + torch.from_numpy(init))  # added after the chunk's sum
    first = wavefront.render_accumulate(scene, prng_key(6, "cpu"), cam_t, (32, 16), world=world,
                                        **{**kw, "sample_offset": 0})
    assert not torch.equal(first, bare)  # the offset moved the sample stream


def test_binned_groups_start_at_the_offset(scenes):
    """Samples 4 .. 9 as one call (a group of 4 from 4, then 8 and 9 one by
    one) against groups placed by hand."""
    from pathtracerap_tpu_torch.kernels import megakernel as TM
    from pathtracerap_tpu_torch.render.camera import generate_rays

    scene = scenes["reference"][0]
    world = bake_world_triangles(scene)
    ro, rd = generate_rays(RenderConfig().camera, (16, 8), device="cpu")
    key = prng_key(1, "cpu")
    whole = TM.render_samples_binned(world, ro, rd, key, 6, 3, sample_offset=4)
    group = TM.render_samples_binned(world, ro, rd, key, 4, 3, sample_offset=4)
    singles = [TM.render_samples_binned(world, ro, rd, key, 1, 3, sample_offset=s) for s in (8, 9)]
    np.testing.assert_allclose(whole.numpy(), (group + singles[0] + singles[1]).numpy(),
                               atol=1e-6, rtol=0)


# --------------------------------------------------------------------------
# failure handling (tests/test_failure.py:23, :42, :63, :88, :102)
# --------------------------------------------------------------------------


def test_heartbeat_roundtrip_and_staleness(tmp_path):
    hb0 = Heartbeat(str(tmp_path), host_id=0)
    hb1 = Heartbeat(str(tmp_path), host_id=1)
    hb0.beat(iteration=7, extra={"phase": "render"})
    hb1.beat(iteration=7)
    got = hb0.read(0)
    assert got["iteration"] == 7 and got["phase"] == "render"
    assert hb0.stale_hosts([0, 1], timeout_s=60) == []
    assert hb0.stale_hosts([0, 1, 2], timeout_s=60) == [2]
    future = got["ts"] + 120.0
    assert hb0.stale_hosts([0, 1], timeout_s=60, now=future) == [0, 1]


def test_fault_injector_fires_once(monkeypatch):
    inj = FaultInjector(fail_at=2)
    inj.maybe_fail(0)
    inj.maybe_fail(1)
    with pytest.raises(InjectedFault):
        inj.maybe_fail(2)
    inj.maybe_fail(2)  # healed after restart
    monkeypatch.setenv("PTAP_FAULT_INJECT_AT", "1")
    assert FaultInjector().fail_at == 1


def _make_step(shape):
    def step_chunk(accum, samples_done, n):
        contrib = np.zeros(shape, np.float32)
        for s in range(samples_done, samples_done + n):
            contrib += np.float32(1.0 / (1 + s))
        return accum + contrib

    return step_chunk


def test_recovery_resumes_bit_identical(tmp_path):
    shape = (16, 3)
    cfg = {"w": 4, "h": 4, "spp": 10}
    step = _make_step(shape)
    clean = run_with_recovery(step, total_samples=10, chunk_samples=3, accum_shape=shape, seed=0,
                              config=cfg, checkpoint_path=str(tmp_path / "clean.ckpt"))
    assert clean["samples_done"] == 10 and clean["restarts"] == 0
    restarts_seen = []
    faulty = run_with_recovery(
        step, total_samples=10, chunk_samples=3, accum_shape=shape, seed=0, config=cfg,
        checkpoint_path=str(tmp_path / "faulty.ckpt"), injector=FaultInjector(fail_at=2),
        on_restart=lambda k, e: restarts_seen.append(type(e).__name__),
        heartbeat=Heartbeat(str(tmp_path / "hb")),
    )
    assert faulty["restarts"] == 1 and restarts_seen == ["InjectedFault"]
    np.testing.assert_array_equal(faulty["accum"], clean["accum"])
    assert Heartbeat(str(tmp_path / "hb")).read(0)["iteration"] == 10


def test_recovery_ignores_mismatched_config_checkpoint(tmp_path):
    shape = (4, 3)
    step = _make_step(shape)
    path = str(tmp_path / "c.ckpt")
    run_with_recovery(step, total_samples=4, chunk_samples=2, accum_shape=shape, seed=0,
                      config={"spp": 4}, checkpoint_path=path)
    out = run_with_recovery(step, total_samples=2, chunk_samples=2, accum_shape=shape, seed=0,
                            config={"spp": 2}, checkpoint_path=path)
    np.testing.assert_array_equal(out["accum"], step(np.zeros(shape, np.float32), 0, 2))


def test_recovery_gives_up_after_max_restarts(tmp_path):
    def always_fail(accum, samples_done, n):
        raise RuntimeError("hard fault")

    with pytest.raises(RuntimeError, match="hard fault"):
        run_with_recovery(always_fail, total_samples=4, chunk_samples=2, accum_shape=(2, 3),
                          seed=0, config={}, checkpoint_path=str(tmp_path / "x.ckpt"),
                          max_restarts=2)


def test_recovery_drives_the_renderer_exactly(tmp_path, scenes):
    """run_with_recovery over the port's render_accumulate chunks, with an
    injected fault, equals the unbroken chunked render."""
    scene = scenes["cornell"][0]
    cfg = _cfg("mxu")
    r = Renderer(scene, cfg, device="cpu")
    key = prng_key(cfg.seed, "cpu")

    def step_chunk(accum, done, n):
        return wavefront.render_accumulate(
            scene, key, cfg.camera, cfg.resolution, n, cfg.max_bounces, engine="mxu",
            sample_offset=done, init_accum=torch.from_numpy(np.asarray(accum)), world=r.world,
        ).numpy()

    out = run_with_recovery(step_chunk, total_samples=6, chunk_samples=2, accum_shape=(128, 3),
                            seed=cfg.seed, config=cfg.to_dict(),
                            checkpoint_path=str(tmp_path / "rr.ckpt"),
                            injector=FaultInjector(fail_at=1))
    assert out["restarts"] == 1
    full = r.render()
    # the zeros run_with_recovery starts from add nothing
    assert torch.equal(torch.from_numpy(out["accum"]).reshape(8, 16, 3) / 6, full)


# --------------------------------------------------------------------------
# the live-ray curve (tests/test_megakernel.py:72) and metrics
# --------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["mxu", "fused"])
def test_live_ray_curve(scenes, engine):
    scene, jscene = scenes["cornell"]
    cfg = RenderConfig(resolution=(16, 8), samples_per_pixel=1, max_bounces=4,
                       camera=CameraConfig(**CAM), engine=engine)
    curve = live_ray_curve(scene, cfg, prng_key(0, "cpu"))
    assert len(curve) == 4 and curve[0] == 1.0
    assert all(a >= b for a, b in zip(curve, curve[1:]))
    jcfg = JRenderConfig(resolution=(16, 8), samples_per_pixel=1, max_bounces=4,
                         camera=JCameraConfig(**CAM), engine=engine)
    assert curve == jdiag.live_ray_curve(jscene, jcfg, jax.random.PRNGKey(0))


def test_metrics_logger_matches_jax():
    cfg = RenderConfig(resolution=(16, 8), samples_per_pixel=3, max_bounces=2)
    jcfg = JRenderConfig(resolution=(16, 8), samples_per_pixel=3, max_bounces=2)
    a, b = io.StringIO(), io.StringIO()
    port = MetricsLogger(cfg, stream=a)
    port.device = "cpu"  # as Renderer.render sets it for a CPU render
    ref = jmetrics.MetricsLogger(jcfg, stream=b)
    for log in (port, ref):
        log.chunk_done(2, 0.5)
        log.chunk_done(1, 0.125)
        log.record_live_curve([1.0, 0.5])
    assert port.chunks == ref.chunks and a.getvalue() == b.getvalue()
    m, jm = port.finalize(3), ref.finalize(3)
    same = ("resolution", "samples_per_pixel", "max_bounces", "engine", "samples_done", "chunks",
            "live_ray_curve")
    assert {k: getattr(m, k) for k in same} == {k: getattr(jm, k) for k in same}
    assert m.device == "cpu" and json.loads(m.to_json())["samples_done"] == 3
    quiet = MetricsLogger(cfg, stream=io.StringIO(), enabled=False)
    quiet.chunk_done(1, 1.0)
    assert quiet.stream.getvalue() == "" and len(quiet.chunks) == 1


def test_renderer_reports_to_the_metrics_logger(scenes):
    scene = scenes["cornell"][0]
    cfg = _cfg("fused")
    stream = io.StringIO()
    log = MetricsLogger(cfg, stream=stream)
    img = Renderer(scene, cfg, device="cpu").render(metrics=log)
    assert log.device == torch.device("cpu") and log.finalize(6).device == "cpu"
    assert [c["samples"] for c in log.chunks] == [2, 2, 2]
    assert log.live_ray_curve == live_ray_curve(scene, cfg, prng_key(cfg.seed, "cpu"))
    assert stream.getvalue().count("[metrics] chunk") == 3
    assert torch.equal(img, Renderer(scene, cfg, device="cpu").render())


# --------------------------------------------------------------------------
# profiling
# --------------------------------------------------------------------------


def test_profile_trace_writes_the_annotate_names(tmp_path, scenes):
    scene = scenes["cornell"][0]
    cfg = RenderConfig(resolution=(8, 8), samples_per_pixel=1, max_bounces=2,
                       camera=CameraConfig(**CAM), engine="pallas")
    r = Renderer(scene, cfg, device="cpu")
    with profile_trace(str(tmp_path)) as prof:
        with annotate("outer"):
            r.render()
    (path,) = glob.glob(str(tmp_path / "trace_*.json"))
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"outer", "ptap.render", "ptap.trace_primary", "ptap.rng", "ptap.shade",
            "ptap.trace", "ptap.accumulate"} <= names
    assert any(e.key == "ptap.shade" for e in prof.key_averages())


def test_device_memory_report_is_empty_without_a_card():
    assert device_memory_report() == {}


def test_scene_to_device_defaults_to_the_card():
    assert inspect.signature(SceneHost.to_device).parameters["device"].default == "cuda"
    scene = build_cornell_box_scene().to_device("cpu")
    assert scene.device.type == "cpu"
