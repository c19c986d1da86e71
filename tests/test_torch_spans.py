"""The port's spans (``utils/profiling.py::annotate``): free when no
profiler runs, and under one each ``ptap.*`` span at its count a frame or
a step, nested as the layers are, with outputs equal bit for bit to the
untraced ones.

The cases are the benchmark's two cells at 32×16 on the CPU: a
reference-scene ``mat_color`` step on the fused diff engine (2 spp × 5
bounces: one slab, the binned deferred-trace forward in two sample groups)
and a Cornell-box frame on the fused engine (16 spp × 4 bounces: two
batches of 8 samples).
"""

import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pathtracerap_tpu_torch import (
    CameraConfig, RenderConfig, Renderer, build_cornell_box_scene, build_reference_scene,
)
from pathtracerap_tpu_torch.diff import extract_params, make_train_step
from pathtracerap_tpu_torch.ops.rng import prng_key
from pathtracerap_tpu_torch.utils import annotate

CAM = dict(position=(0.0, 0.0, 150.0), plane_x=(-40.0, 40.0), plane_y=(-30.0, 30.0),
           plane_z=100.0)
RES = (32, 16)
SEED = 3_000_000_019  # a 32-bit seed above 2**31

# each span's count in one unit: the step has one slab of 512 rays, two
# sample groups of one sample, 5 bounces; the frame two batches of 8
COUNTS = {
    "train": {
        "ptap.train.step": 1,
        "ptap.bake": 1,
        "ptap.train.index_forward": 3,  # the primary trace, then one a group
        "ptap.trace_primary": 1,
        "ptap.rng": 2,
        "ptap.shade": 10,  # bounce 0 and 4 deferred bounces, a group
        "ptap.sort": 8,
        "ptap.worklists": 8,
        "ptap.train.replay": 2,
        "ptap.train.backward": 1,
    },
    "frame": {"ptap.render": 1, "ptap.trace_primary": 1, "ptap.rng": 2},
}


def _train_unit():
    scene = build_reference_scene().to_device("cpu")
    step = make_train_step(scene, CameraConfig(), RES, 2, 5, engine="fused")
    params = {k: v.clone() for k, v in extract_params(scene, ("mat_color",)).items()}
    target = torch.rand((RES[0] * RES[1], 3), generator=torch.Generator().manual_seed(0))

    def unit():
        loss, new = step(params, target, prng_key(SEED, "cpu"))
        return loss, new["mat_color"]

    return unit


def _frame_unit():
    cfg = RenderConfig(resolution=RES, samples_per_pixel=16, max_bounces=4, engine="fused",
                       camera=CameraConfig(**CAM))
    r = Renderer(build_cornell_box_scene().to_device("cpu"), cfg, device="cpu")
    return lambda: (r.render(seed=SEED),)


UNITS = {"train": _train_unit, "frame": _frame_unit}


def _spans(prof):
    """The ``ptap.*`` host events of a finished profile, read from its raw
    events (``prof.events()`` builds an object an event: seconds here)."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events() if e.name().startswith("ptap.")]


@pytest.fixture(scope="module")
def runs():
    """Per case: (untraced outputs, traced outputs, the traced spans as
    (name, start ns, end ns))."""
    out = {}
    for case, make in UNITS.items():
        unit = make()
        plain = unit()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            traced = unit()
        out[case] = (plain, traced, _spans(prof))
    return out


def test_annotate_off_enters_no_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    with annotate("ptap.test"):
        pass
    img = _frame_unit()()[0]
    assert bool(torch.isfinite(img).all())


def test_annotate_on_calls_no_nvtx(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("an NVTX function was called")

    for name in ("range", "range_push", "range_pop", "mark"):
        monkeypatch.setattr(torch.cuda.nvtx, name, refuse)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with annotate("ptap.test"):
            torch.ones(4).sum()
    assert [name for name, _, _ in _spans(prof)] == ["ptap.test"]


@pytest.mark.parametrize("case", sorted(COUNTS))
def test_span_counts_a_unit(runs, case):
    counts = collections.Counter(name for name, _, _ in runs[case][2])
    assert dict(counts) == COUNTS[case]


@pytest.mark.parametrize("case", sorted(COUNTS))
def test_traced_outputs_equal_untraced(runs, case):
    plain, traced, _ = runs[case]
    assert len(plain) == len(traced)
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)


def _inside(span, parents):
    _, s, e = span
    return any(ps <= s and e <= pe for _, ps, pe in parents)


@pytest.mark.parametrize("child,parent", [
    ("ptap.bake", "ptap.train.step"),
    ("ptap.train.index_forward", "ptap.train.step"),
    ("ptap.train.replay", "ptap.train.step"),
    ("ptap.train.backward", "ptap.train.step"),
    ("ptap.rng", "ptap.train.index_forward"),
    ("ptap.sort", "ptap.train.index_forward"),
    ("ptap.worklists", "ptap.train.index_forward"),
    ("ptap.shade", "ptap.train.index_forward"),
    ("ptap.trace_primary", "ptap.train.index_forward"),
])
def test_train_spans_nest(runs, child, parent):
    spans = runs["train"][2]
    parents = [sp for sp in spans if sp[0] == parent]
    children = [sp for sp in spans if sp[0] == child]
    assert children and parents
    assert all(_inside(c, parents) for c in children)


def test_frame_spans_nest_in_the_render(runs):
    spans = runs["frame"][2]
    render = [sp for sp in spans if sp[0] == "ptap.render"]
    assert all(_inside(sp, render) for sp in spans if sp[0] != "ptap.render")
