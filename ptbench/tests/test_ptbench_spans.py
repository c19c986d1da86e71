"""The readers of the program's spans (:mod:`ptbench.spans` and the
metrics built on it): on traces made up by hand, then on a traced run of
each cell at 32x16 on the CPU.

Run: ``python -m pytest ptbench/tests -q`` from the repository's root.
"""

import types

import pytest
import torch

from ptbench import devtrace, run, spans, spec

SEED = 2**31 + 7
# the metrics that read the program's spans, by cell
SPAN_METRICS = {
    "cornell-render": {"rng_ms_per_frame", "rng_launches_per_frame"},
    "reference-train": {"rng_launches_per_step", "bake_ms_per_step", "index_forward_ms_per_step",
                        "index_forward_launches_per_step", "replay_ms_per_step",
                        "backward_ms_per_step"},
}


def ctx_of(host, units=2):
    trace = devtrace.Trace(device=[("k", 0.0, 1.0)], host=[("ptbench.window", 0.0, 100.0)] + host,
                           window=(0.0, 100.0))
    return types.SimpleNamespace(trace=trace, units=units)


def test_span_time_sums_the_intervals():
    # two spans of 10 and 20 us, and a third nested in the second: its
    # union counts once; another span's time is not counted
    ctx = ctx_of([("ptap.rng", 0.0, 10.0), ("ptap.rng", 40.0, 60.0), ("ptap.rng", 45.0, 50.0),
                  ("ptap.bake", 10.0, 40.0)])
    assert spans.intervals(ctx.trace, "ptap.rng") == [(0.0, 10.0), (40.0, 60.0)]
    assert spans.ms_per_unit(ctx, "ptap.rng") == pytest.approx(30e-3 / 2)
    assert spans.ms_per_unit(ctx, "ptap.bake") == pytest.approx(30e-3 / 2)


def test_launches_count_launch_copy_and_set_calls_inside_the_span():
    ctx = ctx_of([
        ("ptap.train.index_forward", 10.0, 30.0), ("ptap.train.index_forward", 50.0, 60.0),
        ("cudaLaunchKernel", 11.0, 12.0),  # counted
        ("cuLaunchKernel", 12.0, 13.0),  # counted
        ("cudaMemcpyAsync", 20.0, 21.0),  # counted
        ("cudaMemsetAsync", 55.0, 56.0),  # counted, in the second interval
        ("cudaStreamSynchronize", 22.0, 25.0),  # no launch
        ("cudaEventRecord", 26.0, 27.0),  # no launch
        ("aten::add", 13.0, 14.0),  # an operator, not a runtime call
        ("cudaLaunchKernel", 35.0, 36.0),  # between the intervals
        ("cudaLaunchKernel", 29.5, 31.0),  # runs past the span's end
        ("cudaLaunchKernel", 5.0, 6.0),  # before
    ])
    assert spans.launches_per_unit(ctx, "ptap.train.index_forward") == 4 / 2


def test_launches_on_another_thread_count():
    # the trace keeps no thread: a launch of autograd's thread inside the
    # backward's interval counts like one of the main thread
    ctx = ctx_of([("ptap.train.backward", 0.0, 50.0), ("autograd::engine::evaluate", 1.0, 49.0),
                  ("cudaLaunchKernel", 2.0, 3.0), ("cudaLaunchKernel", 4.0, 5.0)], units=1)
    assert spans.launches_per_unit(ctx, "ptap.train.backward") == 2


def test_a_span_absent_from_the_trace_reads_none():
    ctx = ctx_of([("rng", 0.0, 10.0), ("cudaLaunchKernel", 1.0, 2.0)])
    assert spans.ms_per_unit(ctx, "ptap.rng") is None
    assert spans.launches_per_unit(ctx, "ptap.rng") is None
    for names in SPAN_METRICS.values():
        for name in names:
            assert spec.reader(name).read(ctx) is None


def test_the_metrics_read_their_spans():
    ctx = ctx_of([("ptap.rng", 0.0, 10.0), ("cudaLaunchKernel", 1.0, 2.0),
                  ("ptap.train.replay", 20.0, 24.0), ("ptap.train.backward", 30.0, 36.0),
                  ("ptap.bake", 40.0, 42.0), ("ptap.train.index_forward", 50.0, 58.0),
                  ("cudaMemcpyAsync", 51.0, 52.0), ("cudaLaunchKernel", 53.0, 54.0)], units=1)
    want = {"rng_ms_per_frame": 0.01, "rng_launches_per_frame": 1, "rng_launches_per_step": 1,
            "bake_ms_per_step": 0.002, "index_forward_ms_per_step": 0.008,
            "index_forward_launches_per_step": 2, "replay_ms_per_step": 0.004,
            "backward_ms_per_step": 0.006}
    assert {k: spec.reader(k).read(ctx) for k in want} == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_a_traced_run_reports_the_span_metrics(name):
    c = spec.cell(spec.load_benchmark(), name)
    c["config"]["resolution"] = [32, 16]
    assert SPAN_METRICS[name] <= {m["name"] for m in c["per_layer"]}
    result = run.run_cell(c, SEED, 0.3, True, torch.device("cpu"))
    values = {k: result["metrics"][k]["value"] for k in SPAN_METRICS[name]}
    # on the CPU the spans take time and no CUDA runtime call is made
    assert all(v > 0 for k, v in values.items() if "_ms_" in k), values
    assert all(v == 0 for k, v in values.items() if "_launches_" in k), values
