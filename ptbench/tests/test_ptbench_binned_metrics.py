"""The binned render's per-layer metrics (highpoly-render): the rooflines of
kernels B1 (``trace_list_roofline.render``) and B2
(``bounce_roofline.render``) and the sort and worklist spans
(``sort_ms_per_frame``, ``worklists_ms_per_frame``), on traces and work
counts made up by hand.

Run: ``python -m pytest ptbench/tests -q`` from the repository's root.
"""

import types

import pytest

from ptbench import devtrace, roofline, spec

# device operation names as a traced run on the card reports them
KERNELS = {
    "B1": "void trace_list_kernel<false>(float const*, int const*, int, int, float const*, int, "
          "float*, int*, unsigned long long*)",
    "B2": "void bounce_kernel<false>(float const*, float const*, int const*, int, int, "
          "float const*, int, float const*, int, int, float*, int*)",
    "B3": "void bounce_trace_kernel(float const*, int const*, int, int, int, float const*, int, "
          "float*, int*)",
    "B4": "void sample_fused_kernel<false>(float const*, float const*, float const*, int, int, "
          "int, float const*, int, float const*, int, float const*, float const*, int, int, int, "
          "int, int, float*, int*, long long*)",
    "B5": "void nearest_hit_kernel<64>(float const*, float const*, float const*, float const*, "
          "int, float*, int*)",
    "G1": "void grid_dda_kernel<true, true>(GridArgs)",
    "R1": "void (anonymous namespace)::chunk_uniforms_kernel<4>(long long const*, unsigned int, "
          "int, int, int, int, int, unsigned int, int, float*)",
    "sort": "void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<int, long>(int const*)",
}
ROOFLINES = {"trace_list_roofline.render": "B1", "bounce_roofline.render": "B2",
             "bounce_trace_roofline": "B3", "sample_fused_roofline.render": "B4"}
COUNTS = [  # two frames of a 3-bounce cell at one sample a frame, 100 rays each
    {"rays": 100, "samples": 1, "primary_pairs": 300, "live": [100, 75, 30],
     "pairs": [0, 350, 120]},
    {"rays": 100, "samples": 1, "primary_pairs": 310, "live": [100, 70, 25],
     "pairs": [0, 325, 100]},
]


@pytest.mark.parametrize("metric", sorted(ROOFLINES))
def test_each_pattern_matches_its_kernel_alone(metric):
    patterns = spec.reader(metric).PATTERNS
    matched = {k for k, name in KERNELS.items() if any(p in name for p in patterns)}
    assert matched == {ROOFLINES[metric]}


def test_trace_list_work_by_hand():
    t = roofline.total(COUNTS)
    b1 = spec.reader("trace_list_roofline.render")
    # 610 primary pairs x 47; 200 rays x (40 + 8) in and out; 2 launches x 10 x 64
    assert b1.work(t, 2, 10) == (610 * 47, 200 * 48 + 1280)


def test_bounce_work_by_hand():
    t = roofline.total(COUNTS)
    b2 = spec.reader("bounce_roofline.render")
    # bounces 1 and 2: 895 pairs x 47 and 200 live rays shaded x 250;
    # 200 x (40 + 8 + 16); 4 launches x 10 x 64
    assert b2.work(t, 4, 10) == (895 * 47 + 200 * 250, 200 * 64 + 2560)


def _ctx(device, host=()):
    trace = devtrace.Trace(device=device, host=[("ptbench.window", 0.0, 100.0)] + list(host),
                           window=(0.0, 100.0))
    return types.SimpleNamespace(trace=trace, units=2, kind="render",
                                 counts=roofline.total(COUNTS), n_triangles=10)


def test_the_shares_read_their_kernels_time():
    ctx = _ctx([(KERNELS["B1"], 0.0, 4.0), (KERNELS["B2"], 10.0, 30.0),
                (KERNELS["B3"], 40.0, 90.0), (KERNELS["B2"], 30.0, 50.0)])
    for metric, seconds, launches in (("trace_list_roofline.render", 4e-6, 1),
                                      ("bounce_roofline.render", 40e-6, 2)):
        reader = spec.reader(metric)
        want = roofline.share(*reader.work(ctx.counts, launches, 10), seconds)
        assert reader.read(ctx) == pytest.approx(want)


@pytest.mark.parametrize("metric", ["trace_list_roofline.render", "bounce_roofline.render"])
def test_a_share_is_none_where_its_kernel_did_not_run(metric):
    # B3 and B4 ran (a train step, a fused frame), neither B1 nor B2
    ctx = _ctx([(KERNELS["B3"], 0.0, 10.0), (KERNELS["B4"], 10.0, 20.0),
                (KERNELS["R1"], 20.0, 21.0)])
    assert spec.reader(metric).read(ctx) is None
    # nor without the reference's counts, where the kernel ran
    ctx = _ctx([(KERNELS[ROOFLINES[metric]], 0.0, 10.0)])
    ctx.counts = None
    assert spec.reader(metric).read(ctx) is None


def test_the_sort_and_worklist_spans():
    ctx = _ctx([("k", 0.0, 1.0)], host=[
        ("ptap.sort", 0.0, 10.0), ("ptap.worklists", 10.0, 40.0),
        ("ptap.sort", 50.0, 56.0), ("ptap.worklists", 56.0, 60.0)])
    assert spec.reader("sort_ms_per_frame").read(ctx) == pytest.approx(16e-3 / 2)
    assert spec.reader("worklists_ms_per_frame").read(ctx) == pytest.approx(34e-3 / 2)
    # a program without the worklist span (one span held both) reads None
    ctx = _ctx([("k", 0.0, 1.0)], host=[("ptap.sort", 0.0, 40.0)])
    assert spec.reader("worklists_ms_per_frame").read(ctx) is None
    assert spec.reader("sort_ms_per_frame").read(ctx) == pytest.approx(40e-3 / 2)


def test_the_cell_lists_its_metrics():
    c = spec.cell(spec.load_benchmark(), "highpoly-render")
    assert {m["name"] for m in c["end_to_end"]} == {"render_mrays_per_s", "frame_p95_ms",
                                                    "setup_s"}
    assert {m["name"] for m in c["per_layer"]} == {
        "launches_per_frame", "device_idle_pct.render", "trace_list_roofline.render",
        "bounce_roofline.render", "sort_ms_per_frame", "worklists_ms_per_frame"}
