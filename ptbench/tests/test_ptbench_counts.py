"""The roofline metrics' work counts and the trace arithmetic, against small
cases worked out by hand.

Run: ``python -m pytest ptbench/tests -q`` from the repository's root.
"""

import types

import pytest
import torch

from ptbench import devtrace, roofline, spec
from ptbench.reference import tracer
from ptbench.reference.world import World


def quad_world(z=0.0):
    """Two triangles making the unit square [0, 1]^2 at height z."""
    a = torch.tensor([[0.0, 0.0, z], [0.0, 0.0, z]])
    b = torch.tensor([[1.0, 0.0, z], [1.0, 1.0, z]])
    c = torch.tensor([[1.0, 1.0, z], [0.0, 1.0, z]])
    n = torch.tensor([[0.0, 0.0, 1.0]] * 2)
    return World(a=a, b=b, c=c, shade_n=n, model=torch.zeros(2, dtype=torch.int64),
                 mat_type=torch.zeros(2, dtype=torch.int64), mat_color=torch.ones(1, 3))


def test_nearest_hit_on_the_square():
    ops = tracer.operands(quad_world())
    o = torch.tensor([[0.75, 0.25, 5.0], [0.25, 0.75, 2.0], [3.0, 3.0, 5.0]])
    d = torch.tensor([[0.0, 0.0, -1.0]] * 3)
    t, idx = tracer.nearest_hit(ops, o, d)
    assert t.tolist() == [5.0, 2.0, tracer.F_MAX]
    assert idx.tolist() == [0, 1, -1]


@pytest.mark.parametrize("origin, direction, t_end, pairs", [
    ((0.75, 0.25, 5.0), (0.0, 0.0, -1.0), 5.0, 2),  # down onto the square: both boxes
    ((0.75, 0.25, 5.0), (0.0, 0.0, -1.0), 4.9, 0),  # the segment stops short of it
    ((0.75, 0.25, 5.0), (0.0, 0.0, 1.0), tracer.F_MAX, 0),  # away from it
    ((-1.0, 0.5, 0.0), (1.0, 0.0, 0.0), tracer.F_MAX, 2),  # along its plane, through both
    ((-1.0, 0.5, 0.5), (1.0, 0.0, 0.0), tracer.F_MAX, 0),  # above the plane, outside the pad
    ((3.0, 3.0, 5.0), (0.0, 0.0, -1.0), tracer.F_MAX, 0),  # beside it
])
def test_pairs_by_hand(origin, direction, t_end, pairs):
    """Both triangles' boxes are [0, 1] x [0, 1] x [0, 0], padded by EPS
    times the diagonal sqrt(2)."""
    ops = tracer.operands(quad_world())
    n = tracer.count_pairs(ops, torch.tensor([origin]), torch.tensor([direction]),
                           torch.tensor([t_end]))
    assert n.tolist() == [pairs]


def test_box_padding():
    ops = tracer.operands(quad_world())
    pad = tracer.EPS * 2 ** 0.5
    assert torch.allclose(ops.box_lo[:, 0], torch.tensor([-pad, -pad, -pad]))
    assert torch.allclose(ops.box_hi[:, 0], torch.tensor([1 + pad, 1 + pad, pad]))


COUNTS = [  # two units of a 3-bounce cell, 100 rays and 2 samples each
    {"rays": 100, "samples": 2, "primary_pairs": 300, "live": [200, 150, 60],
     "pairs": [0, 700, 240]},
    {"rays": 100, "samples": 2, "primary_pairs": 310, "live": [200, 140, 50],
     "pairs": [0, 650, 200]},
]


def test_total():
    t = roofline.total(COUNTS)
    assert t == {"units": 2, "ray_samples": 400, "primary_pairs": 610, "live": [400, 290, 110],
                 "pairs": [0, 1350, 440]}


def test_roofline_work_by_hand():
    t = roofline.total(COUNTS)
    b3 = spec.reader("bounce_trace_roofline")
    # bounces 1 and 2: 1,790 pairs x 47; 400 live x (40 + 8) + 3 x 10 x 64
    assert b3.work(t, 3, 10) == (1790 * 47, 400 * 48 + 1920)
    b4 = spec.reader("sample_fused_roofline.render")
    # every bounce shaded: 800 live; 400 ray-samples in and out
    assert b4.work(t, 3, 10) == (1790 * 47 + 800 * 250, 400 * 80 + 800 * 16 + 1920)


def test_share():
    # 67 GFLOP in 1 s is 0.1 % of 67 TFLOP/s; bytes bound when larger
    assert roofline.share(67e9, 0.0, 1.0) == pytest.approx(0.1)
    assert roofline.share(0.0, 3.35e9, 0.5) == pytest.approx(0.2)


def fake_trace():
    # device busy on [0, 10] u [5, 15] u [20, 30] inside the window [0, 40] us
    return devtrace.Trace(
        device=[("bounce_kernel", 0.0, 10.0), ("copy", 5.0, 15.0),
                ("bounce_trace_kernel", 20.0, 30.0)],
        host=[("ptbench.window", 0.0, 40.0), ("aten::argsort", 14.0, 19.0),
              ("cudaLaunchKernel", 16.0, 18.0), ("aten::add", 32.0, 38.0)],
        window=(0.0, 40.0))


def test_union_idle_and_gaps():
    tr = fake_trace()
    assert devtrace.union_us([(0, 10), (5, 15), (20, 30)]) == 25
    assert devtrace.busy_s(tr) == pytest.approx(25e-6)
    assert devtrace.idle_share(tr) == pytest.approx(15 / 40)
    # gaps [15, 20] (midpoint 17.5: argsort, the launch inside it left out) and [30, 40]
    assert devtrace.idle_gaps(tr) == [["aten::add", pytest.approx(10e-6)],
                                      ["aten::argsort", pytest.approx(5e-6)]]
    assert devtrace.kernel_time(tr, ("bounce_kernel",)) == (pytest.approx(10e-6), 1)


def test_mirrored_host_spans_are_no_device_operations():
    tr = devtrace.from_events([
        ("ptbench.window", False, 0.0, 40.0), ("shade", False, 1.0, 30.0),
        ("shade", True, 2.0, 31.0), ("bounce_kernel", True, 2.0, 10.0),
    ])
    assert tr.window == (0.0, 40.0)
    assert tr.device == [("bounce_kernel", 2.0, 10.0)]
    assert devtrace.idle_share(tr) == pytest.approx(32 / 40)


def test_readers_on_a_fake_trace():
    ctx = types.SimpleNamespace(trace=fake_trace(), units=2, kind="render",
                                counts=roofline.total(COUNTS), n_triangles=10)
    assert spec.reader("launches_per_frame").read(ctx) == 1.5
    assert spec.reader("device_idle_pct.render").read(ctx) == pytest.approx(37.5)
    flops, nbytes = spec.reader("bounce_trace_roofline").work(ctx.counts, 1, 10)
    want = 100 * max(flops / 67e12, nbytes / 3.35e12) / 10e-6
    assert spec.reader("bounce_trace_roofline").read(ctx) == pytest.approx(want)
    empty = types.SimpleNamespace(trace=devtrace.Trace([], [], (0.0, 1.0)), units=1,
                                  kind="render", counts=None, n_triangles=10)
    for name in ("launches_per_frame", "bounce_trace_roofline", "device_idle_pct.render"):
        assert spec.reader(name).read(empty) is None
