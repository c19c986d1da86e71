"""Kernel S1 (``csrc/defer_shade.cu``, the index forward's shading) and the
dispatch of ``kernels/megakernel.py`` to it.

On the CPU: which path a call takes (CPU tensors run the plain twins,
``defer_shade_plain`` and ``primary_shade_plain``, and launch nothing;
tensors on the card, seen through a recorder in the wrapper's place,
launch S1), the wrapper's argument checks, the row-``pix`` read of the
uniform stream against the slice-then-gather it replaces, and the
benchmark's reader of the launches inside the shading spans.  The kernel
itself is held to its plain twins on the card in ``tests/test_torch_cuda.py``.
This file imports no JAX.
"""

import types

import pytest
import torch

from ptbench import devtrace, spec
from pathtracerap_tpu_torch import CameraConfig
from pathtracerap_tpu_torch.kernels import defer_shade as KS
from pathtracerap_tpu_torch.kernels import megakernel as TM
from pathtracerap_tpu_torch.kernels.trace import _slab_margin, trace_pallas
from pathtracerap_tpu_torch.ops.math import normalize
from pathtracerap_tpu_torch.ops.plucker import bake_world_triangles
from pathtracerap_tpu_torch.ops.rng import prng_key
from pathtracerap_tpu_torch.render.camera import generate_rays
from pathtracerap_tpu_torch.scene import build_reference_scene

BOUNCES = 5
CUDA = types.SimpleNamespace(type="cuda")


@pytest.fixture(scope="module")
def world():
    return bake_world_triangles(build_reference_scene().to_device("cpu"))


@pytest.fixture(scope="module")
def slab(world):
    """A 2-sample wavefront of the reference camera's 32x16 primaries after
    bounce 0, and the inputs of its bounce 1: (hits0, ro, rd, u_flat,
    sorted pack, pix, kernel 3's (t, column + 1))."""
    ro, rd = generate_rays(CameraConfig(), (32, 16), device="cpu")
    rd = normalize(rd)
    hits0 = trace_pallas(world, ro, rd)
    pack, u_flat = TM.first_wavefront(world, ro, rd, hits0, prng_key(5, "cpu"), 0, 2, ro.shape[0],
                                      BOUNCES, True, 0)
    pix = torch.arange(pack.shape[0])
    pack, pix = TM.sort_wavefront(pack, pix, *TM.scene_morton_bounds(world.block_aabb))
    ray_tile = TM.binned_ray_tile(world)
    lists, unit = TM.bounce_lists(world, _slab_margin(world.block_aabb), pack, ray_tile)
    tg = TM.bounce_trace(pack, lists, unit, world, ray_tile)
    return types.SimpleNamespace(hits0=hits0, ro=ro, rd=rd, u_flat=u_flat, pack=pack, pix=pix, tg=tg)


@pytest.fixture
def launched(monkeypatch):
    """S1's wrappers replaced by recorders of their arguments, so the
    dispatch of tensors on the card is seen on the CPU."""
    calls = []
    monkeypatch.setattr(KS, "defer_shade", lambda *a: calls.append(("deferred",) + a) or "S1")
    monkeypatch.setattr(KS, "defer_shade_primary",
                        lambda *a: calls.append(("primary",) + a) or "S1")
    return calls


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("form", ["deferred", "primary"])
def test_dispatch_rule(world, slab, launched, monkeypatch, device, form):
    """The tensors' device alone decides: on the card each call is one S1
    launch with the bounce's own arguments (the deferred form reads the
    stream at row pix[i], column block b); on the CPU the plain twin runs
    once and S1 is not called."""
    plain = TM.defer_shade_plain.calls, TM.primary_shade_plain.calls
    s = slab
    if form == "deferred":
        pack = types.SimpleNamespace(device=CUDA) if device == "cuda" else s.pack
        out = TM.defer_shade_apply(world, pack, s.tg, s.u_flat, False, s.pix, 3)
        want = [("deferred", pack, s.tg[0], s.tg[1], world.attr_rows, s.u_flat, False, s.pix, 3)]
    else:
        ro = s.ro
        if device == "cuda":
            ro = types.SimpleNamespace(device=CUDA, shape=s.ro.shape)
            monkeypatch.setattr(TM, "chunk_uniforms", lambda *a: s.u_flat)
        out = TM.first_wavefront(world, ro, s.rd, s.hits0, prng_key(5, "cpu"), 0, 2,
                                 s.ro.shape[0], BOUNCES, True, 0)[0]
        want = [("primary", s.hits0, ro, s.rd, s.u_flat, BOUNCES, True)]
    if device == "cuda":
        assert out == "S1"
        assert len(launched) == 1 and all(a is b for a, b in zip(launched[0][1:], want[0][1:]))
        assert launched[0][0] == want[0][0] and len(launched[0]) == len(want[0])
    else:
        assert out.shape == (s.pack.shape[0], 10) and not launched
    ran = device == "cpu"
    assert (TM.defer_shade_plain.calls - plain[0], TM.primary_shade_plain.calls - plain[1]) == (
        ran and form == "deferred", ran and form == "primary")


@pytest.mark.parametrize("b", range(1, BOUNCES))
@pytest.mark.parametrize("parity", [True, False])
def test_pix_read_equals_the_gathered_uniforms(world, slab, b, parity):
    """The deferred form given the whole stream, pix and b equals it given
    today's ``u_flat[:, 4 * b:4 * b + 4][pix]``, bit for bit, for every
    deferred bounce's column block."""
    s = slab
    got = TM.defer_shade_apply(world, s.pack, s.tg, s.u_flat, parity, s.pix, b)
    want = TM.defer_shade_apply(world, s.pack, s.tg, s.u_flat[:, 4 * b:4 * b + 4][s.pix], parity)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert not torch.equal(got, s.pack)


def _deferred_args(slab, world):
    s = slab
    return dict(pack=s.pack, t=s.tg[0], col1=s.tg[1], attr_rows=world.attr_rows, u=s.u_flat,
                parity=True, pix=s.pix, b=1)


@pytest.mark.parametrize("change, match", [
    (lambda a: a.update(pack=a["pack"][:, :9].contiguous()), "pack: expected"),
    (lambda a: a.update(t=a["t"].double()), "t: expected"),
    (lambda a: a.update(col1=a["col1"].long()), "col1: expected"),
    (lambda a: a.update(col1=a["col1"][:-1]), "col1: expected"),
    (lambda a: a.update(attr_rows=a["attr_rows"][:12].contiguous()), "attr_rows: expected"),
    (lambda a: a.update(pix=a["pix"].int()), "pix: expected"),
    (lambda a: a.update(b=5), "column block 5"),
    (lambda a: a.update(b=-1), "column block -1"),
    (lambda a: a.update(u=a["u"][:, :18].contiguous()), "column block 1"),
    (lambda a: a.update(pix=None), "u: expected"),
    (lambda a: a.update(u=a["u"].t()), "u must be contiguous"),
    (lambda a: None, "no kernel for device cpu"),
], ids=["pack-cols", "t-dtype", "col1-dtype", "col1-rows", "attr-rows", "pix-dtype", "b-past",
        "b-negative", "u-partial-block", "u-not-a-bounce", "u-strided", "cpu"])
def test_deferred_wrapper_checks(world, slab, change, match):
    """Every check raises before a launch."""
    args = _deferred_args(slab, world)
    change(args)
    before = KS.defer_shade.launches
    with pytest.raises(ValueError, match=match):
        KS.defer_shade(**args)
    assert KS.defer_shade.launches == before


@pytest.mark.parametrize("change, match", [
    (lambda a: a.update(u_flat=a["u_flat"][:-1].contiguous()), "whole samples"),
    (lambda a: a.update(max_bounces=0), "a bounce or more"),
    (lambda a: a.update(max_bounces=4), "u_flat: expected"),
    (lambda a: a.update(hits=types.SimpleNamespace(**{**vars(a["hits"]), "mat_ri": None})),
     "no mat_ri"),
    (lambda a: a.update(hits=types.SimpleNamespace(
        **{**vars(a["hits"]), "mat_type": a["hits"].mat_type.float()})), "mat_type: expected"),
    (lambda a: a.update(rd_p=a["rd_p"][:-1]), "rd_p: expected"),
    (lambda a: a.update(rd_p=a["rd_p"].t().contiguous().t()), "rd_p: its rows must be contiguous"),
    (lambda a: a.update(ro_p=a["ro_p"].double()), "ro_p: expected"),
    (lambda a: None, "no kernel for device cpu"),
], ids=["rows-not-samples", "no-bounce", "u-width", "no-ri", "mat-type-dtype", "rd-rows",
        "rd-strided", "ro-dtype", "cpu"])
def test_primary_wrapper_checks(slab, change, match):
    """Every check raises before a launch; the camera's eye expanded to
    every ray (row stride 0) passes."""
    s = slab
    assert s.ro.stride() == (0, 1)
    args = dict(hits=types.SimpleNamespace(**vars(s.hits0)), ro_p=s.ro, rd_p=s.rd, u_flat=s.u_flat,
                max_bounces=BOUNCES, parity=True)
    change(args)
    before = KS.defer_shade.launches
    with pytest.raises(ValueError, match=match):
        KS.defer_shade_primary(**args)
    assert KS.defer_shade.launches == before


def test_shade_launch_metric_reads_the_shade_spans():
    """``shade_launches_per_step`` counts the runtime launches inside the
    ``ptap.shade`` spans a step (the R1 launch nested in bounce 0's
    included), and reads None where the trace has no such span."""
    host = [("ptbench.window", 0.0, 100.0), ("ptap.shade", 0.0, 10.0), ("ptap.rng", 1.0, 3.0),
            ("cudaLaunchKernel", 2.0, 2.5), ("cudaLaunchKernel", 4.0, 5.0),
            ("ptap.shade", 20.0, 30.0), ("cudaLaunchKernel", 21.0, 22.0),
            ("cudaLaunchKernel", 40.0, 41.0)]
    trace = devtrace.Trace(device=[("k", 0.0, 1.0)], host=host, window=(0.0, 100.0))
    reader = spec.reader("shade_launches_per_step")
    assert reader.read(types.SimpleNamespace(trace=trace, units=3)) == pytest.approx(1.0)
    bare = devtrace.Trace(device=[("k", 0.0, 1.0)], host=host[:1] + host[-1:], window=(0.0, 100.0))
    assert reader.read(types.SimpleNamespace(trace=bare, units=3)) is None
