"""The profiling kernels' plain versions (``kernels/prof.py``) against the
Pallas kernels of ``scripts/prof_*.py`` run in interpret mode on the CPU.

The scripts run their work when imported, so the kernel bodies are taken
from their source with ``ast`` and executed in a namespace of small
constants: P1 and P2 at R = TB = 8, NB = 2, N = 32; P3 at 512 x 512; P4's
``empty_variant`` at N = 1,024 with a ``pl`` whose ``pallas_call`` runs in
interpret mode and keeps its inputs and output.  Nothing under
``scripts/`` changes.

Tolerances: the product variants at rtol 1e-5 (the bf16 inputs round alike;
only the order of the f32 sums may differ); accept/argmin/select within
rtol 1e-5 on at least 99.9 % of rays (an accept decision or an argmin at a
near-tie may flip with the sum order); P3 and P4 exact.
"""

import ast
import functools
import os
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from pathtracerap_tpu_torch.kernels import prof as P

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
R, TB, NB, N = 8, 8, 2, 32
T = NB * TB
PRODUCT_RTOL = 1e-5
CHAIN_RTOL, CHAIN_SHARE = 1e-5, 0.999


def _load(script: str, names, **consts) -> dict:
    """The top-level functions ``names`` of ``scripts/<script>``, executed
    in a namespace holding ``consts`` and the modules they use."""
    path = os.path.join(SCRIPTS, script)
    with open(path) as f:
        tree = ast.parse(f.read())
    body = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name in names]
    assert {n.name for n in body} == set(names)
    ns = dict(jax=jax, jnp=jnp, pl=pl, pltpu=pltpu, functools=functools, np=np, time=time,
              **consts)
    exec(compile(ast.Module(body=body, type_ignores=[]), path, "exec"), ns)
    return ns


def _inputs(seed: int, k: int = 16):
    g = np.random.default_rng(seed)
    w = g.standard_normal((N, k)).astype(np.float32)
    ops = g.standard_normal((k, 4 * T)).astype(np.float32)
    attr = g.standard_normal((16, T)).astype(np.float32)
    return w, ops, attr


@pytest.fixture(scope="module")
def p1():
    return _load("prof_kernel_parts.py", {"make_kernel"}, R=R, TB=TB, NB=NB, T=T, N=N,
                 EPS=0.005, F_MAX=9999999.0)


@pytest.fixture(scope="module")
def p2():
    return _load("prof_kernel_parts2.py", {"make_kernel"}, R=R, TB=TB, NB=NB, T=T, N=N,
                 F_MAX=9999999.0)


def _p1_call(kernel, w, ops, attr):
    """``prof_kernel_parts.py:109-120``'s pallas_call, in interpret mode."""
    f = pl.pallas_call(
        kernel,
        grid=(N // R,),
        in_specs=[
            pl.BlockSpec((R, 16), lambda i: (i, 0)),
            pl.BlockSpec((16, 4 * T), lambda i: (0, 0)),
            pl.BlockSpec((16, T), lambda i: (0, 0)),
        ],
        out_specs=pl.BlockSpec((R, 1), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((N, 1), jnp.float32),
        interpret=True,
    )
    return np.asarray(f(w, ops, attr))[:, 0]


def _p2_call(kernel, k, w, ops):
    """``prof_kernel_parts2.py:69-79``'s pallas_call, in interpret mode."""
    f = pl.pallas_call(
        kernel,
        grid=(N // R,),
        in_specs=[
            pl.BlockSpec((R, k), lambda i: (i, 0)),
            pl.BlockSpec((k, 4 * T), lambda i: (0, 0)),
        ],
        out_specs=pl.BlockSpec((R, 1), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((N, 1), jnp.float32),
        interpret=True,
    )
    return np.asarray(f(w, ops))[:, 0]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("variant", P.P1_VARIANTS)
def test_p1_parts_plain_matches_pallas(p1, variant, seed):
    w, ops, attr = _inputs(seed)
    ref = _p1_call(p1["make_kernel"](variant), w, ops, attr)
    before = P.parts_plain.calls
    out = P.parts(variant, torch.from_numpy(w), torch.from_numpy(ops), torch.from_numpy(attr),
                  R, TB, NB).numpy()
    assert P.parts_plain.calls == before + 1 and out.shape == (N,)
    if variant.startswith("mm_"):
        np.testing.assert_allclose(out, ref, rtol=PRODUCT_RTOL, atol=0)
    else:
        share = np.isclose(out, ref, rtol=CHAIN_RTOL, atol=0).mean()
        assert share >= CHAIN_SHARE, share
        assert (ref < 9999999.0).any()  # some ray accepted a triangle


@pytest.mark.parametrize("variant", P.P1_VARIANTS)
def test_p1_parts_plain_chunking_changes_nothing(variant):
    w, ops, attr = (torch.from_numpy(x) for x in _inputs(2))
    whole = P.parts_plain(variant, w, ops, attr, R, TB, NB)
    chunked = P.parts_plain(variant, w, ops, attr, R, TB, NB, rows=R)
    assert torch.equal(whole, chunked)


@pytest.mark.parametrize("variant", ["empty"] + list(P.P2_VARIANTS))
def test_p2_plain_matches_pallas(p2, variant):
    k, _ = P.P2_VARIANTS.get(variant, (16, False))
    w, ops, _ = _inputs(3, k)
    ref = _p2_call(p2["make_kernel"](variant, k), k, w, ops)
    wt, opst = torch.from_numpy(w), torch.from_numpy(ops)
    if variant == "empty":
        np.testing.assert_array_equal(P.empty(wt, R).numpy(), ref)
    else:
        out = P.parts("mm_bf16", wt, opst, None, R, TB, NB).numpy()
        np.testing.assert_allclose(out, ref, rtol=PRODUCT_RTOL, atol=0)


@pytest.mark.parametrize("seed", [1, 5])
def test_p3_argmin_int_plain_matches_pallas(seed):
    ns = _load("prof_r5_shade.py", {"k"})
    g = np.random.default_rng(seed)
    x = g.standard_normal((512, 512)).astype(np.float32)
    bases = np.asarray([3, 9, 1, 7], np.int32)
    # prof_r5_shade.py:108-117
    out = pl.pallas_call(
        ns["k"],
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1,
            grid=(1,),
            in_specs=[pl.BlockSpec((512, 512), lambda i, B: (0, 0))],
            out_specs=[pl.BlockSpec((512, 1), lambda i, B: (0, 0))],
        ),
        out_shape=[jax.ShapeDtypeStruct((512, 1), jnp.int32)],
        interpret=True,
    )(bases, x)[0]
    port = P.argmin_int(torch.from_numpy(x), torch.from_numpy(bases))
    assert port.dtype == torch.int32
    np.testing.assert_array_equal(port.numpy(), np.asarray(out)[:, 0])
    am = np.argmin(x, axis=1)
    np.testing.assert_array_equal(port.numpy(), bases[am // 128] * 128 + am % 128)


def test_p3_argmin_takes_the_first_index():
    x = torch.tensor([[3.0, 1.0, 1.0, 2.0], [0.0, 0.0, -1.0, -1.0]])
    x = torch.cat([x, torch.full((2, 508), 10.0)], dim=1)
    x[1, 300] = -1.0  # a later equal minimum
    out = P.argmin_int_plain(x, torch.tensor([3, 9, 1, 7], dtype=torch.int32))
    assert out.tolist() == [3 * 128 + 1, 3 * 128 + 2]


@pytest.mark.parametrize("with_ops", [True, False])
def test_p4_empty_plain_matches_pallas(with_ops):
    """``empty_variant`` itself, at N = 1,024, through a ``pl`` whose
    ``pallas_call`` runs in interpret mode and keeps what it saw (outside
    ``jax.jit``, so that the inputs are arrays)."""
    seen = []

    class Pl:
        BlockSpec = pl.BlockSpec

        @staticmethod
        def pallas_call(kernel, **kw):
            f = pl.pallas_call(kernel, interpret=True, **kw)

            def call(*args):
                out = f(*args)
                seen.append(([np.array(a) for a in args], np.asarray(out)))
                return out

            return call

    ns = _load("prof_mega_sweep.py", {"empty_variant"}, N=1024, R=512)
    ns["pl"] = Pl
    ns["jax"] = types.SimpleNamespace(jit=lambda f: f, random=jax.random,
                                      ShapeDtypeStruct=jax.ShapeDtypeStruct)
    ns["print"] = lambda *a, **k: None
    ns["empty_variant"](with_ops)
    assert len(seen) == 6  # one warm-up and five timed calls
    (args, ref) = seen[0]
    assert len(args) == (2 if with_ops else 1)
    w = torch.from_numpy(args[0])
    ops = torch.from_numpy(args[1]) if with_ops else None
    np.testing.assert_array_equal(P.empty(w, 512, ops).numpy(), ref[:, 0])


def test_wrappers_refuse_what_they_cannot_run():
    w, ops, attr = (torch.from_numpy(x) for x in _inputs(0))
    with pytest.raises(ValueError, match="unknown variant"):
        P.parts("mm_fp8", w, ops, attr, R, TB, NB)
    with pytest.raises(ValueError, match="do not fill"):
        P.parts("mm_f32", w[:30], ops, attr, R, TB, NB)
    with pytest.raises(ValueError, match="no kernel"):
        P.empty(w.to("meta"), 8)
