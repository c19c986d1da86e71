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


def _unpack_operand(variant: str, split: torch.Tensor, k: int, tb: int) -> torch.Tensor:
    """:func:`P.parts_operand` read back in the kernel's index order: (copies,
    K, cols) f32, copy c of row 16 s + 8 kb + kk at position p = 8 pg + n
    from element [s, pg, c, kb, n, kk], position p of visit blk holding
    quadrant q = (p % 32) // 8 of triangle j = 8 ((p % 4 tb) // 32) + p % 8
    (``mm_f32``: the transposed (cols, K))."""
    if variant == "mm_f32":
        return split.t()[None]
    ks, groups, copies, kbs, ns, kks = split.shape
    assert (ks * 16, kbs, ns, kks) == (k, 2, 8, 8)
    cols = groups * 8
    out = torch.empty((copies, k, cols), dtype=torch.float32)
    for p in range(cols):
        blk, r = divmod(p, 4 * tb)
        q, j = (r % 32) // 8, 8 * (r // 32) + r % 8
        col = blk * 4 * tb + q * tb + j
        for s in range(ks):
            for kb in range(2):
                out[:, 16 * s + 8 * kb:16 * s + 8 * kb + 8, col] = split[s, p // 8, :, kb, p % 8, :].float()
    return out


@pytest.mark.parametrize("k", [16, 32, 128])
@pytest.mark.parametrize("variant", ["mm_bf16", "mm_bf16x3", "mm_f32"])
def test_parts_operand_is_the_products_operands(variant, k):
    """The wrapper's pre-split, unpacked in the kernel's index order, is
    bit for bit what the plain version multiplies (``_operands``)."""
    g = np.random.default_rng(k)
    tb = 24  # three groups of 8 triangles a visit, two visits
    ops = torch.from_numpy((g.standard_normal((k, 4 * tb * 2)) * 10.0 ** g.integers(-3, 4, (k, 1)))
                           .astype(np.float32))
    split = P.parts_operand(variant, ops, tb)
    assert split.is_contiguous()
    assert split.dtype == (torch.float32 if variant == "mm_f32" else torch.bfloat16)
    assert split.dim() == (2 if variant == "mm_f32" else 6)
    want = torch.stack(P._operands(variant, ops))
    got = _unpack_operand(variant, split, k, tb)
    assert got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _kernel_floats(*names) -> list:
    """Float constants of ``csrc/prof_parts.cu`` (``constexpr float NAME =
    EXPR;``), evaluated as Python floats."""
    import re

    from pathtracerap_tpu_torch.kernels import _build

    text = (_build.CSRC / "prof_parts.cu").read_text()
    out = []
    for name in names:
        (expr,) = re.findall(rf"constexpr float {name} = ([^;]+);", text)
        terms = [float.fromhex(x[:-1]) if x.startswith("0x") else float(x.rstrip("f"))
                 for x in expr.split(" / ")]
        out.append(terms[0] / terms[1] if len(terms) == 2 else terms[0])
    return out


def _fmaf(a, b, c):
    """fmaf in float32: the product exact in float64, one rounding to float32
    after the add (a second rounding through float64 is far inside the
    margins under test)."""
    return (a.double() * b.double() + c.double()).float()


def _chain_t_lo(s_ab, s_bc, s_ca, num, e2, e6, k_deg, k_off, rcp_ulps, side_bound):
    """``prof_parts.cu``'s chain_t_lo in float32 torch, operation by
    operation; the 1-ulp reciprocal (rcp.approx) as the correctly rounded
    one moved by ``rcp_ulps`` (-1, 0 or 1) ulps."""
    det = (s_ab + s_bc) + s_ca
    inv = 1.0 / det
    inv = torch.where(rcp_ulps > 0, torch.nextafter(inv, inv * 2),
                      torch.where(rcp_ulps < 0, torch.nextafter(inv, inv * 0), inv))
    tt = num * inv
    ai = inv.abs()
    mn = torch.fmin(torch.fmin(s_ca * inv, s_ab * inv), torch.fmin(s_bc * inv, tt))
    t_lo = torch.where(_fmaf(ai, e2, mn) >= side_bound, tt - ai * _fmaf(e6, tt.abs(), e2),
                       torch.full_like(tt, float("inf")))
    return torch.where(det.abs() < e6, _fmaf(num.abs(), k_deg, -k_off), t_lo)


@pytest.mark.parametrize("case", ["boundary", "near_degenerate", "random"])
def test_chain_t_lo_bounds_every_accepted_t(case):
    """The chain variants' test on the tensor cores' sums is conservative:
    for plain sums s, and sums s~ within e = kSumErr max|s| of them (the
    kernel's e is kSumErr ||a~|| max||b||, at least that), every pair the
    plain chain (accept_t<true> on s) accepts at t gets a bound t_lo(s~)
    <= t.  Pairs are built around the chain's bounds (u, v, t at -0.005, u
    and u + v at 1.005, by a few ulps), at determinants near the margin's
    e (where det's sign is unknown), and at random; s~ - s at +-e, between,
    or at +-e towards a larger t, the reciprocal 1 ulp off either way."""
    sum_err, k_e2, k_e6, side_bound = _kernel_floats("kSumErr", "kE2", "kE6", "kSideBound")
    g = np.random.default_rng({"boundary": 3, "near_degenerate": 4, "random": 5}[case])
    n = 1_000_000
    scale = np.exp2(g.uniform(-60, 60, n))
    if case == "near_degenerate":
        det = g.uniform(0.5, 40.0, n) * sum_err * g.choice([-1.0, 1.0], n)
    else:
        det = g.uniform(0.05, 3.0, n) * g.choice([-1.0, 1.0], n)
    if case == "random":
        u, v = g.uniform(-0.5, 1.5, n), g.uniform(-0.5, 1.5, n)
        t = g.uniform(-2.0, 50.0, n)
    else:
        eps = g.uniform(-3e-7, 3e-7, (n, 3))
        u = g.choice([-0.005, 1.005, 0.3], n) + eps[:, 0]
        v = np.where(g.random(n) < 0.5, -0.005 + eps[:, 1], 1.005 - u + eps[:, 1])
        t = g.choice([-0.005, 0.0, 7.0], n) + eps[:, 2]
    ca, ab = u * det, v * det
    bc, num = det - ab - ca, t * det
    if case == "near_degenerate":  # t * det of order 1, det of order e
        num = g.uniform(-0.01, 1.0, n)
    s = torch.from_numpy(np.stack([ab, bc, ca, num]) * scale).float()
    mag = s.abs().amax(dim=0)
    e = (sum_err * mag.double() * torch.from_numpy(g.choice([1.0, 1.0, 4.0], n))).float()
    pick = g.integers(0, 3, (4, n))
    delta = np.where(pick == 0, -1.0, np.where(pick == 1, 1.0, g.uniform(-1.0, 1.0, (4, n))))
    # or against the bound: s~'s t above s's (num~ away from 0, det~ towards it)
    worst = g.random(n) < 0.5
    sd, sn = np.sign(det), np.sign(num)
    delta[:3, worst] = (-sd * sn)[worst]
    delta[3, worst] = sd[worst]
    s_tc = (s.double() + torch.from_numpy(delta) * e.double()).float()
    e2 = (k_e2 * e.double()).float()
    e6 = (k_e6 * e.double()).float()
    k_deg = torch.tensor(1.0 - 2.0 ** -20, dtype=torch.float32) / (2.0 * e6)
    k_off = _fmaf(k_deg, e2, torch.full_like(e2, 0.01))
    rcp = torch.from_numpy(g.integers(-1, 2, n))
    t_lo = _chain_t_lo(*s_tc, e2, e6, k_deg, k_off, rcp, side_bound)
    deg = ((s_tc[0] + s_tc[1]) + s_tc[2]).abs() < e6
    ab_, bc_, ca_, num_ = s
    det_ = (ab_ + bc_) + ca_
    inv = 1.0 / torch.where(det_ == 0.0, 1.0, det_)  # accept_t<true>: det == 0 masked
    t_plain, u_, v_ = num_ * inv, ca_ * inv, ab_ * inv
    acc = ((det_ != 0.0) & (u_ >= -0.005) & (v_ >= -0.005) & (t_plain >= -0.005)
           & (u_ <= 1.005) & (u_ + v_ <= 1.005))
    assert acc.sum() > n // 50  # the cases reach the chain's bounds
    assert not (acc & ~(t_lo <= t_plain)).any()
    if case == "near_degenerate":  # where det's sign is unknown the bound still excludes most
        assert deg.sum() > n // 10 and (deg & (t_lo > 1.0)).sum() > 0.5 * deg.sum()
    if case == "random":  # and the test leaves out most of what the chain rejects
        assert (torch.isinf(t_lo) & (t_lo > 0) & ~acc).sum() > 0.5 * (~acc).sum()


def test_parts_refuses_what_its_kernel_cannot_take():
    """The wrapper's checks, reached with meta tensors (no kernel runs):
    whole thread blocks of PARTS_TILE rays, visits of whole staged runs,
    and the configurations the kernel was built for."""
    assert P.PARTS_TILE == 512
    assert [P.parts_run(v, 16) for v in P.P1_VARIANTS] == [256, 128, 64, 128, 128, 128]
    assert (P.parts_run("mm_bf16", 32), P.parts_run("mm_bf16", 128)) == (128, 32)

    def call(variant, n, k=16, tb=512, nb=8, r=512, unroll=False):
        w = torch.empty((n, k), device="meta")
        ops = torch.empty((k, 4 * tb * nb), device="meta")
        attr = torch.empty((16, tb * nb), device="meta")
        return P.parts(variant, w, ops, attr, r, tb, nb, unroll)

    with pytest.raises(ValueError, match="thread blocks of 512"):
        call("argmin", 768, r=256)  # whole tiles of 256, not of the kernel's 512
    with pytest.raises(ValueError, match="staged runs of 128"):
        call("select", 1024, tb=192)  # 192 triangles: not a whole run of 128
    with pytest.raises(ValueError, match="staged runs of 256"):
        call("mm_bf16", 1024, tb=128)
    with pytest.raises(ValueError, match="no 'accept' at K=32"):
        call("accept", 1024, k=32)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        call("select", 1024, tb=256)
    with pytest.raises(ValueError, match="no 'accept' at K=32"):
        P.parts_smem("accept", 32)


def test_parts_bnorm_bounds_every_column():
    """The chain variants' column bound is the largest L2 norm of a column
    of ops: at least every column's, and one column's exactly."""
    g = np.random.default_rng(9)
    ops = torch.from_numpy((g.standard_normal((16, 256)) * g.uniform(0.1, 10.0, 256))
                           .astype(np.float32))
    bn = P.parts_bnorm(ops)
    norms = torch.linalg.vector_norm(ops, dim=0)
    assert bn.shape == (1,) and bn.dtype == torch.float32
    assert (norms <= bn).all() and (norms == bn).any()


def test_wrappers_refuse_what_they_cannot_run():
    w, ops, attr = (torch.from_numpy(x) for x in _inputs(0))
    with pytest.raises(ValueError, match="unknown variant"):
        P.parts("mm_fp8", w, ops, attr, R, TB, NB)
    with pytest.raises(ValueError, match="do not fill"):
        P.parts("mm_f32", w[:30], ops, attr, R, TB, NB)
    with pytest.raises(ValueError, match="no kernel"):
        P.empty(w.to("meta"), 8)
