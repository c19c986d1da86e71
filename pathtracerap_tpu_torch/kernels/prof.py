"""The profiling kernels (port of the Pallas kernels of ``scripts/prof_*.py``).

* :func:`parts` launches ``csrc/prof_parts.cu``'s parts kernel: one block
  visit of the traversal kernels taken apart (P1,
  ``scripts/prof_kernel_parts.py::make_kernel``; P2's product variants,
  ``scripts/prof_kernel_parts2.py::make_kernel``), on ``ops`` split once
  by :func:`parts_operand` into the order its tensor-core products read;
* :func:`empty` launches its copy kernel, ``out = w[:, 0]`` with or without
  an operand it never reads (P4, ``scripts/prof_mega_sweep.py::empty_variant``,
  and P2's ``empty``);
* :func:`argmin_int` launches ``csrc/prof_argmin.cu`` (P3,
  ``scripts/prof_r5_shade.py::k``).

Each wrapper launches its kernel for CUDA tensors (counted in
``.launches``; :func:`parts` also per variant in ``.variant_launches``) and
runs its plain version for CPU ones.  The plain versions
(:func:`parts_plain`, :func:`empty_plain`, :func:`argmin_int_plain`)
compute the TPU kernels' functions, quirks included, in chunks of rays: at
the scripts' 800,256 rays the whole (N, 16,384) product would be 52 GB.
The scripts (``pathtracerap_tpu_torch/scripts/``) time them.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

from .. import constants
from . import _build
from .trace import _check

F_MAX = constants.FLOAT_MAX
EPS = constants.EPSILON

P1_VARIANTS = ("mm_bf16", "mm_bf16x3", "mm_f32", "accept", "argmin", "select")
# P2's variants: (K, unrolled visit loop); `empty` is the copy kernel
P2_VARIANTS = {
    "mm_bf16": (16, False), "mm_k32": (32, False), "mm_k128": (128, False),
    "mm_unroll": (16, True), "mm_k128_unr": (128, True),
}
_CODES = {"mm_bf16": 0, "mm_bf16x3": 1, "mm_f32": 2, "accept": 3, "argmin": 4, "select": 5,
          "empty": 6}
# the parts kernel's instantiations: (variant, K, unrolled)
PARTS_CONFIGS = frozenset(
    [(v, 16, False) for v in P1_VARIANTS] + [("mm_bf16", k, u) for k, u in P2_VARIANTS.values()]
)
PARTS_TILE = 512  # rays per thread block of the parts kernel (csrc/prof_parts.cu kTile)
PARTS_STAGE_BYTES = 32768  # operand bytes of one staged run (kStageBytes; mm_f32: half)
SELECT_ROWS = 7  # attribute rows the select variant sums
PLAIN_ROWS = 4096  # rays per chunk of the plain version


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16 (to nearest even) and back to float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _operands(variant: str, b: torch.Tensor):
    """The visit's ops columns as the product reads them: f32, bf16, or
    the bf16x3 (hi, lo) pair."""
    if variant == "mm_f32":
        return (b,)
    b_hi = _bf16(b)
    if variant == "mm_bf16":
        return (b_hi,)
    return b_hi, _bf16(b - b_hi)


def parts_run(variant: str, k: int) -> int:
    """Triangles (4 columns each) of one run the parts kernel stages: a
    visit's ``tb`` must be a whole number of runs."""
    if variant == "mm_f32":
        return PARTS_STAGE_BYTES // 2 // (4 * 4 * k)
    return PARTS_STAGE_BYTES // (4 * 2 * k * (1 if variant == "mm_bf16" else 2))


def parts_operand(variant: str, ops: torch.Tensor, tb: int) -> torch.Tensor:
    """``ops`` (K, cols) as the parts kernel reads it, split once; ``tb``
    triangles (4 ``tb`` columns) a visit.

    ``mm_f32``: the transposed (cols, K) f32.  The bf16 variants: (K / 16,
    cols / 8, copies, 2, 8, 8) bf16 in wgmma's core-matrix order, element
    ``[s, pg, c, kb, n, kk]`` = copy ``c`` (hi, then lo for the bf16x3
    variants; as :func:`_operands` rounds them) of ``ops[16 s + 8 kb + kk,
    col]`` at position ``p = 8 pg + n``: per 16-row step and group of 8
    positions, two 8 x 8 core matrices (rows 0-7, 8-15) a copy, a column's
    8 rows contiguous.  Positions take a visit's triangles in groups of 8
    with their four quadrants side by side: quadrant ``q`` of triangle
    ``j`` of visit ``blk`` (column ``blk * 4 tb + q tb + j``) at position
    ``blk * 4 tb + 32 (j // 8) + 8 q + j % 8``."""
    k, cols = ops.shape
    if variant == "mm_f32":
        return ops.t().contiguous()
    hi = ops.to(torch.bfloat16)
    copies = [hi] if variant == "mm_bf16" else [hi, (ops - hi.to(torch.float32)).to(torch.bfloat16)]
    x = torch.stack(copies)  # c, K, cols
    nc = len(copies)
    x = x.reshape(nc, k, cols // (4 * tb), 4, tb // 8, 8).transpose(3, 4)  # c, K, blk, jb, q, j % 8
    x = x.reshape(nc, k // 16, 2, 8, cols // 8, 8)  # c, s, kb, kk, pg, n
    return x.permute(1, 4, 0, 2, 5, 3).contiguous()


def parts_bnorm(ops: torch.Tensor) -> torch.Tensor:
    """The largest L2 norm of a column of ``ops`` (K, cols), as a (1,) f32
    tensor: with each ray's norm it bounds how far the chain variants'
    tensor-core sums may lie from the plain version's (``prof_parts.cu``
    ``kSumErr``)."""
    return torch.linalg.vector_norm(ops, dim=0).amax().reshape(1)


def parts_smem(variant: str, k: int, unroll: bool = False) -> int:
    """The dynamic shared memory the parts kernel's launch of (variant, k,
    unroll) allows its kernel, as the CUDA runtime reports it for the loaded
    kernel (the staging ring, which ``ptxas -v`` does not count)."""
    if (variant, k, unroll) not in PARTS_CONFIGS:
        raise ValueError(f"the parts kernel has no {variant!r} at K={k}, unroll={unroll}")
    n = ctypes.c_int(0)
    err = _build.library().ptt_prof_parts_smem(k, _CODES[variant], int(unroll), ctypes.byref(n))
    _build.check(err, f"ptt_prof_parts_smem({variant}, K={k})")
    return n.value


def _product(variant: str, a: torch.Tensor, bs) -> torch.Tensor:
    """P1's ``mm``: f32, single-pass bf16, or bf16x3 (dot(a_lo, b_hi) +
    dot(a_hi, b_lo) + dot(a_hi, b_hi), each accumulated in f32)."""
    if variant == "mm_f32":
        return a @ bs[0]
    a_hi = _bf16(a)
    if variant == "mm_bf16":
        return a_hi @ bs[0]
    b_hi, b_lo = bs
    a_lo = _bf16(a - a_hi)
    s = a_lo @ b_hi
    s = s + a_hi @ b_lo
    return s + a_hi @ b_hi


def _sum_left(xs):
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + x
    return acc


def parts_plain(variant: str, w: torch.Tensor, ops: torch.Tensor, attr, r: int, tb: int,
                nb: int, rows: int = PLAIN_ROWS) -> torch.Tensor:
    """Plain version of the parts kernel: P1's ``make_kernel(variant)`` (or
    P2's product variants, ``mm_bf16`` at any K) over ``nb`` visits of
    ``4 * tb`` columns, per ray.  w (N, K), ops (K, 4 * tb * nb), attr (16,
    tb * nb) (read by ``select``); N a multiple of the tile ``r``.  Returns
    (N,) f32, the TPU kernel's (N, 1) output.  Rays go in chunks of
    ``rows``; the rays of a tile never meet, so the chunking changes no
    bit."""
    if variant not in P1_VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    n = w.shape[0]
    if n % r:
        raise ValueError(f"{n} rays do not fill tiles of {r}")
    parts_plain.calls += 1
    cols = [_operands(variant, ops[:, blk * 4 * tb:(blk + 1) * 4 * tb]) for blk in range(nb)]
    out = []
    for r0 in range(0, n, rows):
        a = w[r0:r0 + rows]
        best = torch.full((a.shape[0],), F_MAX, device=w.device)
        attrs = torch.zeros((a.shape[0],), device=w.device)
        for blk in range(nb):
            s = _product(variant, a, cols[blk])
            if variant.startswith("mm_"):
                best = torch.minimum(best, s.amin(dim=1))
                continue
            s_ab, s_bc, s_ca, num2 = s[:, 0:tb], s[:, tb:2 * tb], s[:, 2 * tb:3 * tb], s[:, 3 * tb:]
            det = s_ab + s_bc + s_ca
            parallel = det == 0.0
            inv_det = 1.0 / torch.where(parallel, 1.0, det)
            t = num2 * inv_det
            u = s_ca * inv_det
            v = s_ab * inv_det
            accept = (~parallel & (u >= -EPS) & (u <= 1.0 + EPS) & (v >= -EPS)
                      & (u + v <= 1.0 + EPS) & (t >= -EPS))
            blk_min, local_arg = torch.where(accept, t, F_MAX).min(dim=1)  # first index
            if variant == "accept":
                best = torch.minimum(best, blk_min)
                continue
            improve = blk_min < best
            if variant == "argmin":
                attrs = torch.where(improve, local_arg.to(torch.float32) + attrs, attrs)
            else:
                sel = attr[0:SELECT_ROWS, blk * tb + local_arg]  # (7, rows)
                new = _sum_left(list(sel))
                old = _sum_left([attrs] * SELECT_ROWS)
                attrs = torch.where(improve, new, old) + attrs * 0.0
            best = torch.where(improve, blk_min, best)
        out.append(best + attrs)
    return torch.cat(out)


parts_plain.calls = 0


def parts(variant: str, w: torch.Tensor, ops: torch.Tensor, attr, r: int, tb: int, nb: int,
          unroll: bool = False) -> torch.Tensor:
    """The parts kernel (see :func:`parts_plain`): P1's variants at K = 16,
    ``mm_bf16`` also at K = 32 and 128 and, with ``unroll``, with its visit
    loop unrolled (P2).  Launches ``csrc/prof_parts.cu`` for CUDA tensors
    (counted in ``parts.launches`` and ``parts.variant_launches``) on
    ``ops`` split by :func:`parts_operand` inside the call, runs the plain
    version for CPU ones.  The kernel takes whole thread blocks of
    PARTS_TILE rays and visits of whole staged runs (:func:`parts_run`)."""
    n, k = w.shape
    if w.device.type == "cpu":
        return parts_plain(variant, w, ops, attr, r, tb, nb)
    if variant not in P1_VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if (variant, k, unroll) not in PARTS_CONFIGS:
        raise ValueError(f"the parts kernel has no {variant!r} at K={k}, unroll={unroll}")
    if n % r or n % PARTS_TILE:
        raise ValueError(f"{n} rays do not fill tiles of {r} and thread blocks of {PARTS_TILE}")
    run = parts_run(variant, k)
    if tb % run:
        raise ValueError(f"a visit of {tb} triangles is not a whole number of staged runs of {run}")
    if w.device.type != "cuda":
        raise ValueError(f"no kernel for device {w.device}")
    dev = w.device
    _check(w, "w", torch.float32, (n, k), dev)
    _check(ops, "ops", torch.float32, (k, 4 * tb * nb), dev)
    if variant == "select":
        _check(attr, "attr", torch.float32, (16, tb * nb), dev)
    split = parts_operand(variant, ops, tb)
    bnorm = parts_bnorm(ops) if variant in ("accept", "argmin", "select") else None
    out = torch.empty(n, dtype=torch.float32, device=dev)
    err = _build.library().ptt_prof_parts(
        ctypes.c_void_p(w.data_ptr()), ctypes.c_int(n), ctypes.c_int(k), ctypes.c_int(r),
        ctypes.c_void_p(split.data_ptr()), ctypes.c_int(ops.shape[1]),
        ctypes.c_void_p(attr.data_ptr() if attr is not None else None),
        ctypes.c_int(attr.shape[1] if attr is not None else 0),
        ctypes.c_void_p(bnorm.data_ptr() if bnorm is not None else None), ctypes.c_int(tb), ctypes.c_int(nb), ctypes.c_int(_CODES[variant]),
        ctypes.c_int(int(unroll)), ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    _build.check(err, f"ptt_prof_parts({variant}, K={k})")
    parts.launches += 1
    parts.variant_launches[(variant, k, unroll)] += 1
    return out


parts.launches = 0
parts.variant_launches = Counter()


def empty_plain(w: torch.Tensor) -> torch.Tensor:
    """Plain version of the copy kernel: ``w[:, 0]`` (N,)."""
    empty_plain.calls += 1
    return w[:, 0].contiguous()


empty_plain.calls = 0


def empty(w: torch.Tensor, r: int, ops: torch.Tensor = None) -> torch.Tensor:
    """P4 (and P2's ``empty``): ``out = w[:, 0]`` for ``w`` of whole tiles
    of ``r`` rows, in thread blocks of ``r`` threads that copy several rows
    each; ``ops``, when given, is bound to the kernel and never read, as
    the TPU kernel's unused operand.  Launches the copy
    kernel for CUDA tensors (counted in ``empty.launches`` and, by whether
    ``ops`` was bound, in ``empty.variant_launches``), runs the plain
    version for CPU ones."""
    n, k = w.shape
    if w.device.type == "cpu":
        return empty_plain(w)
    if w.device.type != "cuda":
        raise ValueError(f"no kernel for device {w.device}")
    if not 32 <= r <= 1024 or n % r:
        raise ValueError(f"{n} rows do not fill tiles of {r} (32 to 1024 rows)")
    dev = w.device
    _check(w, "w", torch.float32, (n, k), dev)
    if ops is not None:
        _check(ops, "ops", torch.float32, tuple(ops.shape), dev)
    out = torch.empty(n, dtype=torch.float32, device=dev)
    err = _build.library().ptt_prof_parts(
        ctypes.c_void_p(w.data_ptr()), ctypes.c_int(n), ctypes.c_int(k), ctypes.c_int(r),
        ctypes.c_void_p(ops.data_ptr() if ops is not None else None), ctypes.c_int(0),
        ctypes.c_void_p(None), ctypes.c_int(0), ctypes.c_void_p(None), ctypes.c_int(0),
        ctypes.c_int(0), ctypes.c_int(_CODES["empty"]), ctypes.c_int(0), ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    _build.check(err, "ptt_prof_parts(empty)")
    empty.launches += 1
    empty.variant_launches[ops is not None] += 1
    return out


empty.launches = 0
empty.variant_launches = Counter()


def argmin_int_plain(x: torch.Tensor, bases: torch.Tensor) -> torch.Tensor:
    """Plain version of P3: per row the first index ``am`` of the minimum,
    then ``bases[g] * 128 + am % 128`` with ``g = am // 128`` (every
    g >= 3 to ``bases[3]``), in int32.  Returns (rows,) int32."""
    argmin_int_plain.calls += 1
    am = x.argmin(dim=1).to(torch.int32)
    g = am // 128
    b = bases.to(torch.int32)
    base = torch.where(g == 0, b[0], torch.where(g == 1, b[1], torch.where(g == 2, b[2], b[3])))
    return base * 128 + am % 128


argmin_int_plain.calls = 0


def argmin_int(x: torch.Tensor, bases: torch.Tensor) -> torch.Tensor:
    """P3 (see :func:`argmin_int_plain`) on x (rows, cols) f32 and bases
    (4,) int32.  Launches ``csrc/prof_argmin.cu`` for CUDA tensors (counted
    in ``argmin_int.launches``), runs the plain version for CPU ones."""
    rows, cols = x.shape
    if x.device.type == "cpu":
        return argmin_int_plain(x, bases)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    dev = x.device
    _check(x, "x", torch.float32, (rows, cols), dev)
    _check(bases, "bases", torch.int32, (4,), dev)
    out = torch.empty(rows, dtype=torch.int32, device=dev)
    err = _build.library().ptt_prof_argmin(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_int(rows), ctypes.c_int(cols),
        ctypes.c_void_p(bases.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    _build.check(err, "ptt_prof_argmin")
    argmin_int.launches += 1
    return out


argmin_int.launches = 0
