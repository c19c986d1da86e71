"""Second round: the fixed cost of a visit and the product's depth (P2, port
of ``scripts/prof_kernel_parts2.py``).

    python -m pathtracerap_tpu_torch.scripts.prof_kernel_parts2

  empty        - the kernel copies w[:, 0] to out only (the grid-step floor)
  mm_bf16      - the single-pass bf16 product + min at K=16, looped visits
  mm_k32       - the same at K=32
  mm_k128      - the same at K=128
  mm_unroll    - K=16 with the visit loop unrolled
  mm_k128_unr  - K=128 unrolled

All on ``csrc/prof_parts.cu``, 800,256 rays in tiles of 512, 8 visits.
"""

from __future__ import annotations

import functools

import torch

from ..kernels.prof import P2_VARIANTS, empty
from . import best_ms, normal_inputs, require_card
from .prof_kernel_parts import run_kernel

print = functools.partial(print, flush=True)

R = 512
TB = 512
NB = 8
T = NB * TB
N = 800256
RUNS = [("empty", 16), ("mm_bf16", 16), ("mm_k32", 32), ("mm_k128", 128), ("mm_unroll", 16),
        ("mm_k128_unr", 128)]


def inputs(device, k: int, n: int = N, seed: int = 0):
    """w (n, k), ops (k, 4 * T): standard normals."""
    return normal_inputs([(n, k), (k, 4 * T)], seed, device)


def run(variant: str, w, ops) -> torch.Tensor:
    """One launch of ``variant`` on CUDA tensors."""
    if variant == "empty":
        return empty(w, R)
    k, unroll = P2_VARIANTS[variant]
    return run_kernel("mm_bf16", w, ops, None, R, TB, NB, unroll=unroll)


def main() -> list:
    dev = require_card("prof_kernel_parts2")
    print(f"# {torch.cuda.get_device_name(dev)}")
    nt = N // R
    visits = nt * NB
    out = []
    for variant, k in RUNS:
        w, ops = inputs(dev, k)
        dt = best_ms(lambda: run(variant, w, ops)) / 1e3
        print(f"{variant:12s} K={k:3d}: {dt*1e3:8.4f} ms total, "
              f"{dt/visits*1e6:7.3f} us/visit, {dt/nt*1e6:7.3f} us/tile")
        out.append({"variant": variant, "k": k, "ms": dt * 1e3,
                    "us_per_visit": dt / visits * 1e6, "us_per_tile": dt / nt * 1e6})
        del w, ops
    return out


if __name__ == "__main__":
    main()
