"""Isolate per-visit costs inside the traversal kernel on the card (P1, port
of ``scripts/prof_kernel_parts.py``).

    python -m pathtracerap_tpu_torch.scripts.prof_kernel_parts

Variants (all: 800,256 rays in tiles of 512, 8 block visits of 4 x 512
columns; ``csrc/prof_parts.cu``):
  mm_bf16    - product only, single-pass bf16
  mm_bf16x3  - product only, the 3-pass bf16 split
  mm_f32     - product only, f32
  accept     - bf16x3 product + accept chain + min
  argmin     - ... + argmin + improve/update
  select     - ... + 7-attribute select per visit
"""

from __future__ import annotations

import functools

import torch

from ..kernels.prof import P1_VARIANTS, parts, parts_plain  # noqa: F401  (parts_plain: the plain version)
from . import best_ms, normal_inputs, require_card

print = functools.partial(print, flush=True)

R = 512
TB = 512
NB = 8
T = NB * TB
N = 800256  # padded ray count
VARIANTS = P1_VARIANTS


def inputs(device, n: int = N, k: int = 16, seed: int = 0):
    """w (n, k), ops (k, 4 * T), attr (16, T): standard normals."""
    return normal_inputs([(n, k), (k, 4 * T), (16, T)], seed, device)


def run_kernel(variant: str, w, ops, attr, r: int = R, tb: int = TB, nb: int = NB,
               unroll: bool = False) -> torch.Tensor:
    """The parts kernel on CUDA tensors; :func:`parts_plain` is the same
    function in plain torch."""
    if w.device.type != "cuda":
        raise ValueError("run_kernel launches the CUDA kernel: pass CUDA tensors")
    return parts(variant, w, ops, attr, r, tb, nb, unroll)


def main() -> list:
    dev = require_card("prof_kernel_parts")
    print(f"# {torch.cuda.get_device_name(dev)}")
    w, ops, attr = inputs(dev)
    nt = N // R
    visits = nt * NB
    out = []
    for v in VARIANTS:
        dt = best_ms(lambda: run_kernel(v, w, ops, attr)) / 1e3
        print(f"{v:10s}: {dt*1e3:7.1f} ms total, {dt/visits*1e6:6.2f} us/visit")
        out.append({"variant": v, "ms": dt * 1e3, "us_per_visit": dt / visits * 1e6})
    return out


if __name__ == "__main__":
    main()
