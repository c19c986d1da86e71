"""The profiling scripts of ``scripts/`` that own TPU kernels, on the card.

Each keeps the JAX script's file name, runs nothing when imported, and
runs its measurement as ``python -m pathtracerap_tpu_torch.scripts.<name>``
(a card is required):

* ``prof_kernel_parts``  -- P1: the parts of one block visit;
* ``prof_kernel_parts2`` -- P2: the product's depth, looped or unrolled,
  and the empty kernel;
* ``prof_r5_shade``      -- P3: torch shading and attribute gathers, and
  integer math on an in-kernel argmin;
* ``prof_mega_sweep``    -- P4: the empty-kernel dispatch probe, kernel 4
  per sample and ``trace_mxu``.

Each ``main()`` prints the JAX script's lines, with the card's name first,
and returns its numbers.
"""

from __future__ import annotations

import torch


def require_card(name: str) -> torch.device:
    if not torch.cuda.is_available():
        raise SystemExit(f"{name}: needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def best_ms(fn, reps: int = 5) -> float:
    """The best of ``reps`` CUDA-event timings of ``fn`` after one warm-up
    call, in ms (the JAX scripts keep the best of 5 host timings)."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return min(times)


def normal_inputs(shapes, seed: int, device):
    """Standard normal tensors of ``shapes`` from one seeded generator on
    ``device`` (the JAX scripts draw theirs from ``PRNGKey(0)``)."""
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(s, generator=g, device=device) for s in shapes]
