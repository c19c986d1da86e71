"""The per-grid-step floor, kernel 4 per sample and ``trace_mxu`` (P4, port
of ``scripts/prof_mega_sweep.py``).

    python -m pathtracerap_tpu_torch.scripts.prof_mega_sweep

1. The empty-kernel dispatch probe: ``out = w[:, 0]`` over 800,256 rows
   (``csrc/prof_parts.cu``'s copy kernel: thread blocks of 512 threads,
   four rows a thread), with and without an unused (16, 16,384) operand.
   The JAX script divided the time by its 1,563 grid steps; the copy
   kernel's grid is not one step a tile, so only the time is printed.
2. Kernel 4 (``render_samples_fused``) per sample on the reference scene
   at 1000x800, 1 spp, 5 bounces.  JAX swept the megakernel's ``ray_tile``
   over 1024/2048/4096; the port's kernel 4 has one tile (``FUSED_TILE``
   rays per thread block), so this times that tile alone.
3. ``trace_mxu`` on the 800,000 primaries.
"""

from __future__ import annotations

import functools

import torch

from ..config import RenderConfig
from ..kernels import megakernel as MK
from ..kernels.prof import empty
from ..ops.plucker import bake_world_triangles, trace_mxu
from ..ops.rng import prng_key
from ..render.camera import generate_rays
from ..scene.build import build_reference_scene
from . import best_ms, normal_inputs, require_card

print = functools.partial(print, flush=True)

N = 800256
R = 512
OPS_SHAPE = (16, 16384)


def empty_inputs(device, seed: int = 0):
    """w (N, 16), ops (16, 16,384): standard normals."""
    return normal_inputs([(N, 16), OPS_SHAPE], seed, device)


def empty_variant(w, ops, with_ops: bool) -> dict:
    ms = best_ms(lambda: empty(w, R, ops if with_ops else None))
    print(f"empty with_ops={with_ops}: {ms:8.4f} ms")
    return {"ms": ms}


def main() -> dict:
    dev = require_card("prof_mega_sweep")
    print(f"# {torch.cuda.get_device_name(dev)}")
    w, ops = empty_inputs(dev)
    out = {"empty_with_ops": empty_variant(w, ops, True),
           "empty_without_ops": empty_variant(w, ops, False)}
    del w, ops

    world = bake_world_triangles(build_reference_scene().to_device(dev))
    cfg = RenderConfig(resolution=(1000, 800), samples_per_pixel=1, max_bounces=5)
    ro, rd = generate_rays(cfg.camera, cfg.resolution, device=dev)
    key = prng_key(0, dev)
    n = ro.shape[0]
    dt = best_ms(lambda: MK.render_samples_fused(world, ro, rd, key, n_samples=1, max_bounces=5),
                 reps=3) / 1e3
    print(f"megakernel ray_tile={MK.FUSED_TILE} (the port's one tile): {dt*1e3:7.1f} ms/sample "
          f"-> {n*5/dt/1e6:6.1f} Mrays/s counted")
    out["megakernel"] = {"ray_tile": MK.FUSED_TILE, "ms_per_sample": dt * 1e3,
                         "mrays_per_s": n * 5 / dt / 1e6}

    dt = best_ms(lambda: trace_mxu(world, ro, rd).t, reps=3) / 1e3
    print(f"trace_mxu 800k rays (1 bounce-equiv): {dt*1e3:7.1f} ms")
    out["trace_mxu_ms"] = dt * 1e3
    return out


if __name__ == "__main__":
    main()
