"""Micro-experiments for the deferred-select design (P3, port of
``scripts/prof_r5_shade.py``).

    python -m pathtracerap_tpu_torch.scripts.prof_r5_shade

1. The cost of a shading pass in torch (the port's ``shade``), a 16-column
   attribute row gather, and the two together at 800 x 1024 rays: plain
   torch on the card, not kernels.
2. Integer arithmetic on an in-kernel argmin and a table of 4 bases
   (``csrc/prof_argmin.cu``, the TPU's lowering check): checked against
   NumPy, then timed.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import RenderConfig
from ..kernels.prof import argmin_int
from ..kernels.trace import trace_pallas
from ..ops import rng
from ..ops.intersect import HitRecord
from ..ops.plucker import bake_world_triangles
from ..render.camera import generate_rays
from ..render.shade import RayState, shade
from ..scene.build import build_reference_scene
from . import best_ms, normal_inputs, require_card

print = functools.partial(print, flush=True)

REP = 16
N_PAD = 800 * 1024
ARGMIN_SHAPE = (512, 512)
BASES = (3, 9, 1, 7)


def shading_setup(device, n_pad: int = N_PAD):
    """The reference scene's world, its 1000x800 primaries padded to
    ``n_pad`` rays and their hits."""
    world = bake_world_triangles(build_reference_scene().to_device(device))
    ro, rd = generate_rays(RenderConfig().camera, (1000, 800), device=device)
    pad = n_pad - ro.shape[0]
    ro_p = torch.cat([ro, ro.new_zeros(pad, 3)])
    rd_p = torch.cat([rd, rd.new_ones(pad, 3)])
    return world, ro_p, rd_p, trace_pallas(world, ro_p, rd_p)


def shading_cases(world, ro_p, rd_p, hits0, key):
    """The three per-repetition functions of the JAX script."""
    n_pad = ro_p.shape[0]
    ar = torch.arange(n_pad, dtype=torch.int32, device=ro_p.device)
    cols = world.attr_rows.shape[1]

    def xla_shade(i):
        u = rng.uniform(rng.fold_in(key, i), n_pad, 4)
        state = RayState.primary(ro_p, rd_p, 5)
        s2 = shade(state, hits0, u, parity=True)
        return s2.color[:, 0].sum() + s2.orig[:, 0].sum()

    def attr_gather(i):
        # 16-col row gather by winning global column (the deferred select)
        idx = (ar * (i + 7)) % cols
        return world.attr_rows.T[idx][:, 0].sum()

    def shade_plus_gather(i):
        u = rng.uniform(rng.fold_in(key, i), n_pad, 4)
        a = world.attr_rows.T[(ar * (i + 7)) % cols]
        rec = HitRecord(
            t=torch.where(a[:, 10] > 0, 100.0, 3.4e38),
            normal=a[:, 0:3], mat_type=a[:, 3].to(torch.int32),
            mat_color=a[:, 4:7], geom_normal=a[:, 7:10],
        )
        state = RayState.primary(ro_p, rd_p, 5)
        s2 = shade(state, rec, u, parity=True)
        return s2.color[:, 0].sum() + s2.orig[:, 0].sum()

    return {"xla_shade": xla_shade, "attr_gather16": attr_gather,
            "shade+gather": shade_plus_gather}


def argmin_case(device, seed: int = 1):
    """x (512, 512) standard normal and the (4,) int32 bases."""
    (x,) = normal_inputs([ARGMIN_SHAPE], seed, device)
    return x, torch.tensor(BASES, dtype=torch.int32, device=device)


def main() -> dict:
    dev = require_card("prof_r5_shade")
    print(f"# {torch.cuda.get_device_name(dev)}")
    key = rng.prng_key(0, dev)
    out = {}
    for name, per_rep in shading_cases(*shading_setup(dev), key).items():
        def loop():
            acc = torch.zeros((), device=dev)
            for i in range(REP):
                acc = acc + per_rep(i)
            return acc

        ms = best_ms(loop, reps=3) / REP
        print(f"{name:18s}: {ms:7.2f} ms/rep")
        out[name] = ms

    x, bases = argmin_case(dev)
    got = argmin_int(x, bases).cpu().numpy()
    ref_am = np.argmin(x.cpu().numpy(), axis=1)
    ref = np.asarray(BASES)[ref_am // 128] * 128 + ref_am % 128
    ok = bool((got == ref).all())
    out["argmin_int_correct"] = ok
    out["argmin_int_ms"] = best_ms(lambda: argmin_int(x, bases))
    print(f"argmin-int-math kernel: compiled and {'CORRECT' if ok else 'WRONG'}, "
          f"{out['argmin_int_ms']:.4f} ms")
    return out


if __name__ == "__main__":
    main()
