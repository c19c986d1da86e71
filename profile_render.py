"""Where the time of one render, or of one train step, goes on one GPU.

    python3 profile_render.py                       # the render
    python3 profile_render.py --quality             # the jittered quality render
    python3 profile_render.py --train mat_color     # bench.py's train step
    python3 profile_render.py --train vertex_pos    # the same in quality mode
    python3 profile_render.py --train pallas        # the default step, Cornell box
    python3 profile_render.py --large beyond        # 2.16 M triangles, no fused pack
    python3 profile_render.py --large beyond_inside # the same from inside the room
    python3 profile_render.py --large megascene     # the suite's 701-block megascene

The render is the reference scene at the benchmark configuration
(1000x800, 24 spp, 5 bounces, ``engine="fused"`` routed to the binned
engine) through the port's ``Renderer``; ``--quality`` renders it with the
jittered quality camera (``parity=False``, ``CameraConfig(jitter=True)``),
which stays on the whole-sample fused engine, kernel 4.  The train step is
``make_train_step`` at 1000x800, 8 spp, 5 bounces, ``engine="fused"`` on
``mat_color`` (parity mode, bench.py:84-102), or its forward and backward on
``vertex_pos`` in quality mode; ``--train pallas`` is ``make_train_step``
with its defaults (the per-bounce pallas diff engine) on the Cornell box at
256x256, 8 spp, 4 bounces.  ``--large`` renders the suite's large scenes
at the megascene's settings (512x512, 2 spp, 6 bounces,
``engine="fused"``): a 2,163,864-triangle sphere in the room, above the
fused pack's budget, so on the per-bounce pallas engine and kernel 5, from
the suite's room camera or from inside the room; or the megascene on the
binned engine.  Each is run once to warm up, three times
timed on the host clock, then once under ``torch.profiler``.  It prints the
unprofiled walls, the profiled wall, the number of device kernels, the
device busy time (the union of the kernel intervals) and its share of the
profiled wall, the device time per kernel name, largest first, and the
operators with the most host time of their own.  It needs one CUDA device
and imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

RESOLUTION = (1000, 800)
SPP = 24
TRAIN_SPP = 8  # bench.py:89
MAX_BOUNCES = 5
TOP = 30  # kernel names listed
CORNELL_RES, CORNELL_BOUNCES = (256, 256), 4  # bench_suite.py:106-114


def render_fn(dev, quality: bool = False):
    from pathtracerap_tpu_torch import CameraConfig, RenderConfig, Renderer, build_reference_scene

    cfg = RenderConfig(
        resolution=RESOLUTION, samples_per_pixel=SPP, max_bounces=MAX_BOUNCES, engine="fused",
        parity=not quality, camera=CameraConfig(jitter=quality),
    )
    r = Renderer(build_reference_scene().to_device(dev), cfg, device=dev)
    return r.render, {"engine": r.engine, "quality": quality}


def large_fn(dev, which: str):
    from pathtracerap_tpu_torch import RenderConfig, Renderer
    from pathtracerap_tpu_torch.bench_suite import (
        _ROOM_CAMERA, INSIDE_CAMERA, build_highpoly_scene, suite_configs,
    )

    spec = suite_configs()["megascene"]
    if which == "megascene":
        host, camera = spec["scene"](), _ROOM_CAMERA
    else:
        host = build_highpoly_scene(subdiv=736, use_asset=False)
        camera = INSIDE_CAMERA if which == "beyond_inside" else _ROOM_CAMERA
    cfg = RenderConfig(**{**spec["cfg"], "samples_per_pixel": spec["measure_spp"],
                          "camera": camera}, engine="fused")
    r = Renderer(host.to_device(dev), cfg, device=dev)
    return r.render, {"large": which, "engine": r.engine, "triangles": r.world.n_valid}


def train_fn(dev, param: str):
    import torch

    from pathtracerap_tpu_torch import CameraConfig, build_reference_scene
    from pathtracerap_tpu_torch.diff import extract_params, loss_and_grad, make_train_step
    from pathtracerap_tpu_torch.ops.rng import prng_key

    key = prng_key(0, dev)
    if param == "pallas":
        from pathtracerap_tpu_torch import build_cornell_box_scene
        from pathtracerap_tpu_torch.bench_suite import suite_configs

        scene = build_cornell_box_scene().to_device(dev)
        params = extract_params(scene, ("mat_color",))
        target = torch.zeros((CORNELL_RES[0] * CORNELL_RES[1], 3), device=dev)
        step = make_train_step(scene, suite_configs()["cornell"]["cfg"]["camera"], CORNELL_RES,
                               TRAIN_SPP, CORNELL_BOUNCES)
        return lambda: step(params, target, key), {"train": "mat_color", "engine": "pallas"}
    scene = build_reference_scene().to_device(dev)
    params = extract_params(scene, (param,))
    target = torch.zeros((RESOLUTION[0] * RESOLUTION[1], 3), device=dev)
    if param == "mat_color":
        step = make_train_step(scene, CameraConfig(), RESOLUTION, TRAIN_SPP, MAX_BOUNCES,
                               tile_size=8192, engine="fused")
        return lambda: step(params, target, key), {"train": param, "parity": True}
    return (lambda: loss_and_grad(params, scene, target, key, CameraConfig(), RESOLUTION,
                                  TRAIN_SPP, MAX_BOUNCES, tile_size=8192, engine="fused",
                                  parity=False),
            {"train": param, "parity": False})


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ptbench.devtrace import union_us

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    what = ap.add_mutually_exclusive_group()
    what.add_argument("--train", choices=("mat_color", "vertex_pos", "pallas"),
                      help="profile a train step on this parameter (or the default step on the "
                           "Cornell box) instead of the render")
    what.add_argument("--quality", action="store_true",
                      help="profile the jittered quality render instead of the parity one")
    what.add_argument("--large", choices=("beyond", "beyond_inside", "megascene"),
                      help="profile a render of one of the suite's large scenes")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_render: no CUDA device", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0], flush=True)

    if args.train:
        run, what = train_fn(dev, args.train)
    elif args.large:
        run, what = large_fn(dev, args.large)
    else:
        run, what = render_fn(dev, args.quality)
    run()  # warm-up: kernel build and first launches

    def wall() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    walls = [wall() for _ in range(3)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pwall = wall()
    kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = union_us((e.time_range.start, e.time_range.end) for e in kern) / 1e6
    print(json.dumps({
        **what, "warm_s": walls, "profiled_wall_s": pwall,
        "kernels": len(kern), "device_busy_s": busy, "busy_share_of_profiled_wall": busy / pwall,
    }), flush=True)
    by = {}
    for e in kern:
        c = by.setdefault(e.name, [0.0, 0])
        c[0] += e.time_range.end - e.time_range.start
        c[1] += 1
    print(f"{'device ms':>10}  {'launches':>8}  kernel")
    for name, (us, cnt) in sorted(by.items(), key=lambda kv: -kv[1][0])[:TOP]:
        print(f"{us / 1e3:10.2f}  {cnt:8d}  {name[:120]}")
    # the host side: operators by their own CPU time
    print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=TOP // 2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
