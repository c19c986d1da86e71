"""Where the time of one render, or of one train step, goes on one GPU.

    python3 profile_render.py                       # the render
    python3 profile_render.py --train mat_color     # bench.py's train step
    python3 profile_render.py --train vertex_pos    # the same in quality mode

The render is the reference scene at the benchmark configuration
(1000x800, 24 spp, 5 bounces, ``engine="fused"`` routed to the binned
engine) through the port's ``Renderer``.  The train step is
``make_train_step`` at 1000x800, 8 spp, 5 bounces, ``engine="fused"`` on
``mat_color`` (parity mode, bench.py:84-102), or its forward and backward on
``vertex_pos`` in quality mode.  Each is run once to warm up, three times
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


def busy_us(spans) -> float:
    """Length of the union of the (start, end) intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def render_fn(dev):
    from pathtracerap_tpu_torch import RenderConfig, Renderer, build_reference_scene

    cfg = RenderConfig(
        resolution=RESOLUTION, samples_per_pixel=SPP, max_bounces=MAX_BOUNCES, engine="fused"
    )
    r = Renderer(build_reference_scene().to_device(dev), cfg, device=dev)
    return r.render, {"engine": r.engine}


def train_fn(dev, param: str):
    import torch

    from pathtracerap_tpu_torch import CameraConfig, build_reference_scene
    from pathtracerap_tpu_torch.diff import extract_params, loss_and_grad, make_train_step
    from pathtracerap_tpu_torch.ops.rng import prng_key

    scene = build_reference_scene().to_device(dev)
    params = extract_params(scene, (param,))
    target = torch.zeros((RESOLUTION[0] * RESOLUTION[1], 3), device=dev)
    key = prng_key(0, dev)
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

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--train", choices=("mat_color", "vertex_pos"),
                    help="profile a train step on this parameter instead of the render")
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

    run, what = train_fn(dev, args.train) if args.train else render_fn(dev)
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
    busy = busy_us((e.time_range.start, e.time_range.end) for e in kern) / 1e6
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
