"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``pathtracerap_tpu_torch/csrc`` with
nvcc, holds each kernel against its plain PyTorch version at the shapes of
the main path, then renders the reference scene at the benchmark
configuration (1000x800, 24 spp, 5 bounces, ``engine="fused"`` routed to
the binned engine) through the port's ``Renderer`` and checks the image
against the committed golden.  Every check raises on failure, so the script
exits non-zero before its last line, which is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

It needs one CUDA device and exits non-zero without a result when there is
none.  It imports no JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "assets", "golden", "reference_scene.bmp")
RESOLUTION = (1000, 800)
SPP = 24
MAX_BOUNCES = 5
SLAB = 16 * 8192  # rays of one binned slab (BINNED_SLAB_TILES RNG tiles)
SAMPLE_BATCH = 4
K1_IDX_SHARE, K1_T_REL = 0.9999, 1e-5
K2_HIT_SHARE, K2_STATE_ABS = 0.9999, 1e-4


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, reps: int = 10) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` (after one warm-up)."""
    import torch

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
    return statistics.median(times)


def downsample(x, f: int):
    h, w, _ = x.shape
    return x[: h - h % f, : w - w % f].reshape(h // f, f, w // f, f, 3).mean(axis=(1, 3))


def kernel1_vs_plain(world, dev):
    """Kernel 1 against its plain version on the primary rays."""
    import torch

    from pathtracerap_tpu_torch import CameraConfig
    from pathtracerap_tpu_torch.kernels.trace import (
        RAY_TILE, nearest_hit_fused, nearest_hit_fused_plain, primary_inputs,
    )
    from pathtracerap_tpu_torch.render.camera import generate_rays

    ro, rd = generate_rays(CameraConfig(), RESOLUTION, device=dev)
    n = ro.shape[0]
    w16, lists = primary_inputs(world, ro, rd)
    nb, tb = world.block_aabb.shape[0], world.tri_block

    def kern():
        return nearest_hit_fused(w16, world.fused_ops, lists, RAY_TILE, tb)

    def plain():
        return nearest_hit_fused_plain(w16, world.fused_ops, nb, tb)

    t_k, i_k = kern()
    t_p, i_p = plain()
    t_k, i_k, t_p, i_p = t_k[:n], i_k[:n], t_p[:n], i_p[:n]
    same = i_k == i_p
    both = same & (i_p >= 0)
    share = same.float().mean().item()
    d = (t_k - t_p).abs()[both]
    max_abs = d.max().item() if d.numel() else 0.0
    rel = (d / t_p[both].abs().clamp_min(1e-30)).max().item() if d.numel() else 0.0
    res = {
        "rays": n, "hit_share": (i_p >= 0).float().mean().item(), "idx_equal_share": share,
        "t_bit_equal_share": (t_k.view(torch.int32) == t_p.view(torch.int32)).float().mean().item(),
        "max_rel_t": rel, "max_abs_err": max_abs,
    }
    check(share >= K1_IDX_SHARE, f"kernel 1 idx equal share {share} >= {K1_IDX_SHARE}")
    check(rel <= K1_T_REL, f"kernel 1 max rel t diff {rel} <= {K1_T_REL}")
    res["ms"] = cuda_ms(kern)
    res["plain_ms"] = cuda_ms(plain)
    # the render launches kernel 1 once per slab of SLAB rays
    w_s, lists_s = primary_inputs(world, ro[:SLAB], rd[:SLAB])
    res["slab_rays"] = w_s.shape[0]
    res["slab_ms"] = cuda_ms(lambda: nearest_hit_fused(w_s, world.fused_ops, lists_s, RAY_TILE, tb))
    return res


def kernel2_vs_plain(world, dev):
    """Kernel 2 against its plain version on bounce 1 of the first
    4-sample slab, the sorted wavefront ``render_samples_binned`` builds."""
    import torch

    from pathtracerap_tpu_torch import CameraConfig
    from pathtracerap_tpu_torch.kernels.megakernel import (
        binned_ray_tile, bounce, bounce_lists, bounce_plain, first_wavefront,
        scene_morton_bounds, sort_wavefront,
    )
    from pathtracerap_tpu_torch.kernels.trace import _slab_margin, trace_pallas
    from pathtracerap_tpu_torch.ops.math import normalize
    from pathtracerap_tpu_torch.ops.rng import prng_key
    from pathtracerap_tpu_torch.render.camera import generate_rays

    ro, rd = generate_rays(CameraConfig(), RESOLUTION, device=dev)
    ro, rd = ro[:SLAB], normalize(rd[:SLAB])
    n = ro.shape[0]
    ray_tile = binned_ray_tile(world)
    check(n % ray_tile == 0, "slab fills whole ray tiles")
    hits0 = trace_pallas(world, ro, rd)
    pack, u_flat = first_wavefront(
        world, ro, rd, hits0, prng_key(0, dev), 0, SAMPLE_BATCH, n, MAX_BOUNCES, True, 0
    )
    pix = torch.arange(pack.shape[0], device=dev)
    pack, pix = sort_wavefront(pack, pix, *scene_morton_bounds(world.block_aabb))
    u_b = u_flat[:, 4:8][pix]
    lists, unit = bounce_lists(world, _slab_margin(world.block_aabb), pack, ray_tile)

    def kern():
        return bounce(pack, u_b, lists, unit, world, ray_tile, True)

    def plain():
        return bounce_plain(pack, u_b, world, True)

    out_k, i_k = kern()
    out_p, i_p = plain()
    live = pack[:, 9] > 0
    agree = (i_k == i_p) & live
    share = (agree.sum() / live.sum().clamp_min(1)).item()
    d = (out_k - out_p).abs()[agree]
    max_abs = d.max().item() if d.numel() else 0.0
    res = {
        "rays": pack.shape[0], "live": int(live.sum().item()), "ray_tile": ray_tile, "unit": unit,
        "mean_list_len": (lists >= 0).sum(dim=1).float().mean().item(),
        "hit_agree_share": share, "max_abs_err": max_abs,
        "max_abs_err_per_col": [round(x, 9) for x in (d.amax(dim=0).tolist() if d.numel() else [])],
        "dead_pass_through": bool(torch.equal(out_k[~live], pack[~live])),
    }
    check(share >= K2_HIT_SHARE, f"kernel 2 hit agree share {share} >= {K2_HIT_SHARE}")
    check(max_abs <= K2_STATE_ABS, f"kernel 2 max state diff {max_abs} <= {K2_STATE_ABS}")
    check(res["dead_pass_through"], "kernel 2 leaves dead rays unchanged")
    res["ms"] = cuda_ms(kern)
    res["plain_ms"] = cuda_ms(plain)
    return res


def main_path(dev):
    """The port's main path: Renderer(engine="fused") on the reference
    scene, with the kernels' launch counts taken over one render."""
    import numpy as np
    import torch

    from pathtracerap_tpu_torch import RenderConfig, Renderer, build_reference_scene, read_bmp
    from pathtracerap_tpu_torch.kernels.megakernel import bounce, bounce_plain
    from pathtracerap_tpu_torch.kernels.trace import nearest_hit_fused, nearest_hit_fused_plain

    cfg = RenderConfig(
        resolution=RESOLUTION, samples_per_pixel=SPP, max_bounces=MAX_BOUNCES, engine="fused"
    )
    r = Renderer(build_reference_scene().to_device(dev), cfg, device=dev)
    check(r.engine == "binned", f"engine routed to {r.engine!r}, expected 'binned'")
    r.render()  # warm-up
    for f in (nearest_hit_fused, bounce):
        f.launches = 0
    for f in (nearest_hit_fused_plain, bounce_plain):
        f.calls = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = r.render()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    res = {
        "engine": r.engine, "render_s": dt,
        "mrays_per_s": RESOLUTION[0] * RESOLUTION[1] * SPP * MAX_BOUNCES / dt / 1e6,
        "trace_list_launches": nearest_hit_fused.launches, "bounce_launches": bounce.launches,
        "plain_calls": nearest_hit_fused_plain.calls + bounce_plain.calls,
    }
    check(res["trace_list_launches"] > 0, "kernel 1 launched on the main path")
    check(res["bounce_launches"] > 0, "kernel 2 launched on the main path")
    check(res["plain_calls"] == 0, "no plain version called on the main path")
    img = img.cpu().numpy()
    check(img.shape == (RESOLUTION[1], RESOLUTION[0], 3), f"image shape {img.shape}")
    check(bool(np.isfinite(img).all()), "image is finite")
    res["mean"] = float(img.mean())
    check(0.01 < res["mean"] < 1.0, f"image mean {res['mean']} in (0.01, 1.0)")
    g = read_bmp(GOLDEN).astype(np.float32) / 255.0
    a, b = downsample(img, 8), downsample(g, 8)
    res["golden_mad"] = float(np.abs(a - b).mean())
    res["golden_corr"] = float(np.corrcoef(a.ravel(), b.ravel())[0, 1])
    check(res["golden_mad"] < 0.08, f"mean|diff| vs golden {res['golden_mad']} < 0.08")
    check(res["golden_corr"] > 0.9, f"correlation vs golden {res['golden_corr']} > 0.9")
    return res


def phase(name: str, res) -> None:
    print(f"{name}: {json.dumps(res)}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from pathtracerap_tpu_torch import build_reference_scene
    from pathtracerap_tpu_torch.kernels import _build
    from pathtracerap_tpu_torch.ops.plucker import bake_world_triangles

    # the plain versions run on the card: full f32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    phase("environment", {
        "python": sys.version.split()[0], "torch": torch.__version__, "cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    })
    print(smi, flush=True)

    t0 = time.perf_counter()
    _build.library()
    build = {"seconds": time.perf_counter() - t0}
    build["ptxas"] = [
        ln.strip() for ln in _build.build_log().splitlines() if "registers" in ln or "Compiling entry" in ln
    ]
    phase("build", build)

    world = bake_world_triangles(build_reference_scene().to_device(dev))
    k1 = kernel1_vs_plain(world, dev)
    phase("kernel1_vs_plain", k1)
    k2 = kernel2_vs_plain(world, dev)
    phase("kernel2_vs_plain", k2)
    torch.cuda.reset_peak_memory_stats()
    mp = main_path(dev)
    mp["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    phase("main_path", mp)
    check("jax" not in sys.modules, "jax was never imported")

    kernels = [
        {
            "name": "trace_list", "route": "cuda",
            "source": "pathtracerap_tpu_torch/csrc/trace_list.cu",
            "replaces": "pathtracerap_tpu/pallas/trace.py:188",
            "launches": mp["trace_list_launches"], "max_abs_err": k1["max_abs_err"],
            "ms": k1["ms"], "plain_ms": k1["plain_ms"],
        },
        {
            "name": "bounce", "route": "cuda",
            "source": "pathtracerap_tpu_torch/csrc/bounce.cu",
            "replaces": "pathtracerap_tpu/pallas/megakernel.py:1666",
            "launches": mp["bounce_launches"], "max_abs_err": k2["max_abs_err"],
            "ms": k2["ms"], "plain_ms": k2["plain_ms"],
        },
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
