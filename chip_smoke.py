"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``pathtracerap_tpu_torch/csrc`` with
nvcc, holds each kernel against its plain PyTorch version at the shapes of
the main paths, then drives the port's paths through the entry points a
user calls, each with the kernels' launch counts set to 0 just before it
and read just after:

* the render of the reference scene at 1000x800, 24 spp, 5 bounces
  (``engine="fused"`` routed to the binned engine) through ``Renderer``,
  checked against the committed golden;
* the train step at 1000x800, 8 spp, 5 bounces on ``mat_color``
  (``make_train_step(..., engine="fused")``), timed, with the vertex_pos
  gradient in quality mode at the same size and a small step on the card
  held against the same step on CPU tensors;
* the whole-sample fused engine (kernel 4): the jittered quality render of
  the reference scene at 1000x800, 24 spp, 5 bounces; the Cornell box at
  256x256, 64 spp, 4 bounces (BASELINE config 1); the emit_idx train step
  on the Cornell box at 256x256, 8 spp, 4 bounces with its quality
  vertex_pos gradient; and small renders and steps on the card held
  against CPU tensors;
* large scenes: kernel 5 (the dense trace) against its plain version on
  a 2,163,864-triangle world, above the fused pack's budget, and on the
  reference scene baked without a pack; ``Renderer(engine="fused")`` on
  that world at 512x512, 2 spp, 6 bounces (routed to the per-bounce
  pallas engine) and ``make_train_step(engine="fused")`` at 256x256, 2 spp,
  4 bounces (the fallback to the pallas diff engine); the default train
  step (the pallas diff engine on kernel 1) on the Cornell box at 256x256,
  8 spp, 4 bounces; the suite's 701-block megascene through
  ``run_config``, with kernels 1 and 2 against their plain versions at
  701 blocks; and small per-bounce renders and a default step on the card
  held against CPU tensors;
* the parity DDA engine (kernel G1, ``csrc/grid_dda.cu``): G1 against its
  plain version on the 1000x800 primary and bounce-1 wavefronts (the
  bounce with its liveness mask), on rays that start inside the models'
  boxes with zero direction components, on wavefronts with no live ray
  and with one, and in its global-memory form on the highpoly blob, every
  field, stat, model and triangle bit-equal; a 200x160 parity render
  through G1 and through the plain version, bit-equal; the reference
  scene at 1000x800, 2 spp, 5 bounces through
  ``render_accumulate(engine="parity")`` against
  ``assets/golden/reference_scene_parity.bmp``, the fused golden and the
  f32 parity golden, and one ``Renderer(engine="parity")`` render; the
  parity train step (``make_train_step(engine="parity")``) at the same
  size, its quality-mode gradient and a small step against CPU tensors;
  ``render_aovs`` and ``write_aov_bmps`` at 1000x800; and the suite's
  ``gridparity`` row;
* kernels 1, 2 and 4 in their debug form (``PTAP_DEBUG=1``)
  against their fast form at the main paths' shapes and on degenerate
  rays; the profiling kernels P1 to P4 (``csrc/prof_parts.cu``,
  ``csrc/prof_argmin.cu``) against their plain versions at the scripts'
  sizes, P3 also at 131,072 x 512 beside the launch floor; a checkpointed render of the reference scene (binned) and of the
  Cornell box (fused) stopped after its first chunk and resumed, bit-equal
  to the unbroken chunked render; the main-path render with a
  ``MetricsLogger`` and under ``profile_trace``; and the four profiling
  scripts' ``main()`` (``pathtracerap_tpu_torch/scripts``) at full size.

Kernels 1 to 4 (``csrc/trace_list.cu``, ``csrc/bounce.cu``,
``csrc/bounce_trace.cu``, ``csrc/megakernel.cu``) must be bit for bit
their plain versions: kernel 1's t and index on every live ray at each of
its shapes (the parity primaries, the render's slab, the Cornell box's
primaries, the megascene's primaries from two cameras), kernel 2's state
on every ray and its index on every live ray, kernel 3's t and index on
every live ray, kernel 4's contribution and index stream, in every mode.
Kernel 5 without its gate must find the plain version's index on every
live ray; with it, the same but for phantom accepts from inside the room,
and misses on a wavefront with no live ray.  Their kernel lines give R
(rays per thread), the registers and spills (``ptxas -v``), for kernel 1
its chunk (worklist entries a thread block sweeps) and, beside the time
of a slab (its launch on the renders), the whole frame's, for kernel 3 the
SM clock nvidia-smi reads while it runs and the live pairs per SM clock
at it, for kernel 4 the pairs its compacted sweep issues beside the live
pairs of its bound, for kernel 5 its group width G, the box tests its
two-level gate made beside the per-cluster gate's and the time of a dead
wavefront; no kernel's time may read below its bound.  Kernel 1's phase
lines also give each shape's list lengths, live (ray, triangle) pairs,
the SM clock and the pairs per SM clock.  The parts kernel's lines (P1,
P2) give each configuration's share of its bound, its bits against the
plain version, registers, spills and shared memory, and the form of its
product: its tensor-core instructions counted in the SASS (``cuobjdump
-sass``: HGMMA for wgmma, HMMA for mma.sync); every bf16 configuration
must hold some, ``mm_f32`` none, and none may spill.  The profiling
scripts' phase gives each script's wall.

Kernel times are device times (``cuda_ms``): CUDA events around many
calls queued behind a spin on the stream, so that the host's enqueue
time, which dominated the short profiling kernels' per-call readings,
falls outside them; a kernel or library reading whose host fell behind
the spin raises, and each kernel reading also gives the host's µs a call.

Every check raises on failure, so the script exits non-zero before its
last line, which is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

The line before it lists each kernel's launches on its main path, error
against its plain version, time, plain time and bound.  It needs one CUDA
device and exits non-zero without a result when there is none.  It
imports no JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")  # checkpoints and traces (gitignored)
GOLDEN = os.path.join(ROOT, "assets", "golden", "reference_scene.bmp")
RESOLUTION = (1000, 800)
SPP = 24
MAX_BOUNCES = 5
SLAB = 16 * 8192  # rays of one binned slab (BINNED_SLAB_TILES RNG tiles)
SAMPLE_BATCH = 4
K1_IDX_SHARE, K1_T_REL = 0.9999, 1e-5
K1_CASES = ("parity_primaries", "render_slab", "cornell_primaries")
K2_HIT_SHARE, K2_STATE_ABS = 0.9999, 1e-4
TRAIN_SPP, TRAIN_STEPS = 8, 3  # bench.py:89-90
SMALL_RES, SMALL_SPP, SMALL_BOUNCES = (32, 16), 2, 4
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
F_MAX = 9999999.0
FUSED_SLAB = 64 * 8192  # rays of one fused slab (FUSED_SLAB_TILES RNG tiles)
K4_CLOSE_SHARE, K4_ABS, K4_IDX_SHARE = 0.999, 1e-4, 0.9999
CORNELL_RES, CORNELL_SPP, CORNELL_BOUNCES = (256, 256), 64, 4  # bench_suite.py:106-114
CORNELL_CAMERA = dict(position=(0.0, 0.0, 150.0), plane_x=(-40.0, 40.0), plane_y=(-40.0, 40.0),
                      plane_z=100.0)
CPU_MEAN_ABS, CPU_COMPONENT_ABS, CPU_COMPONENT_SHARE = 1e-4, 1e-5, 0.995
# the world above the fused pack's budget: build_highpoly_scene(subdiv=736,
# use_asset=False), rendered at the suite megascene's settings
BEYOND_SUBDIV, BEYOND_TRIANGLES = 736, 2_163_864
BEYOND_RES, BEYOND_SPP, BEYOND_BOUNCES = (512, 512), 2, 6  # bench_suite.py megascene
BEYOND_TRAIN_RES, BEYOND_TRAIN_SPP, BEYOND_TRAIN_BOUNCES = (256, 256), 2, 4
PLAIN_SLICE = 16384  # rays the plain versions trace where a full sweep would take minutes
K5_IDX_SHARE, K5_T_REL = 0.9999, 1e-5
# The suite's room camera (bench_suite._ROOM_CAMERA, z = 380) stands outside
# the 400-unit room, so its rays stop on the front wall and bounce out of
# the scene; this camera stands inside it, facing the sphere, so the
# kernels also meet the sphere's triangles.
INSIDE_CAMERA = dict(position=(0.0, 0.0, 190.0), plane_x=(-60.0, 60.0), plane_y=(-48.0, 48.0),
                     plane_z=120.0)
MEGASCENE_BLOCKS = 701
# bounds: NVIDIA H100 SXM data sheet (dense FP32 peak, dense BF16 tensor-core
# peak, HBM3 bandwidth)
PEAK_F32_FLOPS, PEAK_BF16_FLOPS, PEAK_BYTES = 67e12, 989e12, 3.35e12
PAIR_FLOPS = 47  # per (ray, triangle): 22 FMAs, det, division, t/u/v, accept chain
GATE_FLOPS = 28  # per (live ray, box) test of kernel 5: 6 sub, 6 mul, 10 min/max, 6 for the tests
# the profiling kernels at the scripts' sizes (scripts/prof_kernel_parts.py:26-30)
PROF_N, PROF_R, PROF_TB, PROF_NB = 800256, 512, 512, 8
PROF_RTOL, PROF_CHAIN_SHARE = 1e-5, 0.999
COPY_ROUNDS = 3  # rounds of (kernel, library, library, kernel) device readings of the copy kernel
# per (ray, triangle) pair of P1's accept chain: det 2, reciprocal 1, t/u/v 3,
# u + v 1, the parallel test and 5 range tests 6, select 1, min 1
ACCEPT_FLOPS = 15
RESUME_SPP, RESUME_CHUNK = 8, 4
# the parity DDA engine (kernel G1): the golden's 2 spp x 5 bounces at
# 1000x800 (tests/test_reference_golden.py:119), drawn per 2048-ray RNG tile
# (scripts/make_golden_parity.py's default)
PARITY_GOLDEN = os.path.join(ROOT, "assets", "golden", "reference_scene_parity.bmp")
# the same render by the JAX package's parity engine on the CPU in f32
# (tests/make_parity_golden_f32.py): the port's f32 render lands on it
PARITY_F32_GOLDEN = os.path.join(ROOT, "assets", "golden", "reference_scene_parity_f32.bmp")
F32_GOLDEN_MAD, F32_GOLDEN_CORR = 0.005, 0.999
PARITY_SPP, PARITY_TILE = 2, 2048
PARITY_SMALL_RES = (200, 160)  # the render held bit for bit, G1 against the plain version
DDA_PLAIN_RAYS = 65536  # rays of a wavefront the plain version traces beside G1
# G1's global-memory form: the 146,688-triangle blob alone under 25^3 voxels
# (up to 2,613 triangles a voxel, which the plain version gathers for every ray)
HIGHPOLY_MESH = os.path.join(ROOT, "assets", "meshes", "highpoly_blob.obj")
HIGHPOLY_RAYS = 2048
# per triangle test (Moeller-Trumbore): 6 edge subtractions, two crosses 12,
# four dots 12, 3 tvec, the division 1, three scalings 3, the accept chain
# 8 (|det|, 5 compares, u + v, the and) and the argmin's compare 2
MT_FLOPS = 47
# per DDA step: the voxel index 5, the axis choice 3, the step and its
# bound 2, tmax + delta 1, the early exit 9, the exits 4
DDA_STEP_FLOPS = 24
P3_SHAPES = ((512, 512), (131072, 512))
PROFILE_SPP = 4  # the profiled render: the main path's, at fewer samples


# the device timer (cuda_ms): torch.cuda._sleep spins this many SM clocks a
# millisecond at 2 GHz, above the H100's 1980 MHz, so that a spin lasts at
# least as long as asked
SLEEP_CYCLES_PER_MS = 2.0e6
TIMER_PROBE_MS, TIMER_MAX_SPIN_MS, TIMER_TRIES = 20.0, 500.0, 4
TIMER_DEVICE_MS, TIMER_MAX_REPS = 25.0, 200


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, reps: int = 10, host: dict = None, lead: bool = True) -> float:
    """Device time of one call of ``fn`` in ms: CUDA events around ``n``
    calls queued behind a spin (``torch.cuda._sleep``) that lasts until
    the host has queued them all, so that no host time falls between the
    events; ``n`` is ``reps``, or more for a short call (at least
    TIMER_DEVICE_MS of device work, at most TIMER_MAX_REPS calls).  The
    spin is sized from one probe call.  Where the host was still queueing
    when it ran out (a slow host, or a launch queue that filled and held
    the host until the spin ended), the reading is taken again with a
    quarter of the calls behind a spin sized from that queueing time; with
    ``lead`` (kernels and library calls) a reading whose host never got
    ahead raises.  Without it (plain versions, some of which wait for the
    device) such a reading holds host time.  ``host``, a dict, receives
    the host's µs a call (``host_us``) and whether the queue stayed ahead
    of the device (``queue_ahead``)."""
    import torch

    def events():
        return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    fn()  # warm-up
    torch.cuda.synchronize()
    # one call's host time, and its device time, behind a spin
    torch.cuda._sleep(int(TIMER_PROBE_MS * SLEEP_CYCLES_PER_MS))
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    a, b = events()
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    n = max(reps, min(TIMER_MAX_REPS, math.ceil(TIMER_DEVICE_MS / max(a.elapsed_time(b), 1e-3))))
    for _ in range(TIMER_TRIES if lead else 1):
        spin_ms = min(TIMER_MAX_SPIN_MS, 2.0 * n * host_ms + 1.0)
        a, b = events()
        torch.cuda._sleep(int(spin_ms * SLEEP_CYCLES_PER_MS))
        t0 = time.perf_counter()
        a.record()
        for _ in range(n):
            fn()
        b.record()
        queued_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        ahead = queued_ms < spin_ms
        if ahead:
            break
        host_ms = queued_ms / n
        n = max(reps, n // 4)
    check(ahead or not lead,
          f"cuda_ms: the host queued {n} calls in {queued_ms:.1f} ms, behind a {spin_ms:.1f} ms spin")
    if host is not None:
        host["host_us"] = queued_ms / n * 1e3
        host["queue_ahead"] = ahead
    return a.elapsed_time(b) / n


def per_call_ms(fn, reps: int = 10) -> float:
    """The per-call reading: the median of ``reps`` CUDA-event timings of
    one call each, recorded around the call on an idle device, so that
    each holds the call's host enqueue time too (kept beside cuda_ms for
    the short profiling kernels, whose readings it dominated)."""
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


def card_while_running(fn, seconds: float = 2.0, per_sync: int = 1) -> dict:
    """``fn`` launched back to back for about ``seconds``, ``per_sync``
    calls between synchronisations, while nvidia-smi samples the card every
    200 ms: the steady launch time and the SM clock and power draw it ran
    at (the samples after the first two)."""
    import torch

    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
         "-lms", "200"], stdout=subprocess.PIPE, text=True)
    try:
        t0, k = time.perf_counter(), 0
        while time.perf_counter() - t0 < seconds:
            for _ in range(per_sync):
                fn()
            torch.cuda.synchronize()
            k += per_sync
        dt = time.perf_counter() - t0
    finally:
        smi.terminate()
    rows = [ln.split(",") for ln in smi.communicate()[0].strip().splitlines()[2:]]
    return {"ms_per_launch": dt / k * 1e3, "sm_clock_mhz": [float(r[0]) for r in rows],
            "power_w": [float(r[1]) for r in rows]}


def downsample(x, f: int):
    h, w, _ = x.shape
    return x[: h - h % f, : w - w % f].reshape(h // f, f, w // f, f, 3).mean(axis=(1, 3))


def bound(flops: float, n_bytes: float, bf16_flops: float = 0.0) -> dict:
    """The least time the card could take for the work: the larger of the
    operations (f32 ones over the f32 peak plus bf16 products over the
    tensor cores' bf16 peak) and the bytes over the memory rate."""
    t_ops = flops / PEAK_F32_FLOPS + bf16_flops / PEAK_BF16_FLOPS
    t_bytes = n_bytes / PEAK_BYTES
    out = {"bound_ms": max(t_ops, t_bytes) * 1e3,
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "flops": flops, "bytes": n_bytes}
    if bf16_flops:
        out["bf16_flops"] = bf16_flops
    return out


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def list_pairs(lists, live, ray_tile: int, unit: int, n_valid: int) -> int:
    """(ray, triangle) pairs a worklist kernel needs for these inputs: per
    tile, the real triangles of its listed units (the first ``n_valid``
    of the world; padding is never accepted) times its live rays."""
    ids = lists.long()
    tris = ((n_valid - ids * unit).clamp(0, unit) * (ids >= 0)).sum(dim=1)
    return int((live.reshape(-1, ray_tile).sum(dim=1) * tris).sum().item())


def kernel1_case(world, w16, lists, n: int, plain_rows=None) -> dict:
    """Kernel 1 against its plain version on one set of inputs, on its
    first ``n`` rays (the real ones; the plain version on the first
    ``plain_rows`` when given): t and index bit-equal on every live ray.
    With the list lengths, the live (ray, triangle) pairs, the time, the
    host's µs a call, the pairs per SM clock and the bound."""
    import torch

    from pathtracerap_tpu_torch.kernels.trace import (
        RAY_TILE, nearest_hit_fused, nearest_hit_fused_plain,
    )

    nb, tb = world.block_aabb.shape[0], world.tri_block
    m = min(n, plain_rows or n)

    def kern():
        return nearest_hit_fused(w16, world, lists, RAY_TILE)

    def plain():
        return nearest_hit_fused_plain(w16[:plain_rows], world.fused_ops, nb, tb)

    t_k, i_k = kern()
    t_p, i_p = plain()
    outs = (t_k, i_k)
    live = w16[:m, 10] > 0
    t_k, i_k, t_p, i_p = t_k[:m][live], i_k[:m][live], t_p[:m][live], i_p[:m][live]
    same = i_k == i_p
    both = same & (i_p >= 0)
    share = same.float().mean().item()
    d = (t_k - t_p).abs()[both]
    max_abs = d.max().item() if d.numel() else 0.0
    rel = (d / t_p[both].abs().clamp_min(1e-30)).max().item() if d.numel() else 0.0
    bits = same & (t_k.view(torch.int32) == t_p.view(torch.int32))
    lens = (lists >= 0).sum(dim=1).float()
    all_live = w16[:, 10] > 0
    res = {
        "rays": n, "live": int(all_live.sum().item()), "blocks": nb, "plain_rays": m,
        "list_len_mean": lens.mean().item(), "list_len_max": int(lens.max().item()),
        "hit_share": (i_p >= 0).float().mean().item(), "idx_equal_share": share,
        "bit_equal_share": bits.float().mean().item(), "max_rel_t": rel, "max_abs_err": max_abs,
    }
    check(share >= K1_IDX_SHARE, f"kernel 1 idx equal share {share} >= {K1_IDX_SHARE}")
    check(rel <= K1_T_REL, f"kernel 1 max rel t diff {rel} <= {K1_T_REL}")
    check(res["bit_equal_share"] == 1.0,
          f"kernel 1 t and index bit-equal on live rays: share {res['bit_equal_share']}")
    res["pairs"] = list_pairs(lists, all_live, RAY_TILE, tb, world.n_valid)
    res["ms"] = cuda_ms(kern, host=res)
    res["plain_ms"] = cuda_ms(plain, 10 if plain_rows is None else 3, lead=False)
    # the SM clock while the kernel runs (about 20 ms of launches between
    # synchronisations), and the live pairs per SM clock at the timed rate
    card = card_while_running(kern, per_sync=max(1, round(20.0 / res["ms"])))
    res["sm_clock_mhz"] = statistics.median(card["sm_clock_mhz"])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    res["pairs_per_sm_clock"] = res["pairs"] / (res["ms"] * 1e3 * sms * res["sm_clock_mhz"])
    res.update(bound(PAIR_FLOPS * res["pairs"], nbytes(w16, world.ops_tri, lists, *outs)))
    return res


def kernel1_inputs(world, dev, camera=None, resolution=RESOLUTION, rays=slice(None)):
    """The primaries kernel 1 traces (the slice ``rays`` of the camera's):
    (ray vectors, worklists, real rays)."""
    from pathtracerap_tpu_torch import CameraConfig
    from pathtracerap_tpu_torch.kernels.trace import primary_inputs
    from pathtracerap_tpu_torch.render.camera import generate_rays

    ro, rd = generate_rays(camera or CameraConfig(), resolution, device=dev)
    ro, rd = ro[rays], rd[rays]
    return (*primary_inputs(world, ro, rd), ro.shape[0])


def kernel1_vs_plain(world, dev):
    """Kernel 1 at the main paths' shapes: the parity render's 800,000
    primaries, its first slab (SLAB rays: the render launches kernel 1 once
    a slab) and the Cornell box's 65,536 primaries (one block: the Cornell
    render and default step); with its R, C, registers and spills."""
    from pathtracerap_tpu_torch import CameraConfig, build_cornell_box_scene
    from pathtracerap_tpu_torch.kernels.trace import TRACE_LIST_CHUNK, TRACE_LIST_RAYS
    from pathtracerap_tpu_torch.ops.plucker import bake_world_triangles

    res = {"parity_primaries": kernel1_case(world, *kernel1_inputs(world, dev)),
           "render_slab": kernel1_case(world, *kernel1_inputs(world, dev, rays=slice(SLAB)))}
    cornell = bake_world_triangles(build_cornell_box_scene().to_device(dev))
    res["cornell_primaries"] = kernel1_case(
        cornell, *kernel1_inputs(cornell, dev, CameraConfig(**CORNELL_CAMERA), CORNELL_RES))
    res.update(rays_per_thread=TRACE_LIST_RAYS, chunk=TRACE_LIST_CHUNK, **kernel_build("trace_list"))
    return res


def bounce1_wavefront(world, dev, camera=None, resolution=RESOLUTION, bounces=MAX_BOUNCES):
    """Bounce 1 of the first 4-sample group of the first slab, sorted, as
    both binned loops (render and diff forward) build it: (pack, uniforms,
    worklists, unit, ray_tile)."""
    import torch

    from pathtracerap_tpu_torch import CameraConfig
    from pathtracerap_tpu_torch.kernels.megakernel import (
        binned_ray_tile, bounce_lists, first_wavefront, scene_morton_bounds, sort_wavefront,
    )
    from pathtracerap_tpu_torch.kernels.trace import _slab_margin, trace_pallas
    from pathtracerap_tpu_torch.ops.math import normalize
    from pathtracerap_tpu_torch.ops.rng import prng_key
    from pathtracerap_tpu_torch.render.camera import generate_rays

    ro, rd = generate_rays(camera or CameraConfig(), resolution, device=dev)
    ro, rd = ro[:SLAB], normalize(rd[:SLAB])
    n = ro.shape[0]
    ray_tile = binned_ray_tile(world)
    check(n % ray_tile == 0, "slab fills whole ray tiles")
    hits0 = trace_pallas(world, ro, rd)
    pack, u_flat = first_wavefront(
        world, ro, rd, hits0, prng_key(0, dev), 0, SAMPLE_BATCH, n, bounces, True, 0
    )
    pix = torch.arange(pack.shape[0], device=dev)
    pack, pix = sort_wavefront(pack, pix, *scene_morton_bounds(world.block_aabb))
    lists, unit = bounce_lists(world, _slab_margin(world.block_aabb), pack, ray_tile)
    return pack, u_flat[:, 4:8][pix], lists, unit, ray_tile


def kernel_build(kernel: str) -> dict:
    """Registers, spills and shared memory of kernel 1 (``trace_list``),
    2 (``bounce``), 3 (``bounce_trace``), 4 (``sample_fused``) or 5
    (``nearest_hit``), the fast instantiation of those with a debug form,
    from the build log (``ptxas -v``)."""
    from pathtracerap_tpu_torch.kernels import _build

    mangled = {"trace_list": "_Z17trace_list_kernelILb0E", "bounce": "_Z13bounce_kernelILb0E",
               "bounce_trace": "_Z19bounce_trace_kernel", "sample_fused": "_Z19sample_fused_kernelILb0E",
               "nearest_hit": "_Z18nearest_hit_kernel"}[kernel]
    res = _build.kernel_resources()
    (key,) = [k for k in res if k.startswith(mangled)]
    return res[key]


def kernel2_vs_plain(world, dev, wavefront=None, plain_rows=None):
    """Kernel 2 against its plain version on bounce 1 of the first
    4-sample slab, the sorted wavefront ``render_samples_binned`` builds
    (the plain version on its first ``plain_rows`` rows when given):
    the index equal on every live ray and the state bit-equal on every
    ray."""
    import torch

    from pathtracerap_tpu_torch.kernels.megakernel import (
        BOUNCE_RAYS_PER_THREAD, bounce, bounce_plain,
    )

    pack, u_b, lists, unit, ray_tile = wavefront or bounce1_wavefront(world, dev)
    m = min(pack.shape[0], plain_rows or pack.shape[0])

    def kern():
        return bounce(pack, u_b, lists, unit, world, ray_tile, True)

    def plain():
        return bounce_plain(pack[:m], u_b[:m], world, True)

    out_k, i_k = kern()
    out_p, i_p = plain()
    full_k = (out_k, i_k)
    out_k, i_k, pack_m = out_k[:m], i_k[:m], pack[:m]
    live = pack_m[:, 9] > 0
    all_live = pack[:, 9] > 0
    agree = (i_k == i_p) & live
    share = (agree.sum() / live.sum().clamp_min(1)).item()
    d = (out_k - out_p).abs()[agree]
    max_abs = d.max().item() if d.numel() else 0.0
    res = {
        "rays": pack.shape[0], "plain_rays": m, "live": int(live.sum().item()),
        "ray_tile": ray_tile, "unit": unit, "worklist_width": lists.shape[1],
        "mean_list_len": (lists >= 0).sum(dim=1).float().mean().item(),
        "hit_agree_share": share, "max_abs_err": max_abs,
        "max_abs_err_per_col": [round(x, 9) for x in (d.amax(dim=0).tolist() if d.numel() else [])],
        "dead_pass_through": bool(torch.equal(full_k[0][~all_live], pack[~all_live])),
    }
    row_bits = (out_k.view(torch.int32) == out_p.view(torch.int32)).all(dim=1)
    res["bit_equal_share"] = row_bits.float().mean().item()
    res["bit_equal_share_where_idx_agrees"] = row_bits[agree].float().mean().item()
    check(share >= K2_HIT_SHARE, f"kernel 2 hit agree share {share} >= {K2_HIT_SHARE}")
    check(max_abs <= K2_STATE_ABS, f"kernel 2 max state diff {max_abs} <= {K2_STATE_ABS}")
    check(res["dead_pass_through"], "kernel 2 leaves dead rays unchanged")
    check(res["bit_equal_share_where_idx_agrees"] == 1.0,
          "kernel 2 state bit-equal wherever the index agrees")
    check(share == 1.0 and res["bit_equal_share"] == 1.0,
          f"kernel 2 bit-equal: live index share {share}, state {res['bit_equal_share']}")
    res["rays_per_thread"] = BOUNCE_RAYS_PER_THREAD
    res["ms"] = cuda_ms(kern, host=res)
    res["plain_ms"] = cuda_ms(plain, 10 if plain_rows is None else 3, lead=False)
    res.update(kernel_build("bounce"))
    res.update(bound(PAIR_FLOPS * list_pairs(lists, all_live, ray_tile, unit, world.n_valid),
                     nbytes(pack, u_b, lists, world.ops_tri, world.attr_rows, *full_k)))
    return res


def kernel3_vs_plain(world, dev):
    """Kernel 3 against its plain version on the wavefront the diff
    forward's first bounce traces (bounce 1 of the first 4-sample group of
    the first slab; the slab is a multiple of the diff forward's 512-ray
    padding, so the same rows): t and index bit-equal on every live ray, a
    miss on the rays of a tile with no live ray.  With R, registers, spills,
    the SM clock read while it runs and the live pairs per SM clock."""
    import torch

    from pathtracerap_tpu_torch.kernels.megakernel import (
        BOUNCE_TRACE_RAYS_PER_THREAD, bounce_trace, bounce_trace_plain,
    )

    pack, _, lists, unit, ray_tile = bounce1_wavefront(world, dev)

    def kern():
        return bounce_trace(pack, lists, unit, world, ray_tile)

    def plain():
        return bounce_trace_plain(pack, world, ray_tile)

    t_k, c_k = kern()
    t_p, c_p = plain()
    live = pack[:, 9] > 0
    agree = (c_k == c_p) & live
    share = (agree.sum() / live.sum().clamp_min(1)).item()
    both = agree & (c_p > 0)
    d = (t_k - t_p).abs()[both]
    max_abs = d.max().item() if d.numel() else 0.0
    dead_tile = ~live.reshape(-1, ray_tile).any(dim=1).repeat_interleave(ray_tile)
    res = {
        "rays": pack.shape[0], "live": int(live.sum().item()), "ray_tile": ray_tile, "unit": unit,
        "mean_list_len": (lists >= 0).sum(dim=1).float().mean().item(),
        "hit_share": (c_p[live] > 0).float().mean().item(), "idx_equal_share": share,
        "t_bit_equal_share": (t_k.view(torch.int32) == t_p.view(torch.int32))[live].float().mean().item(),
        "max_abs_err": max_abs,
        "dead_tiles_miss": bool((c_k[dead_tile] == 0).all() and (t_k[dead_tile] == F_MAX).all()),
    }
    check(share == 1.0 and res["t_bit_equal_share"] == 1.0,
          f"kernel 3 bit-equal on live rays: index share {share}, t {res['t_bit_equal_share']}")
    check(res["dead_tiles_miss"], "kernel 3 writes a miss for tiles with no live ray")
    res["rays_per_thread"] = BOUNCE_TRACE_RAYS_PER_THREAD
    res.update(kernel_build("bounce_trace"))
    res["pairs"] = list_pairs(lists, live, ray_tile, unit, world.n_valid)
    res["ms"] = cuda_ms(kern, host=res)
    res["plain_ms"] = cuda_ms(plain, lead=False)
    card = card_while_running(kern, per_sync=max(1, round(20.0 / res["ms"])))
    res["sm_clock_mhz"] = statistics.median(card["sm_clock_mhz"])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    res["pairs_per_sm_clock"] = res["pairs"] / (res["ms"] * 1e3 * sms * res["sm_clock_mhz"])
    res.update(bound(PAIR_FLOPS * res["pairs"], nbytes(pack, lists, world.ops_tri, t_k, c_k)))
    return res


def _kernel_fns():
    from pathtracerap_tpu_torch.kernels import megakernel as MK
    from pathtracerap_tpu_torch.kernels import prof as KP
    from pathtracerap_tpu_torch.kernels import trace as TT

    from pathtracerap_tpu_torch.kernels import dda as DD
    from pathtracerap_tpu_torch.ops.intersect import trace_parity

    wrappers = {"trace_list": TT.nearest_hit_fused, "bounce": MK.bounce,
                "bounce_trace": MK.bounce_trace, "sample_fused": MK.sample_fused,
                "nearest_hit": TT.nearest_hit, "prof_parts": KP.parts,
                "prof_empty": KP.empty, "prof_argmin": KP.argmin_int, "grid_dda": DD.grid_trace}
    plains = (TT.nearest_hit_fused_plain, MK.bounce_plain, MK.bounce_trace_plain,
              MK.sample_fused_plain, TT.nearest_hit_plain, KP.parts_plain, KP.empty_plain,
              KP.argmin_int_plain, trace_parity)
    return wrappers, plains


def _zero_counts():
    wrappers, plains = _kernel_fns()
    for f in wrappers.values():
        f.launches = 0
        if hasattr(f, "variant_launches"):
            f.variant_launches.clear()
    for f in plains:
        f.calls = 0


def _counts() -> dict:
    wrappers, plains = _kernel_fns()
    out = {f"{name}_launches": f.launches for name, f in wrappers.items()}
    out["plain_calls"] = sum(f.calls for f in plains)
    return out


def main_path(dev):
    """The port's main path: Renderer(engine="fused") on the reference
    scene, with the kernels' launch counts taken over one render."""
    import numpy as np
    import torch

    from pathtracerap_tpu_torch import RenderConfig, Renderer, build_reference_scene, read_bmp

    cfg = RenderConfig(
        resolution=RESOLUTION, samples_per_pixel=SPP, max_bounces=MAX_BOUNCES, engine="fused"
    )
    r = Renderer(build_reference_scene().to_device(dev), cfg, device=dev)
    check(r.engine == "binned", f"engine routed to {r.engine!r}, expected 'binned'")
    r.render()  # warm-up
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    img = r.render()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    res = {
        "engine": r.engine, "render_s": dt,
        "mrays_per_s": RESOLUTION[0] * RESOLUTION[1] * SPP * MAX_BOUNCES / dt / 1e6,
    }
    res.update(_counts())
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


def _grad_stats(g) -> dict:
    import torch

    return {
        "grad_finite": bool(torch.isfinite(g).all().item()),
        "grad_nonzero": int((g != 0).sum().item()), "grad_abs_max": g.abs().max().item(),
    }


def train_step(dev):
    """bench.py:84-102 on the port: one SGD step of the mat_color image
    loss at 1000x800, 8 spp, 5 bounces, engine="fused", zero target,
    prng_key(0).  One warm-up step, then TRAIN_STEPS timed ones; the
    kernels' counts are taken over each timed step.  The index-stream
    forward (make_idxs_multi) is timed inside the step with CUDA events;
    the rest of the step is the replay and the backward."""
    import torch

    from pathtracerap_tpu_torch import CameraConfig, build_reference_scene
    from pathtracerap_tpu_torch.diff import extract_params, fast, make_train_step
    from pathtracerap_tpu_torch.ops.rng import prng_key

    scene = build_reference_scene().to_device(dev)
    n = RESOLUTION[0] * RESOLUTION[1]
    lr = 0.05
    step = make_train_step(
        scene, CameraConfig(), RESOLUTION, TRAIN_SPP, MAX_BOUNCES, lr=lr, tile_size=8192,
        engine="fused",
    )
    params = extract_params(scene, ("mat_color",))
    target = torch.zeros((n, 3), device=dev)
    key = prng_key(0, dev)
    t0 = time.perf_counter()
    step(params, target, key)  # warm-up
    torch.cuda.synchronize()
    res = {"warmup_step_s": time.perf_counter() - t0}

    inner, spans = fast.make_idxs_multi, []

    def timed(*args, **kwargs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = inner(*args, **kwargs)
        b.record()
        spans.append((a, b))
        return out

    walls, fwd, counts, peak = [], [], [], 0
    fast.make_idxs_multi = timed
    try:
        for _ in range(TRAIN_STEPS):
            spans.clear()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            _zero_counts()
            t0 = time.perf_counter()
            loss, new = step(params, target, key)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            counts.append(_counts())
            fwd.append(sum(a.elapsed_time(b) for a, b in spans) / 1e3)
            peak = max(peak, torch.cuda.max_memory_allocated())
    finally:
        fast.make_idxs_multi = inner
    best = min(walls)
    res.update(counts[0])
    res.update({
        "resolution": RESOLUTION, "spp": TRAIN_SPP, "bounces": MAX_BOUNCES, "step_s": walls,
        "fwd_bwd_mrays_per_s": n * TRAIN_SPP * MAX_BOUNCES / best / 1e6,
        "index_forward_s": fwd, "replay_backward_s": [w - f for w, f in zip(walls, fwd)],
        "loss": loss.item(), "peak_mem_gb": peak / 1e9,
        "counts_equal_over_steps": all(c == counts[0] for c in counts),
    })
    res.update(_grad_stats((params["mat_color"] - new["mat_color"]) / lr))
    check(res["trace_list_launches"] > 0, "kernel 1 launched in the train step")
    check(res["bounce_trace_launches"] > 0, "kernel 3 launched in the train step")
    check(res["plain_calls"] == 0, "no plain version called in the train step")
    check(math.isfinite(res["loss"]) and res["loss"] > 0, f"loss {res['loss']} finite and > 0")
    check(res["grad_finite"] and res["grad_nonzero"] > 0, "mat_color gradient finite and nonzero")
    return res


def train_step_quality_vertex(dev):
    """The vertex_pos gradient in quality mode (parity=False) at the train
    step's size: the path through the checkpointed full replay.  The
    vertex gradient of a mean loss over 2.4 million values is far below a
    float32 ulp of the vertices, so the phase reads the step's gradient
    (loss_and_grad, what make_train_step applies) instead of the update."""
    import torch

    from pathtracerap_tpu_torch import CameraConfig, build_reference_scene
    from pathtracerap_tpu_torch.diff import extract_params, loss_and_grad
    from pathtracerap_tpu_torch.ops.rng import prng_key

    scene = build_reference_scene().to_device(dev)
    n = RESOLUTION[0] * RESOLUTION[1]
    params = extract_params(scene, ("vertex_pos",))
    target = torch.zeros((n, 3), device=dev)

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = loss_and_grad(
            params, scene, target, prng_key(0, dev), CameraConfig(), RESOLUTION, TRAIN_SPP,
            MAX_BOUNCES, tile_size=8192, engine="fused", parity=False,
        )
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    first, _ = run()  # the first call in the process also loads kernels and grows the allocator
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    dt, (loss, grads) = run()
    res = {"resolution": RESOLUTION, "spp": TRAIN_SPP, "bounces": MAX_BOUNCES, "parity": False,
           "first_step_s": first, "step_s": dt,
           "fwd_bwd_mrays_per_s": n * TRAIN_SPP * MAX_BOUNCES / dt / 1e6,
           "loss": loss.item(), "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    res.update(_counts())
    res.update(_grad_stats(grads["vertex_pos"]))
    check(res["bounce_trace_launches"] > 0 and res["plain_calls"] == 0, "kernels on the quality path")
    check(math.isfinite(res["loss"]) and res["loss"] > 0, f"loss {res['loss']} finite and > 0")
    check(res["grad_finite"] and res["grad_nonzero"] > 0, "vertex_pos gradient finite and nonzero")
    return res


def train_step_vs_cpu(dev):
    """A small step on the card (kernels) against the same step on CPU
    tensors (the plain versions): loss and mat_color gradient."""
    import torch

    from pathtracerap_tpu_torch import CameraConfig, build_reference_scene
    from pathtracerap_tpu_torch.diff import extract_params, loss_and_grad, make_train_step
    from pathtracerap_tpu_torch.ops.rng import prng_key

    res_xy, n = SMALL_RES, SMALL_RES[0] * SMALL_RES[1]

    def loss_grad(d):
        scene = build_reference_scene().to_device(d)
        target = torch.full((n, 3), 0.25, device=d)
        loss, grads = loss_and_grad(
            extract_params(scene), scene, target, prng_key(1, d), CameraConfig(), res_xy,
            SMALL_SPP, SMALL_BOUNCES, tile_size=8192, engine="fused",
        )
        return scene, target, loss, grads["mat_color"]

    scene, target, l_g, g_g = loss_grad(dev)
    step = make_train_step(scene, CameraConfig(), res_xy, SMALL_SPP, SMALL_BOUNCES,
                           tile_size=8192, engine="fused")
    _zero_counts()
    s_loss, new = step(extract_params(scene), target, prng_key(1, dev))
    counts = _counts()
    check(torch.equal(s_loss, l_g), "the step's loss is its loss_and_grad's")
    check(torch.equal(new["mat_color"], scene.mat_color - 0.05 * g_g), "the step applies p - lr * g")
    _, _, l_c, g_c = loss_grad(torch.device("cpu"))
    g_g = g_g.cpu()
    res = {"resolution": res_xy, "spp": SMALL_SPP, "bounces": SMALL_BOUNCES,
           "loss_gpu": l_g.item(), "loss_cpu": l_c.item(),
           "loss_rel": abs(l_g.item() - l_c.item()) / abs(l_c.item()),
           "grad_max_abs": (g_g - g_c).abs().max().item(), "grad_abs_max": g_c.abs().max().item()}
    res.update(counts)
    check(counts["bounce_trace_launches"] > 0 and counts["plain_calls"] == 0, "kernels on the card")
    check(res["loss_rel"] <= LOSS_RTOL, f"card loss vs CPU rel {res['loss_rel']} <= {LOSS_RTOL}")
    check(bool(torch.allclose(g_g, g_c, rtol=GRAD_RTOL, atol=1e-7)),
          f"card gradient vs CPU within rtol {GRAD_RTOL}")
    return res


def _fused_compare(world, w16, prim, u, bounces, parity, use_primary, emit_idx=False):
    """Kernel 4 against its plain version on one set of inputs: the share
    of rays with every contribution within K4_ABS, the bit-equal share
    (checked to be 1, and the index stream equal), the largest error, the
    time, live rays per bounce, the (ray, triangle) pairs the kernel's
    sweeping warps issued and those of live rays, as its counter reports
    them from one more launch (the live pairs checked against the plain
    version's live rays), and the bound."""
    import torch

    from pathtracerap_tpu_torch.kernels.megakernel import (
        FUSED_TILE, GATE_BLOCKS, sample_fused, sample_fused_plain, sweep_operands,
    )

    def kern(pairs=None):
        return sample_fused(w16, prim, u, world, bounces, parity, use_primary, emit_idx,
                            pairs=pairs)

    def plain(live=None):
        return sample_fused_plain(w16, prim, u, world, bounces, parity, use_primary, emit_idx, live)

    out_k, live = kern(), []
    out_p = plain(live)
    torch.cuda.synchronize()
    if emit_idx:
        (out_k, idx_k), (out_p, idx_p) = out_k, out_p
    n = w16.shape[0]
    d = (out_k - out_p).abs()
    close = (d <= K4_ABS).all(dim=1).float().mean().item()
    ns = u.shape[0] if u.dim() == 3 else 1
    masks = torch.stack(live).reshape(ns, bounces, n)
    live = masks.sum(dim=2).sum(dim=0).tolist()
    traced_masks = masks[:, 1:] if use_primary else masks  # the bounces the kernel sweeps
    traced = int(traced_masks.sum().item())
    _, n_tris = sweep_operands(world)
    n_tris = min(n_tris, world.block_aabb.shape[0] * world.tri_block)
    res = {
        "rays": n, "samples": ns, "bounces": bounces, "parity": parity,
        "use_primary": use_primary, "emit_idx": emit_idx, "live_per_bounce": live,
        "close_share": close, "max_abs_err": d.max().item(),
        "bit_equal_share": (out_k.view(torch.int32) == out_p.view(torch.int32)).all(dim=1)
        .float().mean().item(),
        "finite": bool(torch.isfinite(out_k).all().item()),
    }
    check(res["finite"], "kernel 4 output finite")
    check(close >= K4_CLOSE_SHARE, f"kernel 4 close share {close} >= {K4_CLOSE_SHARE}")
    check(res["bit_equal_share"] == 1.0, f"kernel 4 bit-equal share {res['bit_equal_share']} == 1")
    outs = [out_k] + ([idx_k] if emit_idx else [])
    if emit_idx:
        hit = (idx_k != 0) | (idx_p != 0)
        share = (((idx_k == idx_p) & hit).sum() / hit.sum().clamp_min(1)).item()
        res["idx_equal_share"] = share
        check(share >= K4_IDX_SHARE, f"kernel 4 idx equal share {share} >= {K4_IDX_SHARE}")
        check(bool(torch.equal(idx_k, idx_p)), "kernel 4 index stream equal")
    res["rays_per_thread"] = 1  # kernel 4 sweeps one ray a thread
    res["ms"] = cuda_ms(kern, host=res)
    res["plain_ms"] = cuda_ms(plain, lead=False)
    res.update(kernel_build("sample_fused"))
    res["sweep_triangles"] = n_tris
    pairs = torch.zeros((n // FUSED_TILE, 2), dtype=torch.int64, device=w16.device)
    counted = kern(pairs)
    counted = counted[0] if emit_idx else counted
    check(bool(torch.equal(counted.view(torch.int32), out_k.view(torch.int32))),
          "kernel 4 gives the same contribution with its pair counter")
    res["pairs_swept"], res["pairs_live"] = (int(x) for x in pairs.sum(dim=0).tolist())
    if world.block_aabb.shape[0] <= GATE_BLOCKS:  # ungated: every real triangle per live ray
        check(res["pairs_live"] == traced * n_tris,
              f"kernel 4 swept {res['pairs_live']} live pairs, {traced} live rays x {n_tris}")
    # the sweep visits every real triangle for every live traced ray-bounce
    res.update(bound(PAIR_FLOPS * traced * n_tris,
                     nbytes(w16, prim, u, world.ops_tri, world.attr_rows, *outs)))
    return res


def quality_slab(dev):
    """The first slab of the quality render's first sample, as kernel 4
    takes it: jittered ray vectors (FUSED_SLAB rays), empty primary rows
    and the 5-bounce uniforms."""
    import torch

    from pathtracerap_tpu_torch import CameraConfig
    from pathtracerap_tpu_torch.kernels.trace import ray_vectors
    from pathtracerap_tpu_torch.ops.math import normalize
    from pathtracerap_tpu_torch.ops.rng import chunk_jitter_uniforms, chunk_uniforms, prng_key
    from pathtracerap_tpu_torch.render.camera import generate_rays, jitter_step

    key = prng_key(0, dev)
    cam = CameraConfig(jitter=True)
    ro, rd = generate_rays(cam, RESOLUTION, device=dev)
    ro, rd = ro[:FUSED_SLAB], rd[:FUSED_SLAB]
    n = ro.shape[0]
    step = jitter_step(cam, RESOLUTION)
    ju = chunk_jitter_uniforms(key, 0, n, n)
    rd_s = rd + torch.cat([ju[:, 0:1] * step[0], ju[:, 1:2] * step[1], torch.zeros_like(ju[:, :1])],
                          dim=1)
    w16 = ray_vectors(ro, normalize(rd_s))
    return w16, torch.zeros((n, 16), device=dev), chunk_uniforms(key, 0, MAX_BOUNCES, n, n)


def kernel4_vs_plain(ref_world, dev):
    """Kernel 4 at full size in three modes: the quality render's first
    slab (one jittered sample traced in the kernel, 5 bounces), the
    Cornell render's first batch (8 samples from the primary rows, 4
    bounces) and the Cornell step's emit_idx pass (one sample)."""
    import torch

    from pathtracerap_tpu_torch import CameraConfig, build_cornell_box_scene
    from pathtracerap_tpu_torch.kernels.megakernel import primary_pack, sample_fused
    from pathtracerap_tpu_torch.kernels.trace import ray_vectors, trace_pallas
    from pathtracerap_tpu_torch.ops.math import normalize
    from pathtracerap_tpu_torch.ops.plucker import bake_world_triangles
    from pathtracerap_tpu_torch.ops.rng import chunk_uniforms, prng_key
    from pathtracerap_tpu_torch.render.camera import generate_rays

    key = prng_key(0, dev)
    slab = quality_slab(dev)
    res = {"traced_jittered": _fused_compare(ref_world, *slab, MAX_BOUNCES, False, False)}
    res["traced_jittered"]["card_while_running"] = card_while_running(
        lambda: sample_fused(*slab, ref_world, MAX_BOUNCES, False, False))

    world = bake_world_triangles(build_cornell_box_scene().to_device(dev))
    ro, rd = generate_rays(CameraConfig(**CORNELL_CAMERA), CORNELL_RES, device=dev)
    n = ro.shape[0]
    rd_n = normalize(rd)
    hits, idx = trace_pallas(world, ro, rd_n, return_idx=True)
    w16 = ray_vectors(ro, rd_n)
    u = chunk_uniforms(key, range(8), CORNELL_BOUNCES, n, n).reshape(8, n, 4 * CORNELL_BOUNCES)
    res["primary_batched"] = _fused_compare(world, w16, primary_pack(hits), u, CORNELL_BOUNCES,
                                            True, True)
    prim = primary_pack(hits, torch.where(hits.t < F_MAX, idx + 1, 0))
    res["emit_idx"] = _fused_compare(world, w16, prim, u[0], CORNELL_BOUNCES, True, True,
                                     emit_idx=True)
    return res


def quality_render(dev):
    """The jittered quality render of the reference scene through the
    port's Renderer: 1000x800, 24 spp, 5 bounces, engine="fused",
    parity=False, CameraConfig(jitter=True)."""
    import numpy as np
    import torch

    from pathtracerap_tpu_torch import CameraConfig, RenderConfig, Renderer, build_reference_scene, read_bmp

    cfg = RenderConfig(resolution=RESOLUTION, samples_per_pixel=SPP, max_bounces=MAX_BOUNCES,
                       engine="fused", parity=False, camera=CameraConfig(jitter=True))
    r = Renderer(build_reference_scene().to_device(dev), cfg, device=dev)
    check(r.engine == "fused", f"quality render routed to {r.engine!r}, expected 'fused'")
    r.render()  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    img = r.render()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    res = {"engine": r.engine, "render_s": dt,
           "mrays_per_s": RESOLUTION[0] * RESOLUTION[1] * SPP * MAX_BOUNCES / dt / 1e6,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    res.update(_counts())
    check(res["sample_fused_launches"] > 0, "kernel 4 launched on the quality render")
    check(res["trace_list_launches"] == 0, "no primary trace on the jittered render")
    check(res["plain_calls"] == 0, "no plain version called on the quality render")
    img = img.cpu().numpy()
    check(bool(np.isfinite(img).all()), "quality image is finite")
    res["mean"] = float(img.mean())
    check(0.01 < res["mean"] < 1.0, f"quality image mean {res['mean']} in (0.01, 1.0)")
    g = read_bmp(GOLDEN).astype(np.float32) / 255.0
    a, b = downsample(img, 8), downsample(g, 8)
    res["golden_mad"] = float(np.abs(a - b).mean())  # no bound: quality mode changes the image
    res["golden_corr"] = float(np.corrcoef(a.ravel(), b.ravel())[0, 1])
    return res


def cornell_render(dev):
    """BASELINE config 1 through the port's Renderer: the Cornell box at
    256x256, 64 spp, 4 bounces, engine="fused" (one block: stays fused)."""
    import numpy as np
    import torch

    from pathtracerap_tpu_torch import CameraConfig, RenderConfig, Renderer, build_cornell_box_scene

    cfg = RenderConfig(resolution=CORNELL_RES, samples_per_pixel=CORNELL_SPP,
                       max_bounces=CORNELL_BOUNCES, engine="fused",
                       camera=CameraConfig(**CORNELL_CAMERA))
    r = Renderer(build_cornell_box_scene().to_device(dev), cfg, device=dev)
    check(r.engine == "fused", f"Cornell render routed to {r.engine!r}, expected 'fused'")
    r.render()  # warm-up
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    img = r.render()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    res = {"engine": r.engine, "render_s": dt,
           "mrays_per_s": CORNELL_RES[0] * CORNELL_RES[1] * CORNELL_SPP * CORNELL_BOUNCES / dt / 1e6}
    res.update(_counts())
    check(res["trace_list_launches"] == 1, "kernel 1 traced the primaries once")
    check(res["sample_fused_launches"] == CORNELL_SPP // 8, "kernel 4 once per 8-sample batch")
    check(res["plain_calls"] == 0, "no plain version called on the Cornell render")
    img = img.cpu().numpy()
    res["mean"] = float(img.mean())
    check(bool(np.isfinite(img).all()) and 0.01 < res["mean"] < 1.0, "Cornell image finite, mean in (0.01, 1)")
    return res


def cornell_train_step(dev):
    """The emit_idx train step: make_train_step on the Cornell box at
    256x256, 8 spp, 4 bounces, mat_color, engine="fused"; then the quality
    vertex_pos gradient at the same size (the checkpointed replay)."""
    import torch

    from pathtracerap_tpu_torch import CameraConfig, build_cornell_box_scene
    from pathtracerap_tpu_torch.diff import extract_params, loss_and_grad, make_train_step
    from pathtracerap_tpu_torch.ops.rng import prng_key

    scene = build_cornell_box_scene().to_device(dev)
    cam = CameraConfig(**CORNELL_CAMERA)
    n = CORNELL_RES[0] * CORNELL_RES[1]
    lr = 0.05
    target = torch.zeros((n, 3), device=dev)
    key = prng_key(0, dev)
    step = make_train_step(scene, cam, CORNELL_RES, TRAIN_SPP, CORNELL_BOUNCES, lr=lr,
                           engine="fused")
    params = extract_params(scene, ("mat_color",))
    step(params, target, key)  # warm-up
    walls = []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        t0 = time.perf_counter()
        loss, new = step(params, target, key)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    res = {"resolution": CORNELL_RES, "spp": TRAIN_SPP, "bounces": CORNELL_BOUNCES,
           "step_s": walls, "fwd_bwd_mrays_per_s": n * TRAIN_SPP * CORNELL_BOUNCES / min(walls) / 1e6,
           "loss": loss.item(), "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    res.update(_counts())
    res.update(_grad_stats((params["mat_color"] - new["mat_color"]) / lr))
    check(res["sample_fused_launches"] == TRAIN_SPP, "kernel 4 once per sample in the step")
    check(res["bounce_trace_launches"] == 0, "no binned forward on a single-block scene")
    check(res["plain_calls"] == 0, "no plain version called in the Cornell step")
    check(math.isfinite(res["loss"]) and res["loss"] > 0, f"loss {res['loss']} finite and > 0")
    check(res["grad_finite"] and res["grad_nonzero"] > 0, "mat_color gradient finite and nonzero")

    vparams = extract_params(scene, ("vertex_pos",))
    loss_and_grad(vparams, scene, target, key, cam, CORNELL_RES, TRAIN_SPP, CORNELL_BOUNCES,
                  engine="fused", parity=False)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    vloss, grads = loss_and_grad(vparams, scene, target, key, cam, CORNELL_RES, TRAIN_SPP,
                                 CORNELL_BOUNCES, engine="fused", parity=False)
    torch.cuda.synchronize()
    q = {"step_s": time.perf_counter() - t0, "loss": vloss.item(),
         "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    q.update(_counts())
    q.update(_grad_stats(grads["vertex_pos"]))
    check(q["sample_fused_launches"] > 0 and q["plain_calls"] == 0, "kernel 4 on the quality step")
    check(math.isfinite(q["loss"]) and q["loss"] > 0, f"quality loss {q['loss']} finite and > 0")
    check(q["grad_finite"] and q["grad_nonzero"] > 0, "vertex_pos gradient finite and nonzero")
    res["quality_vertex_pos"] = q
    return res


def fused_vs_cpu(dev):
    """Kernel 4's paths on the card against the same on CPU tensors (the
    plain versions): a 32x16 jittered quality render of the reference
    scene, and a 32x16 Cornell step (loss and mat_color gradient)."""
    import torch

    from pathtracerap_tpu_torch import (
        CameraConfig, RenderConfig, Renderer, build_cornell_box_scene, build_reference_scene,
    )
    from pathtracerap_tpu_torch.diff import extract_params, loss_and_grad
    from pathtracerap_tpu_torch.ops.rng import prng_key

    cfg = RenderConfig(resolution=SMALL_RES, samples_per_pixel=SMALL_SPP, max_bounces=MAX_BOUNCES,
                       engine="fused", parity=False, camera=CameraConfig(jitter=True))
    imgs = {}
    for d in (dev, torch.device("cpu")):
        _zero_counts()
        imgs[d.type] = Renderer(build_reference_scene().to_device(d), cfg, device=d).render(seed=3)
        if d.type == "cuda":
            counts = _counts()
    d = (imgs["cuda"].cpu() - imgs["cpu"]).abs()
    res = {"render": {"resolution": SMALL_RES, "spp": SMALL_SPP, "bounces": MAX_BOUNCES,
                      "mean_abs": d.mean().item(), "max_abs": d.max().item(),
                      "share_within": (d <= CPU_COMPONENT_ABS).float().mean().item(), **counts}}
    check(counts["sample_fused_launches"] > 0 and counts["plain_calls"] == 0, "kernel 4 on the card")
    check(res["render"]["mean_abs"] <= CPU_MEAN_ABS, f"card vs CPU mean|diff| <= {CPU_MEAN_ABS}")
    check(res["render"]["share_within"] >= CPU_COMPONENT_SHARE,
          f"card vs CPU: {CPU_COMPONENT_SHARE} of components within {CPU_COMPONENT_ABS}")

    cam = CameraConfig(**CORNELL_CAMERA)
    out = {}
    for d in (dev, torch.device("cpu")):
        scene = build_cornell_box_scene().to_device(d)
        target = torch.full((SMALL_RES[0] * SMALL_RES[1], 3), 0.25, device=d)
        _zero_counts()
        out[d.type] = loss_and_grad(extract_params(scene), scene, target, prng_key(1, d), cam,
                                    SMALL_RES, SMALL_SPP, SMALL_BOUNCES, engine="fused")
        if d.type == "cuda":
            counts = _counts()
    (l_g, g_g), (l_c, g_c) = out["cuda"], out["cpu"]
    g_g, g_c = g_g["mat_color"].cpu(), g_c["mat_color"]
    res["cornell_step"] = {"loss_gpu": l_g.item(), "loss_cpu": l_c.item(),
                           "loss_rel": abs(l_g.item() - l_c.item()) / abs(l_c.item()),
                           "grad_max_abs": (g_g - g_c).abs().max().item(),
                           "grad_abs_max": g_c.abs().max().item(), **counts}
    check(counts["sample_fused_launches"] > 0 and counts["plain_calls"] == 0, "kernel 4 on the card")
    check(res["cornell_step"]["loss_rel"] <= LOSS_RTOL, f"Cornell loss vs CPU within {LOSS_RTOL}")
    check(bool(torch.allclose(g_g, g_c, rtol=GRAD_RTOL, atol=1e-7)),
          f"Cornell gradient vs CPU within rtol {GRAD_RTOL}")
    return res


def _phantoms(world, w, wo, idx):
    """Whether each ray's slab test fails to reach the cluster box of
    triangle ``idx``: an accept the cluster gate may skip.  A sliver
    triangle far from the origin can pass the accept chain for a ray that
    does not come near it (its Pluecker moments cancel in f32), and only an
    unculled sweep finds such a phantom."""
    import torch

    from pathtracerap_tpu_torch.kernels.trace import DENSE_RUN, _cluster_margin, slab_reaches

    box = world.cluster_aabb[:6, idx.long() // DENSE_RUN]  # (6, R)
    far = torch.full((idx.numel(),), float("inf"), device=w.device)
    reach = slab_reaches(box, wo[:, 0:3], w[:, 0:3], _cluster_margin(world.cluster_aabb), far)
    return ~reach.diagonal()


def _dense_compare(world, w, wo, plain_rows=None, phantoms_ok=False, live_rows=False):
    """Kernel 5 against its plain version on one wavefront (the plain
    version on its first ``plain_rows`` rays when given, or with
    ``live_rows`` its first ``plain_rows`` live ones): the unculled
    kernel's index equal on every live ray; the culled kernel's too, or
    with ``phantoms_ok`` different only on rays whose plain winner is a
    phantom (:func:`_phantoms`); relative t, the runs swept and the box
    tests made (group and cluster, each by every live ray of a tile)
    beside the per-cluster gate's (every live ray, every run), times and
    the bound (the swept pairs and the tests made)."""
    import torch

    from pathtracerap_tpu_torch.kernels.trace import (
        DENSE_RUN, DENSE_TILE, nearest_hit, nearest_hit_plain,
    )
    from pathtracerap_tpu_torch.ops.plucker import dense_runs

    n = w.shape[0]
    if live_rows:
        sel = torch.nonzero(wo[:, 4] > 0).flatten()[:plain_rows]
    else:
        sel = torch.arange(min(n, plain_rows or n), device=w.device)
    m = sel.numel()
    # the plain version's rays, padded with dead ones to whole tiles for the unculled kernel
    pad = (-m) % DENSE_TILE
    w_p = torch.cat([w[sel], w.new_zeros((pad, 8))])
    wo_p = torch.cat([wo[sel], wo.new_zeros((pad, 8))])
    nt = n // DENSE_TILE
    swept = torch.zeros(nt, dtype=torch.int32, device=w.device)
    tests = torch.zeros((nt, 2), dtype=torch.int32, device=w.device)
    ops = (world.edge_mat, world.plane_mat, world.cluster_aabb)

    def kern():
        return nearest_hit(w, wo, *ops, cull=True, n_valid=world.n_valid, swept=swept,
                           group_aabb=world.group_aabb, tests=tests)

    def plain():
        return nearest_hit_plain(w[sel], wo[sel], world.edge_mat, world.plane_mat, world.n_valid)

    t_k, i_k = kern()
    t_p, i_p = plain()
    t_n, i_n = nearest_hit(w_p, wo_p, *ops, cull=False, n_valid=world.n_valid,
                           group_aabb=world.group_aabb)
    t_n, i_n = t_n[:m], i_n[:m]
    torch.cuda.synchronize()
    live = wo[sel, 4] > 0
    n_lv = int(live.sum().item())  # a share over no live ray is 1

    def live_share(x):
        return (x & live).sum().item() / n_lv if n_lv else 1.0

    n_share = live_share(i_n == i_p)
    check(n_share == 1.0, f"unculled kernel 5 index equal on every live ray: share {n_share}")
    same = (i_k[sel] == i_p) & live
    share = live_share(same)
    differ = torch.nonzero(live & ~same).flatten()
    phantom = _phantoms(world, w[sel[differ]], wo[sel[differ]], i_p[differ])
    if phantoms_ok:
        check(bool(phantom.all()), "the culled kernel 5 differs only on phantom accepts")
    else:
        check(share >= K5_IDX_SHARE, f"kernel 5 idx equal share {share} >= {K5_IDX_SHARE}")
    both = same & (i_p >= 0)
    d = (t_k[sel] - t_p).abs()[both]
    max_abs = d.max().item() if d.numel() else 0.0
    rel = (d / t_p[both].abs().clamp_min(1e-30)).max().item() if d.numel() else 0.0
    check(rel <= K5_T_REL, f"kernel 5 max rel t diff {rel} <= {K5_T_REL}")
    live_all = wo[:, 4] > 0
    n_live = int(live_all.sum().item())
    runs = dense_runs(world.plane_mat.shape[1], world.n_valid)
    live_tile = live_all.reshape(-1, DENSE_TILE).sum(dim=1).long()
    swept_pairs = int((swept.long() * live_tile).sum().item()) * DENSE_RUN
    group_tests = int((tests[:, 0].long() * live_tile).sum().item())
    cluster_tests = int((tests[:, 1].long() * live_tile).sum().item())
    res = {
        "rays": n, "live": n_live, "live_tiles": int((live_tile > 0).sum().item()),
        "plain_rays": m, "triangles": world.n_valid, "runs": runs,
        "hit_share": live_share(i_p >= 0), "idx_equal_share": share,
        "unculled_idx_equal_share": n_share,
        "unculled_t_bit_equal_share": live_share(t_n.view(torch.int32) == t_p.view(torch.int32)),
        "differing_rays": differ.numel(), "phantom_rays": int(phantom.sum().item()),
        "t_bit_equal_share": live_share(t_k[sel].view(torch.int32) == t_p.view(torch.int32)),
        "max_rel_t": rel, "max_abs_err": max_abs,
        "mean_runs_swept": swept.float().mean().item(),
        "pairs_swept": swept_pairs, "dense_pairs": n_live * world.n_valid,
        "group_tests": group_tests, "cluster_tests": cluster_tests,
        "gate_tests": group_tests + cluster_tests, "gate_tests_flat": n_live * runs,
    }
    res["ms"] = cuda_ms(kern, host=res)
    res["plain_ms"] = cuda_ms(plain, 10 if plain_rows is None else 3, lead=False)
    # the swept pairs' accept chains and the live rays' slab tests the gate
    # made; the bytes: the rays, the results and counts, the group boxes,
    # and of the cluster boxes and runs the tiles read at least those of the
    # tile that tested and swept most (6 floats a box; 22 staged floats a
    # triangle, edge rows 0-5 and plane rows 0-3)
    res["clusters_read_at_least"] = int(tests[:, 1].max().item())
    res["runs_read_at_least"] = int(swept.max().item())
    read = (res["clusters_read_at_least"] * 6 + res["runs_read_at_least"] * DENSE_RUN * 22) * 4
    res.update(bound(PAIR_FLOPS * swept_pairs + GATE_FLOPS * res["gate_tests"],
                     nbytes(w, wo, world.group_aabb[:6], t_k, i_k, swept, tests) + read))
    return res


def _dense_dead(world, w, wo):
    """Kernel 5 on a wavefront with no live ray: (F_MAX, -1) on every ray,
    no run swept and no box tested, culled or not; its time (no plain
    version runs: a dead ray's result is unspecified)."""
    import torch

    from pathtracerap_tpu_torch.kernels.trace import DENSE_TILE, nearest_hit

    nt = w.shape[0] // DENSE_TILE
    res = {"rays": w.shape[0], "live": int((wo[:, 4] > 0).sum().item())}
    check(res["live"] == 0, "the dead wavefront has no live ray")
    for cull in (True, False):
        swept = torch.full((nt,), -1, dtype=torch.int32, device=w.device)
        tests = torch.full((nt, 2), -1, dtype=torch.int32, device=w.device)

        def kern():
            return nearest_hit(w, wo, world.edge_mat, world.plane_mat, world.cluster_aabb,
                               cull=cull, n_valid=world.n_valid, swept=swept,
                               group_aabb=world.group_aabb, tests=tests)

        t, idx = kern()
        torch.cuda.synchronize()
        check(bool((t == F_MAX).all() and (idx == -1).all()), "kernel 5 misses on a dead wavefront")
        check(bool((swept == 0).all() and (tests == 0).all()),
              "kernel 5 sweeps and tests nothing on a dead wavefront")
        res["ms" if cull else "unculled_ms"] = cuda_ms(kern)
    # the bytes it must move: the rays in, the result out
    res.update(bound(0.0, nbytes(w, wo, t, idx)))
    res["max_abs_err"] = 0.0
    return res


def kernel5_vs_plain(big_scene, dev):
    """Kernel 5 at full size on the 2,163,864-triangle world (no fused
    pack): the 512x512 primaries and the bounce-1 wavefront the per-bounce
    engine traces next (unsorted, dead rays in place) of the suite's room
    camera and of INSIDE_CAMERA, each held against the plain version on
    its first PLAIN_SLICE rays; the room camera's bounce-2 wavefront (few
    live rays), and the same rays with none live; and the reference scene
    baked without a pack at 1000x800 against a full plain sweep.  With R,
    G, registers and spills.  Returns (results, the big world)."""
    import torch

    from pathtracerap_tpu_torch import CameraConfig, build_reference_scene
    from pathtracerap_tpu_torch.bench_suite import _ROOM_CAMERA
    from pathtracerap_tpu_torch.kernels.trace import DENSE_RAYS, dense_inputs, trace_pallas
    from pathtracerap_tpu_torch.ops.plucker import CLUSTER_GROUP, bake_world_triangles
    from pathtracerap_tpu_torch.ops.rng import chunk_uniforms, prng_key
    from pathtracerap_tpu_torch.render.camera import generate_rays
    from pathtracerap_tpu_torch.render.shade import RayState, shade

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    world = bake_world_triangles(big_scene)
    torch.cuda.synchronize()
    res = {"bake_s": time.perf_counter() - t0, "triangles": world.n_valid,
           "padded": world.plane_mat.shape[1], "has_pack": world.fused_ops is not None,
           "rays_per_thread": DENSE_RAYS, "group": CLUSTER_GROUP,
           "groups": world.group_aabb.shape[1]}
    res.update(kernel_build("nearest_hit"))
    check(world.fused_ops is None and world.n_valid == BEYOND_TRIANGLES,
          f"the {BEYOND_TRIANGLES}-triangle world has no fused pack")
    for tag, cam in (("", _ROOM_CAMERA), ("inside_", CameraConfig(**INSIDE_CAMERA))):
        ro, rd = generate_rays(cam, BEYOND_RES, device=dev)
        n = ro.shape[0]
        # from inside the room the rays meet the sphere's pole slivers
        inside = bool(tag)
        res[tag + "primary"] = _dense_compare(world, *dense_inputs(ro, rd), plain_rows=PLAIN_SLICE,
                                              phantoms_ok=inside)
        hits = trace_pallas(world, ro, rd)
        u = chunk_uniforms(prng_key(0, dev), 0, BEYOND_BOUNCES, n, n)
        st = shade(RayState.primary(ro, rd, BEYOND_BOUNCES), hits, u[:, 0:4])
        res[tag + "bounce1"] = _dense_compare(
            world, *dense_inputs(st.orig, st.dir, st.remaining > 0), plain_rows=PLAIN_SLICE,
            phantoms_ok=inside,
        )
        if not inside:
            st = shade(st, trace_pallas(world, st.orig, st.dir, alive=st.remaining > 0), u[:, 4:8])
            alive = st.remaining > 0
            res["bounce2"] = _dense_compare(world, *dense_inputs(st.orig, st.dir, alive),
                                            plain_rows=PLAIN_SLICE, live_rows=True)
            res["dead"] = _dense_dead(world, *dense_inputs(st.orig, st.dir, torch.zeros_like(alive)))
    ref = bake_world_triangles(build_reference_scene().to_device(dev), fused_tile=None)
    ro, rd = generate_rays(CameraConfig(), RESOLUTION, device=dev)
    res["reference_primary"] = _dense_compare(ref, *dense_inputs(ro, rd))
    return res, world


def beyond_pack_render(big_scene, dev):
    """Renderer(engine="fused") on the 2,163,864-triangle world at the
    megascene's settings, 512x512 x 2 spp x 6 bounces: no fused pack, so
    the engine resolves to the per-bounce pallas engine on kernel 5."""
    import numpy as np
    import torch

    from pathtracerap_tpu_torch import CameraConfig, RenderConfig, Renderer
    from pathtracerap_tpu_torch.bench_suite import _ROOM_CAMERA

    cfg = RenderConfig(resolution=BEYOND_RES, samples_per_pixel=BEYOND_SPP,
                       max_bounces=BEYOND_BOUNCES, engine="fused", camera=_ROOM_CAMERA)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = Renderer(big_scene, cfg, device=dev)
    torch.cuda.synchronize()
    res = {"engine": r.engine, "bake_s": time.perf_counter() - t0}
    check(r.engine == "pallas", f"beyond-pack render routed to {r.engine!r}, expected 'pallas'")
    t0 = time.perf_counter()
    r.render()  # warm-up
    torch.cuda.synchronize()
    res["first_render_s"] = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    img = r.render()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    w, h = BEYOND_RES
    res.update({"resolution": BEYOND_RES, "spp": BEYOND_SPP, "bounces": BEYOND_BOUNCES,
                "render_s": dt, "mrays_per_s": w * h * BEYOND_SPP * BEYOND_BOUNCES / dt / 1e6,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    res.update(_counts())
    check(res["nearest_hit_launches"] > 0, "kernel 5 launched on the beyond-pack render")
    check(all(res[f"{k}_launches"] == 0 for k in ("trace_list", "bounce", "bounce_trace",
                                                   "sample_fused")),
          "kernels 1 to 4 not launched on the beyond-pack render")
    check(res["plain_calls"] == 0, "no plain version called on the beyond-pack render")
    img = img.cpu().numpy()
    check(img.shape == (h, w, 3) and bool(np.isfinite(img).all()), "beyond-pack image finite")
    res["mean"] = float(img.mean())
    check(0.01 < res["mean"] < 1.0, f"beyond-pack image mean {res['mean']} in (0.01, 1.0)")
    # the same render from inside the room, where the rays meet the sphere
    r = Renderer(big_scene, dataclasses.replace(cfg, camera=CameraConfig(**INSIDE_CAMERA)),
                 device=dev)
    _zero_counts()
    t0 = time.perf_counter()
    img = r.render()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    img = img.cpu().numpy()
    inside = {"render_s": dt, "mrays_per_s": w * h * BEYOND_SPP * BEYOND_BOUNCES / dt / 1e6,
              "mean": float(img.mean())}
    inside.update(_counts())
    check(inside["nearest_hit_launches"] > 0 and inside["plain_calls"] == 0,
          "kernel 5 on the inside render")
    check(bool(np.isfinite(img).all()) and 0.01 < inside["mean"] < 1.0,
          f"inside image finite, mean {inside['mean']} in (0.01, 1.0)")
    res["inside_camera"] = inside
    return res


def beyond_pack_train_step(big_scene, dev):
    """make_train_step(engine="fused") with mat_color on the same world at
    256x256 x 2 spp x 4 bounces: the fused engine falls back to the
    per-bounce pallas diff engine, on kernel 5."""
    import torch

    from pathtracerap_tpu_torch.bench_suite import _ROOM_CAMERA
    from pathtracerap_tpu_torch.diff import extract_params, make_train_step
    from pathtracerap_tpu_torch.ops.rng import prng_key

    res_xy = BEYOND_TRAIN_RES
    n = res_xy[0] * res_xy[1]
    lr = 0.05
    step = make_train_step(big_scene, _ROOM_CAMERA, res_xy, BEYOND_TRAIN_SPP, BEYOND_TRAIN_BOUNCES,
                           lr=lr, engine="fused")
    params = extract_params(big_scene, ("mat_color",))
    target = torch.zeros((n, 3), device=dev)
    key = prng_key(0, dev)
    t0 = time.perf_counter()
    step(params, target, key)  # warm-up
    torch.cuda.synchronize()
    res = {"warmup_step_s": time.perf_counter() - t0}
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    loss, new = step(params, target, key)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    res.update({"resolution": res_xy, "spp": BEYOND_TRAIN_SPP, "bounces": BEYOND_TRAIN_BOUNCES,
                "step_s": dt,
                "fwd_bwd_mrays_per_s": n * BEYOND_TRAIN_SPP * BEYOND_TRAIN_BOUNCES / dt / 1e6,
                "loss": loss.item(), "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    res.update(_counts())
    res.update(_grad_stats((params["mat_color"] - new["mat_color"]) / lr))
    check(res["nearest_hit_launches"] > 0, "kernel 5 launched in the beyond-pack step")
    check(all(res[f"{k}_launches"] == 0 for k in ("trace_list", "bounce", "bounce_trace",
                                                   "sample_fused")),
          "kernels 1 to 4 not launched in the beyond-pack step")
    check(res["plain_calls"] == 0, "no plain version called in the beyond-pack step")
    check(math.isfinite(res["loss"]) and res["loss"] > 0, f"loss {res['loss']} finite and > 0")
    check(res["grad_finite"] and res["grad_nonzero"] > 0, "mat_color gradient finite and nonzero")
    return res


def pallas_train_step(dev):
    """make_train_step with its defaults (the per-bounce pallas diff
    engine, 2048-ray RNG tiles, lr 0.05) on the Cornell box at 256x256 x 8
    spp x 4 bounces, mat_color: kernel 1 traces every bounce."""
    import torch

    from pathtracerap_tpu_torch import CameraConfig, build_cornell_box_scene
    from pathtracerap_tpu_torch.diff import extract_params, make_train_step
    from pathtracerap_tpu_torch.ops.rng import prng_key

    scene = build_cornell_box_scene().to_device(dev)
    n = CORNELL_RES[0] * CORNELL_RES[1]
    lr = 0.05
    step = make_train_step(scene, CameraConfig(**CORNELL_CAMERA), CORNELL_RES, TRAIN_SPP,
                           CORNELL_BOUNCES)
    params = extract_params(scene, ("mat_color",))
    target = torch.zeros((n, 3), device=dev)
    key = prng_key(0, dev)
    step(params, target, key)  # warm-up
    walls = []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        t0 = time.perf_counter()
        loss, new = step(params, target, key)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    res = {"resolution": CORNELL_RES, "spp": TRAIN_SPP, "bounces": CORNELL_BOUNCES,
           "step_s": walls,
           "fwd_bwd_mrays_per_s": n * TRAIN_SPP * CORNELL_BOUNCES / min(walls) / 1e6,
           "loss": loss.item(), "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    res.update(_counts())
    res.update(_grad_stats((params["mat_color"] - new["mat_color"]) / lr))
    # one primary trace, then bounces 1 .. 3 of every sample
    check(res["trace_list_launches"] == 1 + TRAIN_SPP * (CORNELL_BOUNCES - 1),
          "kernel 1 traces every bounce of the default step")
    check(res["sample_fused_launches"] == 0 and res["nearest_hit_launches"] == 0,
          "no whole-sample or dense kernel in the default step")
    check(res["plain_calls"] == 0, "no plain version called in the default step")
    check(math.isfinite(res["loss"]) and res["loss"] > 0, f"loss {res['loss']} finite and > 0")
    check(res["grad_finite"] and res["grad_nonzero"] > 0, "mat_color gradient finite and nonzero")
    return res


def megascene_render(dev):
    """The suite's megascene (358,824 triangles, 701 blocks of the fused
    pack, above the TPU kernels' streaming threshold of 313) through
    ``run_config("megascene")``: the binned engine, kernels 1 and 2 on
    701-entry block worklists.  Then both kernels against their plain
    versions on its primaries (kernel 1 from the suite's room camera, on
    the whole frame and on each of the render's slabs, and from
    INSIDE_CAMERA) and its first sorted bounce wavefront (the plain
    versions on the first PLAIN_SLICE rays)."""
    from pathtracerap_tpu_torch import CameraConfig
    from pathtracerap_tpu_torch.bench_suite import _ROOM_CAMERA, run_config, suite_configs
    from pathtracerap_tpu_torch.ops.plucker import bake_world_triangles

    _zero_counts()
    res = run_config("megascene", device=dev)
    res.update(_counts())
    res["renders"] = 3  # run_config: one warm-up and two timed renders
    check(res["engine"] == "binned", f"megascene routed to {res['engine']!r}, expected 'binned'")
    check(res["trace_list_launches"] > 0 and res["bounce_launches"] > 0,
          "kernels 1 and 2 launched on the megascene")
    check(res["plain_calls"] == 0, "no plain version called on the megascene")
    check(0.01 < res["image_mean"] < 1.0, f"megascene image mean {res['image_mean']} in (0.01, 1.0)")
    spec = suite_configs()["megascene"]
    world = bake_world_triangles(spec["scene"]().to_device(dev))
    res["blocks"] = world.block_aabb.shape[0]
    check(res["blocks"] == MEGASCENE_BLOCKS, f"megascene has {res['blocks']} blocks")
    res_xy, bounces = spec["cfg"]["resolution"], spec["cfg"]["max_bounces"]
    res["kernel1"] = kernel1_case(world, *kernel1_inputs(world, dev, _ROOM_CAMERA, res_xy),
                                  plain_rows=PLAIN_SLICE)
    # the render's launches: one a slab of SLAB primaries
    for k in range(res_xy[0] * res_xy[1] // SLAB):
        res[f"kernel1_slab{k}"] = kernel1_case(
            world, *kernel1_inputs(world, dev, _ROOM_CAMERA, res_xy, slice(k * SLAB, (k + 1) * SLAB)),
            plain_rows=PLAIN_SLICE)
    res["kernel1_inside"] = kernel1_case(
        world, *kernel1_inputs(world, dev, CameraConfig(**INSIDE_CAMERA), res_xy),
        plain_rows=PLAIN_SLICE)
    wavefront = bounce1_wavefront(world, dev, _ROOM_CAMERA, res_xy, bounces)
    check(wavefront[2].shape[1] == MEGASCENE_BLOCKS, "bounce worklists are 701 blocks wide")
    res["kernel2"] = kernel2_vs_plain(world, dev, wavefront, plain_rows=PLAIN_SLICE)
    # from inside the room the sorted bounce rays list many of the 701 blocks
    inside = bounce1_wavefront(world, dev, CameraConfig(**INSIDE_CAMERA), res_xy, bounces)
    res["kernel2_inside"] = kernel2_vs_plain(world, dev, inside, plain_rows=PLAIN_SLICE)
    return res


def pallas_vs_cpu(dev):
    """The per-bounce pallas engine on the card against the same on CPU
    tensors: a 32x16 x 2 spp x 5 bounce render of the reference scene with
    its fused pack (kernel 1) and baked without one (kernel 5), and a 32x16
    default-engine step on the Cornell box (loss and mat_color gradient)."""
    import torch

    from pathtracerap_tpu_torch import CameraConfig, build_cornell_box_scene, build_reference_scene
    from pathtracerap_tpu_torch.diff import extract_params, loss_and_grad
    from pathtracerap_tpu_torch.ops.plucker import bake_world_triangles
    from pathtracerap_tpu_torch.ops.rng import prng_key
    from pathtracerap_tpu_torch.render.wavefront import render_accumulate

    res = {}
    for name, tile in (("render_pack", 512), ("render_nopack", None)):
        imgs = {}
        for d in (dev, torch.device("cpu")):
            scene = build_reference_scene().to_device(d)
            world = bake_world_triangles(scene, fused_tile=tile)
            _zero_counts()
            imgs[d.type] = render_accumulate(scene, prng_key(3, d), CameraConfig(), SMALL_RES,
                                             SMALL_SPP, MAX_BOUNCES, engine="pallas", world=world)
            if d.type == "cuda":
                counts = _counts()
        diff = (imgs["cuda"].cpu() - imgs["cpu"]).abs() / SMALL_SPP
        res[name] = {"resolution": SMALL_RES, "spp": SMALL_SPP, "bounces": MAX_BOUNCES,
                     "mean_abs": diff.mean().item(), "max_abs": diff.max().item(),
                     "share_within": (diff <= CPU_COMPONENT_ABS).float().mean().item(), **counts}
        kernel = "trace_list" if tile else "nearest_hit"
        check(counts[f"{kernel}_launches"] > 0 and counts["plain_calls"] == 0,
              f"{kernel} on the card")
        check(res[name]["mean_abs"] <= CPU_MEAN_ABS, f"{name}: card vs CPU mean|diff| <= {CPU_MEAN_ABS}")
        check(res[name]["share_within"] >= CPU_COMPONENT_SHARE,
              f"{name}: {CPU_COMPONENT_SHARE} of components within {CPU_COMPONENT_ABS}")

    cam = CameraConfig(**CORNELL_CAMERA)
    out = {}
    for d in (dev, torch.device("cpu")):
        scene = build_cornell_box_scene().to_device(d)
        target = torch.full((SMALL_RES[0] * SMALL_RES[1], 3), 0.25, device=d)
        _zero_counts()
        out[d.type] = loss_and_grad(extract_params(scene), scene, target, prng_key(1, d), cam,
                                    SMALL_RES, SMALL_SPP, SMALL_BOUNCES)
        if d.type == "cuda":
            counts = _counts()
    (l_g, g_g), (l_c, g_c) = out["cuda"], out["cpu"]
    g_g, g_c = g_g["mat_color"].cpu(), g_c["mat_color"]
    res["cornell_step"] = {"loss_gpu": l_g.item(), "loss_cpu": l_c.item(),
                           "loss_rel": abs(l_g.item() - l_c.item()) / abs(l_c.item()),
                           "grad_max_abs": (g_g - g_c).abs().max().item(),
                           "grad_abs_max": g_c.abs().max().item(), **counts}
    check(counts["trace_list_launches"] > 0 and counts["plain_calls"] == 0, "kernel 1 on the card")
    check(res["cornell_step"]["loss_rel"] <= LOSS_RTOL, f"Cornell loss vs CPU within {LOSS_RTOL}")
    check(bool(torch.allclose(g_g, g_c, rtol=GRAD_RTOL, atol=1e-7)),
          f"Cornell gradient vs CPU within rtol {GRAD_RTOL}")
    return res


def _equal_live(a, b, live) -> bool:
    import torch

    return bool(torch.equal(a[live], b[live]))


def debug_vs_fast(world, dev):
    """Kernels 1, 2 and 4 in their debug form (the explicit det == 0 mask
    of PTAP_DEBUG=1) against their fast form: at the main paths' shapes
    (the 800,000 primaries, the 524,288-ray bounce-1 wavefront, the quality
    slab) and on the degenerate rays of tests/test_debug_mode.py.  Equal
    t, index and state on live rays; times of both forms."""
    import torch

    from pathtracerap_tpu_torch import CameraConfig
    from pathtracerap_tpu_torch.kernels import megakernel as MK
    from pathtracerap_tpu_torch.kernels import trace as TT
    from pathtracerap_tpu_torch.render.camera import generate_rays
    from pathtracerap_tpu_torch.utils.debug import degenerate_rays

    res = {}
    dro, drd = degenerate_rays(world)
    ro, rd = generate_rays(CameraConfig(), RESOLUTION, device=dev)
    for name, (r_o, r_d) in (("trace_list", (ro, rd)), ("trace_list_degenerate", (dro, drd))):
        w16, lists = TT.primary_inputs(world, r_o, r_d)
        live = w16[:, 10] > 0

        def kern(debug, w16=w16, lists=lists):
            return TT.nearest_hit_fused(w16, world, lists, TT.RAY_TILE, debug)

        (t_f, i_f), (t_d, i_d) = kern(False), kern(True)
        same = _equal_live(t_f, t_d, live) and _equal_live(i_f, i_d, live)
        check(same, f"{name}: debug and fast forms equal on live rays")
        res[name] = {"rays": int(live.sum().item()), "equal": same,
                     "hits": int((i_d[live] >= 0).sum().item())}
        if name == "trace_list":
            res[name].update(ms=cuda_ms(lambda: kern(False)), debug_ms=cuda_ms(lambda: kern(True)))

    pack, u_b, lists, unit, ray_tile = bounce1_wavefront(world, dev)
    degen = torch.cat([dro, drd, torch.ones_like(dro), torch.full_like(dro[:, :1], 4.0)], dim=1)
    degen = torch.cat([degen, degen.new_zeros(ray_tile - degen.shape[0], 10)])
    deg_lists, deg_unit = MK.bounce_lists(world, TT._slab_margin(world.block_aabb), degen, ray_tile)
    cases = (("bounce", (pack, u_b, lists, unit)),
             ("bounce_degenerate", (degen, u_b[:ray_tile], deg_lists, deg_unit)))
    for name, (pk, u, ls, un) in cases:
        live = pk[:, 9] > 0

        def kern(debug, pk=pk, u=u, ls=ls, un=un):
            return MK.bounce(pk, u, ls, un, world, ray_tile, True, debug)

        (o_f, i_f), (o_d, i_d) = kern(False), kern(True)
        same = _equal_live(o_f, o_d, live) and _equal_live(i_f, i_d, live)
        bits = (o_f.view(torch.int32) == o_d.view(torch.int32)).all(dim=1)[live]
        check(same, f"{name}: debug and fast forms equal on live rays")
        res[name] = {"rays": int(live.sum().item()), "equal": same,
                     "bit_equal_share": bits.float().mean().item(),
                     "hits": int((i_d[live] >= 0).sum().item())}
        check(res[name]["bit_equal_share"] == 1.0, f"{name}: debug state bit-equal")
        if name == "bounce":
            res[name].update(ms=cuda_ms(lambda: kern(False)), debug_ms=cuda_ms(lambda: kern(True)))

    w16, prim, u = quality_slab(dev)
    w_deg = TT.ray_vectors(dro, TT.normalize(drd))
    w_deg = torch.cat([w_deg, w_deg.new_zeros(TT.RAY_TILE - w_deg.shape[0], 16)])
    cases = (("sample_fused", (w16, prim, u)),
             ("sample_fused_degenerate", (w_deg, prim[:TT.RAY_TILE], u[:TT.RAY_TILE])))
    for name, (w, pr, uu) in cases:
        def kern(debug, w=w, pr=pr, uu=uu):
            return MK.sample_fused(w, pr, uu, world, MAX_BOUNCES, False, False, emit_idx=True,
                                   debug=debug)

        (c_f, i_f), (c_d, i_d) = kern(False), kern(True)
        same = bool(torch.equal(c_f, c_d) and torch.equal(i_f, i_d))
        bits = (c_f.view(torch.int32) == c_d.view(torch.int32)).all(dim=1)
        check(same, f"{name}: debug and fast forms equal")
        res[name] = {"rays": w.shape[0], "equal": same,
                     "bit_equal_share": bits.float().mean().item(),
                     "hits": int((i_d > 0).sum().item())}
        check(res[name]["bit_equal_share"] == 1.0, f"{name}: debug contribution bit-equal")
        if name == "sample_fused":
            def run(debug):
                return MK.sample_fused(w16, prim, u, world, MAX_BOUNCES, False, False, debug=debug)

            res[name].update(ms=cuda_ms(lambda: run(False)), debug_ms=cuda_ms(lambda: run(True)))
    return res


_SASS = {}


def sass_counts(opcode: str) -> dict:
    """Per compiled kernel (its mangled name) of the loaded library, the
    SASS instructions whose opcode starts with ``opcode`` (``cuobjdump
    -sass``)."""
    if opcode not in _SASS:
        from pathtracerap_tpu_torch.kernels import _build

        home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
        text = subprocess.run([os.path.join(home, "bin", "cuobjdump"), "-sass", _build.library()._name],
                              capture_output=True, text=True, check=True).stdout
        counts, name = {}, None
        for line in text.splitlines():
            if "Function : " in line:
                name = line.split("Function : ", 1)[1].strip()
                counts[name] = 0
            elif name is not None and re.search(r"\*/\s+(@!?U?P\w+\s+)?" + opcode, line):
                counts[name] += 1
        _SASS[opcode] = counts
    return _SASS[opcode]


def parts_build(variant: str, k: int, unroll: bool) -> dict:
    """The parts kernel's instantiation for a configuration: its registers,
    spills and static shared memory (``ptxas -v``), the dynamic shared
    memory its launch allows it (the staging ring, as the CUDA runtime
    reports it for the loaded kernel) and its tensor-core instructions in
    the SASS (HMMA: ``mma.sync``; HGMMA: ``wgmma``); ``mm_f32`` takes its
    products on FFMAs."""
    from pathtracerap_tpu_torch.kernels import _build
    from pathtracerap_tpu_torch.kernels.prof import _CODES, parts_smem

    f32 = variant == "mm_f32"
    name = ("parts_f32_kernel" if f32
            else f"parts_wgmma_kernelILi{k}ELi{_CODES[variant]}ELb{int(unroll)}E")
    res = _build.kernel_resources()
    (key,) = [m for m in res if name in m]
    hmma, hgmma = sass_counts("HMMA").get(key, 0), sass_counts("HGMMA").get(key, 0)
    form = ("wgmma m64n32k16 bf16" if hgmma else "mma.sync m16n8k16 bf16" if hmma
            else "none (f32 FFMA)")
    return {**res[key], "smem_dynamic": parts_smem(variant, k, unroll), "hmma": hmma,
            "hgmma": hgmma, "tensor_core_form": form}


def _prof_bound(variant: str, k: int, n: int, n_bytes: float) -> dict:
    """The least time for one launch of the parts kernel: the product (bf16
    passes on the tensor cores' peak, f32 on the f32 peak) plus the min over
    every product (mm_*) or the accept chain and min per (ray, triangle)."""
    cols = 4 * PROF_TB * PROF_NB
    passes = 1 if variant in ("mm_f32", "mm_bf16") else 3
    product = 2.0 * n * k * cols * passes
    rest = float(n * cols) if variant.startswith("mm_") else ACCEPT_FLOPS * n * PROF_TB * PROF_NB
    if variant == "mm_f32":
        return bound(product + rest, n_bytes)
    return bound(rest, n_bytes, bf16_flops=product)


def _matmul_alone_ms(w, ops, dtype, passes: int) -> float:
    """torch.matmul on the same operands, visit by visit into one (N, 4 *
    TB) buffer, ``passes`` products a visit: the product alone, written to
    memory, with neither the min nor the accept chain."""
    import torch

    a, b = w.to(dtype), ops.to(dtype)
    buf = torch.empty((w.shape[0], 4 * PROF_TB), dtype=dtype, device=w.device)
    cols = 4 * PROF_TB

    def run():
        for blk in range(PROF_NB):
            for _ in range(passes):
                torch.matmul(a, b[:, blk * cols:(blk + 1) * cols], out=buf)

    ms = cuda_ms(run, 3)
    del a, b, buf
    return ms


def prof_kernels_vs_plain(dev):
    """P1, P2 and P4 against their plain versions at the scripts' sizes
    (800,256 rays, tiles of 512, 8 visits of 2,048 columns; P3 has a phase
    of its own, p3_vs_plain): the kernel on every ray, the plain version on
    the first PLAIN_SLICE (P4: all).  Products within rtol 1e-5 on every
    ray, the accept chain and what follows on 99.9 % of rays, P4 exact.  Times, bounds, and
    torch.matmul's time on the same operands as context."""
    import torch

    from pathtracerap_tpu_torch.kernels import prof as KP
    from pathtracerap_tpu_torch.scripts import prof_kernel_parts as P1
    from pathtracerap_tpu_torch.scripts import prof_kernel_parts2 as P2
    from pathtracerap_tpu_torch.scripts import prof_mega_sweep as P4

    res = {}
    out_bytes = PROF_N * 4

    def compare(name, kern, plain, product: bool, bnd, library=None, library_call=None):
        o, ref = kern(), plain()
        torch.cuda.synchronize()
        o = o[:ref.shape[0]]
        close = torch.isclose(o, ref, rtol=PROF_RTOL, atol=0.0).float().mean().item()
        need = 1.0 if product else PROF_CHAIN_SHARE
        check(close >= need, f"{name}: {close} of rays within rtol {PROF_RTOL} (>= {need})")
        r = {"plain_rays": ref.shape[0], "close_share": close,
             "us_per_visit": None, "us_per_tile": None,
             "bit_equal_share": (o.view(torch.int32) == ref.view(torch.int32)).float().mean().item(),
             "max_abs_err": (o - ref).abs().max().item()}
        r["ms"] = cuda_ms(kern, host=r)
        r["plain_ms"] = cuda_ms(plain, 3, lead=False)
        r.update(bnd)
        r["bound_share"] = r["bound_ms"] / r["ms"]
        r["matmul_alone_ms"] = library
        r["library_ms"] = None if library_call is None else cuda_ms(library_call)
        # the parts kernel's grid is one tile of PROF_R rays a thread block;
        # the copy kernel's is not
        if name not in ("empty", "empty_with_ops"):
            tiles = PROF_N // PROF_R
            r["us_per_tile"] = r["ms"] * 1e3 / tiles
            r["us_per_visit"] = r["ms"] * 1e3 / (tiles * PROF_NB)
        res[name] = r

    w, ops, attr = P1.inputs(dev)
    sl = PLAIN_SLICE
    n_bytes = nbytes(w, ops, attr) + out_bytes
    mm = {"bf16": _matmul_alone_ms(w, ops, torch.bfloat16, 1),
          "f32": _matmul_alone_ms(w, ops, torch.float32, 1)}
    for v in P1.VARIANTS:
        lib = mm["f32"] if v == "mm_f32" else mm["bf16"] * (1 if v == "mm_bf16" else 3)
        compare(v, lambda v=v: P1.run_kernel(v, w, ops, attr),
                lambda v=v: KP.parts_plain(v, w[:sl], ops, attr, PROF_R, PROF_TB, PROF_NB),
                v.startswith("mm_"), _prof_bound(v, 16, PROF_N, n_bytes), lib)
        res[v].update(parts_build(v, 16, False))
    del w, ops, attr
    for variant, k in P2.RUNS:
        if variant in ("empty", "mm_bf16"):  # the same launches as P4's and P1's
            continue
        w, ops = P2.inputs(dev, k)
        nb_ = nbytes(w, ops) + out_bytes
        compare(variant, lambda: P2.run(variant, w, ops),
                lambda: KP.parts_plain("mm_bf16", w[:sl], ops, None, PROF_R, PROF_TB, PROF_NB),
                True, _prof_bound("mm_bf16", k, PROF_N, nb_),
                _matmul_alone_ms(w, ops, torch.bfloat16, 1))
        res[variant].update(parts_build("mm_bf16", *KP.P2_VARIANTS[variant]))
        del w, ops
    for name, r in res.items():
        check(r["spill_stores"] == 0 and r["spill_loads"] == 0, f"{name}: no spills")
        check((r["hmma"] + r["hgmma"] > 0) == (name != "mm_f32"),
              f"{name}: HMMA or HGMMA in the bf16 configurations, none in mm_f32 "
              f"({r['hmma']}, {r['hgmma']})")
    w, ops = P4.empty_inputs(dev)
    for with_ops in (True, False):
        name = "empty_with_ops" if with_ops else "empty"
        # a strided read of one 32-byte sector per 64-byte row, the column written
        # the library call is the one PyTorch call that computes out = w[:, 0]
        def kern(with_ops=with_ops):
            return KP.empty(w, PROF_R, ops if with_ops else None)

        def library():
            return w[:, 0].contiguous()

        compare(name, kern, lambda: KP.empty_plain(w), True, bound(0.0, PROF_N * 32 + out_bytes),
                library_call=library)
        check(res[name]["bit_equal_share"] == 1.0, f"{name}: exact")
        r = res[name]
        # device time in turns with the library call (the spread of repeated
        # readings), and the per-call readings beside
        reads = {"kernel": [], "library": []}
        for _ in range(COPY_ROUNDS):
            for who in ("kernel", "library", "library", "kernel"):
                reads[who].append(cuda_ms(kern if who == "kernel" else library))
        r.update(ms_reads=reads["kernel"], library_ms_reads=reads["library"],
                 bound_share=r["bound_ms"] / statistics.median(reads["kernel"]),
                 per_call_ms=per_call_ms(kern), library_per_call_ms=per_call_ms(library))
    del w, ops
    return res


def _stop_after_first_chunk():
    """Patch the facade's render_accumulate so that a render stops after its
    first chunk (whose checkpoint is written), as a killed process would."""
    from pathtracerap_tpu_torch.render import wavefront
    from pathtracerap_tpu_torch.utils import InjectedFault

    real, calls = wavefront.render_accumulate, []

    def first_only(*args, **kwargs):
        if calls:
            raise InjectedFault("stopped after the first chunk")
        calls.append(1)
        return real(*args, **kwargs)

    wavefront.render_accumulate = first_only
    return lambda: setattr(wavefront, "render_accumulate", real)


def _resume_case(scene, cfg, dev, path):
    """An unbroken chunked render, the same render stopped after its first
    chunk with a checkpoint, and its resumption: bit-equal images, with the
    resumed render's launches."""
    import torch

    from pathtracerap_tpu_torch import Renderer
    from pathtracerap_tpu_torch.utils import InjectedFault, load_checkpoint

    r = Renderer(scene, cfg, device=dev)
    r.render()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full = r.render()
    torch.cuda.synchronize()
    res = {"engine": r.engine, "resolution": cfg.resolution, "spp": cfg.samples_per_pixel,
           "chunk": cfg.samples_per_chunk, "bounces": cfg.max_bounces,
           "unbroken_s": time.perf_counter() - t0}
    if os.path.exists(path):
        os.remove(path)
    restore = _stop_after_first_chunk()
    try:
        r.render(checkpoint_path=path)
        raise RuntimeError("the render was not stopped")
    except InjectedFault:
        pass
    finally:
        restore()
    res["stopped_at"] = load_checkpoint(path).samples_done
    check(res["stopped_at"] == cfg.samples_per_chunk, "the checkpoint holds the first chunk")
    _zero_counts()
    t0 = time.perf_counter()
    resumed = r.render(checkpoint_path=path)
    torch.cuda.synchronize()
    res["resumed_s"] = time.perf_counter() - t0
    res.update(_counts())
    res["bit_equal"] = bool(torch.equal(resumed, full))
    res["finished_at"] = load_checkpoint(path).samples_done
    res["mean"] = resumed.mean().item()
    check(res["bit_equal"], f"{r.engine}: the resumed render equals the unbroken one bit for bit")
    check(res["finished_at"] == cfg.samples_per_pixel, "the last checkpoint holds every sample")
    check(res["plain_calls"] == 0, "no plain version called in the resumed render")
    return res


def resume_render(dev):
    """Checkpoint/resume through Renderer.render(checkpoint_path=...): the
    reference scene at 1000x800 x 8 spp x 5 bounces in chunks of 4
    (binned), and the Cornell box at 256x256 x 8 spp x 4 bounces in chunks
    of 4 (fused)."""
    from pathtracerap_tpu_torch import (
        CameraConfig, RenderConfig, build_cornell_box_scene, build_reference_scene,
    )

    os.makedirs(WORK, exist_ok=True)
    cfg = RenderConfig(resolution=RESOLUTION, samples_per_pixel=RESUME_SPP,
                       samples_per_chunk=RESUME_CHUNK, max_bounces=MAX_BOUNCES, engine="fused")
    res = {"reference": _resume_case(build_reference_scene().to_device(dev), cfg, dev,
                                     os.path.join(WORK, "reference.ckpt"))}
    check(res["reference"]["engine"] == "binned" and res["reference"]["bounce_launches"] > 0,
          "the reference scene resumes on the binned engine")
    cfg = RenderConfig(resolution=CORNELL_RES, samples_per_pixel=RESUME_SPP,
                       samples_per_chunk=RESUME_CHUNK, max_bounces=CORNELL_BOUNCES,
                       engine="fused", camera=CameraConfig(**CORNELL_CAMERA))
    res["cornell"] = _resume_case(build_cornell_box_scene().to_device(dev), cfg, dev,
                                  os.path.join(WORK, "cornell.ckpt"))
    check(res["cornell"]["engine"] == "fused" and res["cornell"]["sample_fused_launches"] > 0,
          "the Cornell box resumes on the fused engine")
    return res


def metrics_and_profile(dev):
    """The main-path render (in chunks of 8 samples) with a MetricsLogger:
    its chunk lines and live-ray curve; the same render at PROFILE_SPP
    samples under profile_trace: the trace file and the annotate names in
    it; device_memory_report()."""
    import torch

    from pathtracerap_tpu_torch import RenderConfig, Renderer, build_reference_scene
    from pathtracerap_tpu_torch.utils import MetricsLogger, profile_trace
    from pathtracerap_tpu_torch.utils.profiling import device_memory_report

    cfg = RenderConfig(resolution=RESOLUTION, samples_per_pixel=SPP, samples_per_chunk=8,
                       max_bounces=MAX_BOUNCES, engine="fused")
    r = Renderer(build_reference_scene().to_device(dev), cfg, device=dev)
    stream = io.StringIO()
    log = MetricsLogger(cfg, stream=stream)
    _zero_counts()
    img = r.render(metrics=log)
    torch.cuda.synchronize()
    m = log.finalize(SPP)
    check(m.device == torch.cuda.get_device_name(dev), "the metrics name the render's card")
    res = {"chunks": log.chunks, "live_ray_curve": log.live_ray_curve, "device": m.device,
           "metric_lines": stream.getvalue().count("[metrics]")}
    res.update(_counts())
    check(len(log.chunks) == SPP // 8, "one metrics line per chunk")
    curve = log.live_ray_curve
    check(len(curve) == MAX_BOUNCES and curve[0] == 1.0
          and all(a >= b for a, b in zip(curve, curve[1:])), "the live-ray curve decays from 1")
    check(res["bounce_launches"] > 0 and res["plain_calls"] == 0, "kernels on the metered render")
    check(bool(torch.isfinite(img).all()), "the metered image is finite")

    trace_dir = os.path.join(WORK, "profile")
    for old in glob.glob(os.path.join(trace_dir, "trace_*.json")):
        os.remove(old)
    r = Renderer(r.scene, dataclasses.replace(cfg, samples_per_pixel=PROFILE_SPP), device=dev)
    r.render()  # warm-up
    t0 = time.perf_counter()
    with profile_trace(trace_dir) as prof:
        r.render()
        torch.cuda.synchronize()
    res["profiled_s"] = time.perf_counter() - t0
    (path,) = glob.glob(os.path.join(trace_dir, "trace_*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = ("trace_primary", "shade", "sort", "bounce", "accumulate")
    res["annotate_counts"] = {n: sum(1 for e in events if e.get("name") == n) for n in names}
    res["trace_mb"] = os.path.getsize(path) / 1e6
    res["device_kernel_events"] = sum(1 for e in events if e.get("cat") == "kernel")
    res["device_ms_by_kernel"] = {
        e.key: e.device_time_total / 1e3 for e in sorted(
            prof.key_averages(), key=lambda e: -e.device_time_total)[:6]}
    check(all(v > 0 for v in res["annotate_counts"].values()), "every annotate name in the trace")
    check(res["device_kernel_events"] > 0, "the trace holds the card's kernels")
    res["memory"] = device_memory_report()
    check(res["memory"]["cuda:0"]["bytes_limit"] > 0, "device_memory_report reads the card")
    return res


def prof_scripts(dev):
    """The four profiling scripts' main() at full size, their printed lines
    kept; the launches of P1 to P4 are counted over them."""
    from pathtracerap_tpu_torch.kernels import prof as KP
    from pathtracerap_tpu_torch.scripts import (
        prof_kernel_parts, prof_kernel_parts2, prof_mega_sweep, prof_r5_shade,
    )

    res = {}
    _zero_counts()
    for mod in (prof_kernel_parts, prof_kernel_parts2, prof_r5_shade, prof_mega_sweep):
        name = mod.__name__.rsplit(".", 1)[1]
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            out = mod.main()
        res[name] = {"wall_s": time.perf_counter() - t0, "lines": buf.getvalue().splitlines(),
                     "result": out}
    res["launches"] = {
        "parts": {f"{v}/K={k}{'/unrolled' if u else ''}": c
                  for (v, k, u), c in KP.parts.variant_launches.items()},
        "empty": {("with_ops" if o else "without_ops"): c
                  for o, c in KP.empty.variant_launches.items()},
        "argmin_int": KP.argmin_int.launches,
    }
    res.update(_counts())
    check(res["plain_calls"] == 0, "no plain version called by the scripts")
    check(res["prof_r5_shade"]["result"]["argmin_int_correct"], "P3 correct in its script")
    check(KP.parts.variant_launches.keys() == KP.PARTS_CONFIGS and KP.empty.launches > 0
          and KP.argmin_int.launches > 0, "every profiling kernel launched by the scripts")
    return res


def _golden_relation(img, path) -> tuple:
    """(mean |diff|, correlation) of an (H, W, 3) image against a golden BMP,
    both downsampled by 8."""
    import numpy as np

    from pathtracerap_tpu_torch import read_bmp

    g = read_bmp(path).astype(np.float32) / 255.0
    a, b = downsample(img, 8), downsample(g, 8)
    return float(np.abs(a - b).mean()), float(np.corrcoef(a.ravel(), b.ravel())[0, 1])


def parity_render(dev):
    """The parity DDA engine (kernel G1) on the reference scene at 1000x800,
    PARITY_SPP spp, 5 bounces: ``render_accumulate(engine="parity",
    tile_size=PARITY_TILE)``, held to the parity golden (mean |diff| < 0.08,
    correlation > 0.9) and to the fused golden as tests/test_reference_golden.py:119
    holds the two goldens (mean |diff| < 0.09, correlation > 0.945; its
    lower bound on mean |diff|, 0.05, pins an offset of the parity golden
    and is read, not held, see below), both downsampled by 8; then one
    ``Renderer(engine="parity")`` render at its default tile."""
    import numpy as np
    import torch

    from pathtracerap_tpu_torch import (
        CameraConfig, RenderConfig, Renderer, build_reference_scene, read_bmp,
    )
    from pathtracerap_tpu_torch.ops.rng import prng_key
    from pathtracerap_tpu_torch.render.wavefront import render_accumulate

    scene = build_reference_scene().to_device(dev)
    w, h = RESOLUTION

    def render():
        acc = render_accumulate(scene, prng_key(0, dev), CameraConfig(), RESOLUTION, PARITY_SPP,
                                MAX_BOUNCES, engine="parity", tile_size=PARITY_TILE)
        return acc.reshape(h, w, 3) / PARITY_SPP

    render()  # warm-up
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    img = render()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    res = {"render_s": dt, "mrays_per_s": w * h * PARITY_SPP * MAX_BOUNCES / dt / 1e6,
           "spp": PARITY_SPP, "bounces": MAX_BOUNCES, "tile_size": PARITY_TILE}
    res.update(_counts())
    launches = 1 + PARITY_SPP * (MAX_BOUNCES - 1)  # the primaries once, then every bounce
    check(res["grid_dda_launches"] == launches, f"G1 launched {launches} times a render")
    check(res["plain_calls"] == 0, "no plain version called on the parity render")
    img = img.cpu().numpy()
    check(img.shape == (h, w, 3) and bool(np.isfinite(img).all()), "parity image finite")
    res["mean"] = float(img.mean())
    res["golden_mad"], res["golden_corr"] = _golden_relation(img, PARITY_GOLDEN)
    check(res["golden_mad"] < 0.08, f"mean|diff| vs the parity golden {res['golden_mad']} < 0.08")
    check(res["golden_corr"] > 0.9, f"correlation vs the parity golden {res['golden_corr']} > 0.9")
    res["fused_golden_mad"], res["fused_golden_corr"] = _golden_relation(img, GOLDEN)
    # test_reference_golden.py:119 also pins mean|diff| > 0.05 between the two
    # goldens: the parity golden is brighter than the fused one (channel means
    # below).  The TPU made that offset: its default-precision f32 products
    # round the operands of the parity engine's transforms to bfloat16
    # (tests/parity_golden_witness.py; ROADMAP queue C), and the port's f32
    # transforms do not, so the render does not meet that lower bound
    # (fused_golden_offset_pinned, printed); the upper bound and the
    # correlation are held
    res["fused_golden_offset_pinned"] = res["fused_golden_mad"] > 0.05
    check(res["fused_golden_mad"] < 0.09,
          f"mean|diff| vs the fused golden {res['fused_golden_mad']} < 0.09")
    check(res["fused_golden_corr"] > 0.945,
          f"correlation vs the fused golden {res['fused_golden_corr']} > 0.945")
    # the same render by JAX's parity engine in f32 on the CPU: the render
    # lands on it (the BMP's 8-bit rounding is far below these bounds)
    res["f32_golden_mad"], res["f32_golden_corr"] = _golden_relation(img, PARITY_F32_GOLDEN)
    check(res["f32_golden_mad"] < F32_GOLDEN_MAD,
          f"mean|diff| vs the f32 parity golden {res['f32_golden_mad']} < {F32_GOLDEN_MAD}")
    check(res["f32_golden_corr"] > F32_GOLDEN_CORR,
          f"correlation vs the f32 parity golden {res['f32_golden_corr']} > {F32_GOLDEN_CORR}")
    res["channel_means"] = {
        "render": img.mean(axis=(0, 1)).tolist(),
        **{name: (read_bmp(path).astype(np.float32) / 255.0).mean(axis=(0, 1)).tolist()
           for name, path in (("parity_golden", PARITY_GOLDEN), ("fused_golden", GOLDEN),
                              ("f32_parity_golden", PARITY_F32_GOLDEN))},
    }

    cfg = RenderConfig(resolution=RESOLUTION, samples_per_pixel=PARITY_SPP,
                       max_bounces=MAX_BOUNCES, engine="parity")
    r = Renderer(scene, cfg, device=dev)
    check(r.engine == "parity" and r.world is None, "Renderer(engine='parity') bakes no world")
    r.render()  # warm-up
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    img = r.render()
    torch.cuda.synchronize()
    rr = {"render_s": time.perf_counter() - t0}
    rr["mrays_per_s"] = w * h * PARITY_SPP * MAX_BOUNCES / rr["render_s"] / 1e6
    rr.update(_counts())
    check(rr["grid_dda_launches"] == launches and rr["plain_calls"] == 0,
          "Renderer(engine='parity') went through G1 alone")
    img = img.cpu().numpy()
    rr["mean"] = float(img.mean())
    check(bool(np.isfinite(img).all()) and 0.01 < rr["mean"] < 1.0, "Renderer parity image")
    rr["golden_mad"], rr["golden_corr"] = _golden_relation(img, PARITY_GOLDEN)
    check(rr["golden_mad"] < 0.08 and rr["golden_corr"] > 0.9,
          f"Renderer parity image vs the parity golden ({rr['golden_mad']}, {rr['golden_corr']})")
    res["renderer"] = rr
    return res


def parity_small_vs_plain(dev):
    """The parity render at PARITY_SMALL_RES, PARITY_SPP spp, 5 bounces on
    the card twice: through G1 (``_make_tracer(engine="parity")``) and
    through the plain version (a tracer calling ``trace_parity`` on the
    same CUDA tensors), bit for bit."""
    import torch

    from pathtracerap_tpu_torch import CameraConfig, build_reference_scene
    from pathtracerap_tpu_torch.ops.intersect import trace_parity
    from pathtracerap_tpu_torch.ops.rng import prng_key
    from pathtracerap_tpu_torch.render.camera import generate_rays
    from pathtracerap_tpu_torch.render.wavefront import _make_tracer, _render_tile

    scene = build_reference_scene().to_device(dev)
    ro, rd = generate_rays(CameraConfig(), PARITY_SMALL_RES, device=dev)

    def render(tracer):
        return _render_tile(tracer, ro, rd, 0, prng_key(0, dev), PARITY_SPP, MAX_BOUNCES, True,
                            tile_size=PARITY_TILE)

    _zero_counts()
    t0 = time.perf_counter()
    kern = render(_make_tracer(scene, "parity"))
    torch.cuda.synchronize()
    res = {"resolution": PARITY_SMALL_RES, "spp": PARITY_SPP, "bounces": MAX_BOUNCES,
           "g1_s": time.perf_counter() - t0, **_counts()}
    t0 = time.perf_counter()
    plain = render(lambda o, d, alive=None: trace_parity(scene, o.contiguous(), d.contiguous(),
                                                         alive=alive))
    torch.cuda.synchronize()
    res["plain_s"] = time.perf_counter() - t0
    res["bit_equal"] = bool(torch.equal(kern.view(torch.int32), plain.view(torch.int32)))
    res["mean"] = kern.mean().item() / PARITY_SPP
    check(res["grid_dda_launches"] == 1 + PARITY_SPP * (MAX_BOUNCES - 1) and res["plain_calls"] == 0,
          "the small render through G1 alone")
    check(res["bit_equal"], "the small parity render through G1 equals it through the plain version")
    return res


def parity_train_step(dev):
    """The parity engine's backward on the card (``engine="parity"``: G1
    traces, the winner's attributes gathered under autograd): one
    ``make_train_step`` of the mat_color loss at the parity render's
    1000x800, PARITY_SPP spp, 5 bounces (a warm-up, then a timed step), the
    mat_color and model_to_world gradient in quality mode at the same
    size, and a step at SMALL_RES on the card against the same step on
    CPU tensors (loss LOSS_RTOL, gradient GRAD_RTOL)."""
    import torch

    from pathtracerap_tpu_torch import CameraConfig, build_reference_scene
    from pathtracerap_tpu_torch.diff import extract_params, loss_and_grad, make_train_step
    from pathtracerap_tpu_torch.ops.rng import prng_key

    scene = build_reference_scene().to_device(dev)
    n = RESOLUTION[0] * RESOLUTION[1]
    target = torch.zeros((n, 3), device=dev)
    lr = 0.05
    step = make_train_step(scene, CameraConfig(), RESOLUTION, PARITY_SPP, MAX_BOUNCES, lr=lr,
                           tile_size=PARITY_TILE, engine="parity")
    params = extract_params(scene, ("mat_color",))
    step(params, target, prng_key(0, dev))  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    loss, new = step(params, target, prng_key(0, dev))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = 1 + PARITY_SPP * (MAX_BOUNCES - 1)
    res = {"resolution": RESOLUTION, "spp": PARITY_SPP, "bounces": MAX_BOUNCES, "step_s": dt,
           "fwd_bwd_mrays_per_s": n * PARITY_SPP * MAX_BOUNCES / dt / 1e6, "loss": loss.item(),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, **_counts()}
    res.update(_grad_stats((params["mat_color"] - new["mat_color"]) / lr))
    check(res["grid_dda_launches"] == launches and res["plain_calls"] == 0,
          f"the parity step launched G1 {launches} times and no plain version")
    check(math.isfinite(res["loss"]) and res["loss"] > 0, f"loss {res['loss']} finite and > 0")
    check(res["grad_finite"] and res["grad_nonzero"] > 0, "mat_color gradient finite and nonzero")

    _zero_counts()
    t0 = time.perf_counter()
    q_loss, q_grads = loss_and_grad(
        extract_params(scene, ("mat_color", "model_to_world")), scene, target, prng_key(0, dev),
        CameraConfig(), RESOLUTION, PARITY_SPP, MAX_BOUNCES, tile_size=PARITY_TILE,
        engine="parity", parity=False)
    torch.cuda.synchronize()
    q = {"step_s": time.perf_counter() - t0, "loss": q_loss.item(), **_counts()}
    for k, g in q_grads.items():
        q[k] = _grad_stats(g)
    check(q["grid_dda_launches"] == launches and q["plain_calls"] == 0, "quality: G1 alone")
    check(q["mat_color"]["grad_finite"] and q["mat_color"]["grad_nonzero"] > 0
          and q["model_to_world"]["grad_finite"] and q["model_to_world"]["grad_nonzero"] > 0,
          f"quality gradients finite and nonzero: {q}")
    res["quality"] = q

    def small(d, parity):
        sc = build_reference_scene().to_device(d)
        m = SMALL_RES[0] * SMALL_RES[1]
        return loss_and_grad(
            extract_params(sc, ("mat_color", "model_to_world")), sc,
            torch.full((m, 3), 0.25, device=d), prng_key(1, d), CameraConfig(), SMALL_RES,
            SMALL_SPP, SMALL_BOUNCES, tile_size=PARITY_TILE, engine="parity", parity=parity)

    for parity in (True, False):
        _zero_counts()
        l_g, g_g = small(dev, parity)
        counts = _counts()
        l_c, g_c = small(torch.device("cpu"), parity)
        key = "vs_cpu" if parity else "vs_cpu_quality"
        res[key] = {"loss_gpu": l_g.item(), "loss_cpu": l_c.item(),
                    "loss_rel": abs(l_g.item() - l_c.item()) / abs(l_c.item()),
                    **{f"{k}_max_abs": (g_g[k].cpu() - g_c[k]).abs().max().item() for k in g_c},
                    **counts}
        check(counts["grid_dda_launches"] > 0 and counts["plain_calls"] == 0, "G1 on the card")
        check(res[key]["loss_rel"] <= LOSS_RTOL, f"{key}: loss rel {res[key]['loss_rel']}")
        for k in g_c:
            check(bool(torch.allclose(g_g[k].cpu(), g_c[k], rtol=GRAD_RTOL, atol=1e-7)),
                  f"{key}: {k} gradient within rtol {GRAD_RTOL}")
    return res


def _hit_fields_equal(a, b) -> dict:
    """Per field, the share of rays on which two hit records (and their
    stats) are bit-equal."""
    import torch

    (ra, sa), (rb, sb) = a, b
    out = {}
    for f in ("t", "normal", "mat_type", "mat_color", "mat_ri", "model", "tri"):
        x, y = getattr(ra, f), getattr(rb, f)
        eq = x.view(torch.int32) == y.view(torch.int32)
        out[f] = (eq.all(dim=-1) if eq.dim() > 1 else eq).float().mean().item()
    for f in ("steps", "tri_tests"):
        out[f] = (sa[f] == sb[f]).float().mean().item()
    return out


def _odd_rays(host, dev, n: int = 8192):
    """Rays that start inside the models' world boxes (one model each, in
    turn), with directions that have one, two or no zero components."""
    import numpy as np
    import torch

    rng = np.random.default_rng(10)
    lo, hi = [], []
    for i in range(host.num_models):
        m = host.model_mesh[i]
        corners = np.array([[x, y, z] for x in (host.mesh_bbox_min[m][0], host.mesh_bbox_max[m][0])
                            for y in (host.mesh_bbox_min[m][1], host.mesh_bbox_max[m][1])
                            for z in (host.mesh_bbox_min[m][2], host.mesh_bbox_max[m][2])])
        wc = corners @ host.model_to_world[i][:3, :3].T + host.model_to_world[i][:3, 3]
        lo.append(wc.min(axis=0))
        hi.append(wc.max(axis=0))
    k = np.arange(n) % host.num_models
    lo, hi = np.asarray(lo)[k], np.asarray(hi)[k]
    o = (lo + rng.uniform(0.0, 1.0, size=(n, 3)) * (hi - lo)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    q = n // 8
    d[:q, 0] = 0.0
    d[q:2 * q, 1] = 0.0
    d[2 * q:3 * q, 2] = 0.0
    d[3 * q:4 * q, :2] = 0.0
    d[4 * q:5 * q, 1:] = 0.0
    return (torch.as_tensor(o, device=dev).contiguous(), torch.as_tensor(d, device=dev).contiguous())


def _g1_resources() -> dict:
    """ptxas's registers, spills and static shared memory of G1's four
    forms, ``grid_dda_kernel<shared, coherent>``: "shared" (tables in
    shared memory) or "global", and "coherent" (the primaries' form) or
    "bounce"."""
    from pathtracerap_tpu_torch.kernels import _build

    kr = {}
    for key, v in _build.kernel_resources().items():
        m = re.search(r"grid_dda_kernelILb([01])ELb([01])E", key)
        if m:
            kr[f"{'shared' if m.group(1) == '1' else 'global'}/"
               f"{'coherent' if m.group(2) == '1' else 'bounce'}"] = v
    check(len(kr) == 4, f"G1's four forms in the build: {sorted(kr)}")
    return kr


def highpoly_grid_scene():
    """The highpoly blob alone under SceneBuilder(grid_dims=(25, 25, 25)):
    146,688 triangles, 225,554 bucket entries, up to 2,613 a voxel; its
    (v0, e1, e2) table, 5.3 MB, takes G1's global-memory form."""
    from pathtracerap_tpu_torch.scene.build import SceneBuilder
    from pathtracerap_tpu_torch.scene.types import Material, MaterialType

    b = SceneBuilder(grid_dims=(25, 25, 25))
    b.add_instance(b.add_mesh_file(HIGHPOLY_MESH), Material(MaterialType.DIFFUSE, (0.8, 0.3, 0.2)))
    return b.build()


def _rays_at_box(host, dev, n: int, seed: int = 11):
    """n rays from a sphere around the first mesh's box toward points
    inside it."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    lo, hi = host.mesh_bbox_min[0], host.mesh_bbox_max[0]
    centre, radius = (lo + hi) / 2, 2.0 * float(np.linalg.norm(hi - lo))
    o = rng.normal(size=(n, 3))
    o = centre + radius * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = lo + rng.uniform(size=(n, 3)) * (hi - lo) - o
    return (torch.as_tensor(o.astype(np.float32), device=dev).contiguous(),
            torch.as_tensor(d.astype(np.float32), device=dev).contiguous())


def dda_vs_plain(dev):
    """Kernel G1 against its plain version (ops/intersect.trace_parity) on
    the card, with stats, every field (the winning model and triangle
    too) bit-equal on every ray: on DDA_PLAIN_RAYS rays drawn across the
    1000x800 primary wavefront and across its bounce-1 wavefront (the
    parity render's uniforms, with its liveness mask), on rays that start
    inside the models' boxes with zero direction components (all live, and
    half of them), on a wavefront with no live ray and on one with a
    single live ray, and in the global-memory form on HIGHPOLY_RAYS rays
    at the highpoly blob.  Then G1's device time on the whole primary and
    bounce-1 wavefronts (800,000 rays; bounce 1 also with every ray
    traced, as before live rays only), the plain version's on
    DDA_PLAIN_RAYS, the time of gathering mat_type, mat_color and mat_ri
    from the model index in the wrapper (the alternative to the kernel
    writing them), and the bound from the kernel's own counters on the
    live rays: tri_tests x MT_FLOPS + steps x DDA_STEP_FLOPS operations,
    or the bytes read and written, whichever is larger."""
    import torch

    from pathtracerap_tpu_torch import CameraConfig, build_reference_scene
    from pathtracerap_tpu_torch.kernels import dda as DD
    from pathtracerap_tpu_torch.ops.intersect import trace_parity
    from pathtracerap_tpu_torch.ops.rng import chunk_uniforms, prng_key
    from pathtracerap_tpu_torch.render.camera import generate_rays
    from pathtracerap_tpu_torch.render.shade import RayState, shade

    host = build_reference_scene()
    scene = host.to_device(dev)
    ro, rd = generate_rays(CameraConfig(), RESOLUTION, device=dev)
    ro, rd = ro.contiguous(), rd.contiguous()
    n = ro.shape[0]
    hits0 = DD.grid_trace(scene, ro, rd)
    u = chunk_uniforms(prng_key(0, dev), 0, MAX_BOUNCES, n, n, 0, rng_tile=PARITY_TILE)
    st = shade(RayState.primary(ro, rd, MAX_BOUNCES), hits0, u[:, :4])
    wavefronts = {"primary": (ro, rd, None),
                  "bounce1": (st.orig.contiguous(), st.dir.contiguous(), st.remaining > 0)}
    pick = torch.arange(0, n, n // DDA_PLAIN_RAYS, device=dev)[:DDA_PLAIN_RAYS]
    res = {"rays": n, "plain_rays": DDA_PLAIN_RAYS, "form": DD.grid_trace_form(scene)}
    check(res["form"]["shared"], "the reference scene's tables fit in shared memory")
    tables = DD._scene_args(scene, dev)
    scene_bytes = nbytes(*(tables[k] for k in ("models", "tris", "tri_nrm", "voxel", "vt_tris")))

    def both(o, d, alive=None):
        return (DD.grid_trace(scene, o, d, alive=alive, return_stats=True),
                trace_parity(scene, o, d, return_stats=True, alive=alive))

    for name, (o, d, alive) in wavefronts.items():
        a_s = None if alive is None else alive[pick]
        eq = _hit_fields_equal(*both(o[pick].contiguous(), d[pick].contiguous(), a_s))
        check(all(v == 1.0 for v in eq.values()), f"G1 equals its plain version on {name}: {eq}")
        rec, stats = DD.grid_trace(scene, o, d, alive=alive, return_stats=True)
        live = n if alive is None else int(alive.sum().item())
        r = {"live_rays": live, "equal_share": eq, "max_abs_err": 0.0,
             "hits": (rec.t < F_MAX).float().mean().item(),
             "steps": int(stats["steps"].sum().item()),
             "tri_tests": int(stats["tri_tests"].sum().item())}
        r["ms"] = cuda_ms(lambda: DD.grid_trace(scene, o, d, alive=alive), host=r)
        if alive is not None:
            # every ray traced, in the same (bounce) form: the live-only gain
            every = torch.ones_like(alive)
            r["all_rays_ms"] = cuda_ms(lambda: DD.grid_trace(scene, o, d, alive=every))
        r["with_stats_ms"] = cuda_ms(lambda: DD.grid_trace(scene, o, d, alive=alive,
                                                           return_stats=True))
        o_s, d_s = o[pick].contiguous(), d[pick].contiguous()
        r["plain_ms"] = cuda_ms(lambda: trace_parity(scene, o_s, d_s, alive=a_s), 2, lead=False)
        hit, idx = rec.model >= 0, rec.model.clamp(min=0).long()
        ri = tables["models"][:, 47]  # MODEL_WORDS' index of refraction
        r["gather_attrs_ms"] = cuda_ms(lambda: (
            torch.where(hit, scene.mat_type[idx], 0),
            torch.where(hit[:, None], scene.mat_color[idx], 0.0), torch.where(hit, ri[idx], 1.5)))
        # the live rays' origin and direction read once, the mask read, every
        # ray's record written once
        io_bytes = (24 * live + (0 if alive is None else n)
                    + nbytes(rec.t, rec.normal, rec.mat_type, rec.mat_color, rec.mat_ri, rec.model,
                             rec.tri))
        r.update(bound(MT_FLOPS * r["tri_tests"] + DDA_STEP_FLOPS * r["steps"],
                       io_bytes + scene_bytes))
        r["bound_share"] = r["bound_ms"] / r["ms"]
        res[name] = r

    o, d = _odd_rays(host, dev)
    half = torch.arange(o.shape[0], device=dev) % 2 == 0
    for name, alive in (("inside_zero_dirs", None), ("inside_zero_dirs_half_live", half)):
        eq = _hit_fields_equal(*both(o, d, alive))
        check(all(v == 1.0 for v in eq.values()), f"G1 equals its plain version, {name}: {eq}")
        res[name] = {"rays": o.shape[0], "equal_share": eq,
                     "hits": (DD.grid_trace(scene, o, d, alive=alive).t < F_MAX).float().mean().item()}
    o, d, _ = wavefronts["bounce1"]
    none = torch.zeros(n, dtype=torch.bool, device=dev)
    (rec, stats), plain = both(o[pick].contiguous(), d[pick].contiguous(), none[pick])
    eq = _hit_fields_equal((rec, stats), plain)
    check(all(v == 1.0 for v in eq.values()) and bool((rec.t == F_MAX).all() and (rec.model == -1).all() and (rec.mat_ri == 1.5).all()
               and (stats["steps"] == 0).all() and (stats["tri_tests"] == 0).all()),
          "a wavefront with no live ray: every record the miss, no work")
    one = none.clone()
    one[n // 2 + 17] = True
    eq = _hit_fields_equal(*both(o, d, one))
    check(all(v == 1.0 for v in eq.values()), f"G1 equals its plain version, one live ray: {eq}")
    res["dead"] = {"ms": cuda_ms(lambda: DD.grid_trace(scene, o, d, alive=none))}
    res["one_live"] = {"equal_share": eq, "ms": cuda_ms(lambda: DD.grid_trace(scene, o, d, alive=one))}

    t0 = time.perf_counter()
    big_host = highpoly_grid_scene()
    big = big_host.to_device(dev)
    hp = {"build_s": time.perf_counter() - t0, "triangles": int(big_host.tri_vidx.shape[0]),
          "bucket_entries": int(big_host.per_voxel_tris.shape[0]),
          "max_bucket": int(big_host.voxel_tri_count.max()), "form": DD.grid_trace_form(big),
          "table_bytes": DD._scene_args(big, dev)["smem_bytes"]}
    check(not hp["form"]["shared"], "the highpoly blob takes the global-memory form")
    o, d = _rays_at_box(big_host, dev, HIGHPOLY_RAYS)
    # both of its forms: every ray live (the primaries' form) and half of them
    for name, alive in (("equal_share", None),
                        ("equal_share_half_live", torch.arange(o.shape[0], device=dev) % 2 == 0)):
        (kb, ks), (pb, ps) = (DD.grid_trace(big, o, d, alive=alive, return_stats=True),
                              trace_parity(big, o, d, return_stats=True, alive=alive))
        hp[name] = _hit_fields_equal((kb, ks), (pb, ps))
        check(all(v == 1.0 for v in hp[name].values()),
              f"G1's global-memory form equals its plain version: {name} {hp[name]}")
        if alive is None:
            hp.update(rays=HIGHPOLY_RAYS, hits=(kb.t < F_MAX).float().mean().item(),
                      tri_tests=int(ks["tri_tests"].sum().item()),
                      ms=cuda_ms(lambda: DD.grid_trace(big, o, d)))
    res["highpoly"] = hp
    del big, big_host
    torch.cuda.empty_cache()
    kr = _g1_resources()
    res.update(registers=max(v["registers"] for v in kr.values()),
               spill_stores=max(v["spill_stores"] for v in kr.values()),
               spill_loads=max(v["spill_loads"] for v in kr.values()), forms=kr)
    return res


def aovs(dev):
    """render_aovs at 1000x800 on the card (kernel G1 with stats), with the
    checks of tests/test_debug_viz.py:20, and write_aov_bmps."""
    import numpy as np

    from pathtracerap_tpu_torch import RenderConfig, build_reference_scene
    from pathtracerap_tpu_torch.render.debug_viz import render_aovs, write_aov_bmps

    scene = build_reference_scene().to_device(dev)
    cfg = RenderConfig(resolution=RESOLUTION, engine="parity")
    _zero_counts()
    t0 = time.perf_counter()
    a = render_aovs(scene, cfg)
    res = {"wall_s": time.perf_counter() - t0}
    res.update(_counts())
    check(res["grid_dda_launches"] == 1 and res["plain_calls"] == 0, "render_aovs launched G1 once")
    w, h = RESOLUTION
    check(a["depth"].shape == (h, w) and a["normal"].shape == (h, w, 3), "AOV shapes")
    res["hit_share"] = float(a["hit"].mean())
    check(res["hit_share"] > 0.9, f"hit share {res['hit_share']} > 0.9")
    d = a["depth"][a["hit"]]
    check(bool(np.isfinite(d).all()) and float(d.min()) > 0, "depth finite and positive where hit")
    res["dda_steps_max"], res["tri_tests_max"] = int(a["dda_steps"].max()), int(a["tri_tests"].max())
    check(res["dda_steps_max"] > 1 and res["tri_tests_max"] > 1, "the traversal did work")
    nrm = np.linalg.norm(a["normal"][a["hit"]], axis=-1)
    res["normal_len_err"] = float(np.abs(nrm - 1.0).max())
    check(res["normal_len_err"] < 1e-4, f"unit normals where hit ({res['normal_len_err']})")
    paths = write_aov_bmps(scene, cfg, os.path.join(WORK, "aovs"))
    check(len(paths) == 7 and all(os.path.getsize(p) > w * h * 3 for p in paths.values()),
          "seven AOV BMPs written")
    return res


def gridparity(dev):
    """The suite's gridparity row (``run_config("gridparity")``: the
    reference scene at 256x256, 2 spp, 5 bounces on the parity engine, one
    RNG tile over all rays, as JAX's row)."""
    from pathtracerap_tpu_torch.bench_suite import run_config

    _zero_counts()
    res = run_config("gridparity", device=dev)
    res.update(_counts())
    res["renders"] = 3  # run_config: one warm-up and two timed renders
    check(res["engine"] == "parity", f"gridparity ran {res['engine']!r}")
    check(res["grid_dda_launches"] == 3 * (1 + 2 * 4), "G1 launched 9 times a render")
    check(res["plain_calls"] == 0, "no plain version called on gridparity")
    check(0.01 < res["image_mean"] < 1.0, f"gridparity image mean {res['image_mean']}")
    return res


def _p3_inputs(rows: int, cols: int, dev):
    """x (rows, cols) standard normal with NaN rows (one NaN, two NaNs),
    tied minima and all-equal rows, and the (4,) int32 bases."""
    import torch

    from pathtracerap_tpu_torch.scripts.prof_r5_shade import BASES

    g = torch.Generator(device="cpu").manual_seed(rows)
    x = torch.randn(rows, cols, generator=g)
    x[::7, 100] = float("nan")
    x[::14, 33] = float("nan")
    x[3::13, 5] = -50.0  # a tie between columns 5 and 400
    x[3::13, 400] = -50.0
    x[5::17] = 1.0  # every column equal: the first wins
    x[6::19, cols - 1] = -60.0  # the minimum in the last group of 128
    return x.to(dev), torch.tensor(BASES, dtype=torch.int32, device=dev)


def p3_vs_plain(dev):
    """P3 (csrc/prof_argmin.cu) bit-equal to its plain version at 512x512
    (the script's shape) and 131,072x512, NaN and tie rows included, and
    on a misaligned x (the strided path); device times, the launch floor
    (an empty kernel on P3's grid: one warp a row and a block) and
    torch.argmin alone."""
    import ctypes

    import torch

    from pathtracerap_tpu_torch.kernels import _build
    from pathtracerap_tpu_torch.kernels import prof as KP

    res = {}
    lib = _build.library()
    for rows, cols in P3_SHAPES:
        x, bases = _p3_inputs(rows, cols, dev)
        ref = KP.argmin_int_plain(x, bases)
        r = {"rows": rows, "cols": cols, "max_abs_err": 0.0}
        check(KP.argmin_vec_path(x) and bool(torch.equal(KP.argmin_int(x, bases), ref)),
              f"P3 exact at {rows}x{cols} (the float4 path)")
        xm = torch.empty(rows * cols + 1, device=dev)[1:].view(rows, cols)
        xm.copy_(x)
        check(not KP.argmin_vec_path(xm) and bool(torch.equal(KP.argmin_int(xm, bases), ref)),
              "P3 exact on a misaligned x (the strided path)")
        r["strided_path_ms"] = cuda_ms(lambda: KP.argmin_int(xm, bases))
        r["ms"] = cuda_ms(lambda: KP.argmin_int(x, bases), host=r)
        r["plain_ms"] = cuda_ms(lambda: KP.argmin_int_plain(x, bases), lead=False)
        r["argmin_alone_ms"] = cuda_ms(lambda: torch.argmin(x, dim=1))
        stream = torch.cuda.current_stream(dev).cuda_stream

        def noop():
            _build.check(lib.ptt_noop(rows, 32, ctypes.c_void_p(stream)), "ptt_noop")

        r["launch_floor_ms"] = cuda_ms(noop)
        r.update(bound(2.0 * x.numel(), nbytes(x, bases, ref)))
        r["bound_share"] = r["bound_ms"] / r["ms"]
        res[f"{rows}x{cols}"] = r
    return res


_T0 = time.perf_counter()


def phase(name: str, res: dict) -> None:
    """Print a phase's result, with the seconds since the script started."""
    print(f"{name}: {json.dumps({**res, 'at_s': time.perf_counter() - _T0})}", flush=True)


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
    k3 = kernel3_vs_plain(world, dev)
    phase("kernel3_vs_plain", k3)
    torch.cuda.reset_peak_memory_stats()
    mp = main_path(dev)
    mp["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    phase("main_path", mp)
    ts = train_step(dev)
    phase("train_step", ts)
    phase("train_step_quality_vertex", train_step_quality_vertex(dev))
    phase("train_step_vs_cpu", train_step_vs_cpu(dev))
    k4 = kernel4_vs_plain(world, dev)
    phase("kernel4_vs_plain", k4)
    qr = quality_render(dev)
    phase("quality_render", qr)
    phase("cornell_render", cornell_render(dev))
    phase("cornell_train_step", cornell_train_step(dev))
    phase("fused_vs_cpu", fused_vs_cpu(dev))

    from pathtracerap_tpu_torch.bench_suite import build_highpoly_scene

    t0 = time.perf_counter()
    big = build_highpoly_scene(subdiv=BEYOND_SUBDIV, use_asset=False).to_device(dev)
    host_s = time.perf_counter() - t0
    k5, big_world = kernel5_vs_plain(big, dev)
    k5["scene_build_s"] = host_s
    phase("kernel5_vs_plain", k5)
    del big_world
    torch.cuda.empty_cache()
    bp = beyond_pack_render(big, dev)
    phase("beyond_pack_render", bp)
    phase("beyond_pack_train_step", beyond_pack_train_step(big, dev))
    del big
    torch.cuda.empty_cache()
    phase("pallas_train_step", pallas_train_step(dev))
    mega = megascene_render(dev)
    phase("megascene_render", mega)
    phase("pallas_vs_cpu", pallas_vs_cpu(dev))
    g1 = dda_vs_plain(dev)
    phase("dda_vs_plain", g1)
    phase("parity_small_vs_plain", parity_small_vs_plain(dev))
    pr = parity_render(dev)
    phase("parity_render", pr)
    phase("parity_train_step", parity_train_step(dev))
    phase("aovs", aovs(dev))
    phase("gridparity", gridparity(dev))
    phase("debug_vs_fast", debug_vs_fast(world, dev))
    pk = prof_kernels_vs_plain(dev)
    phase("prof_kernels_vs_plain", pk)
    p3 = p3_vs_plain(dev)
    phase("p3_vs_plain", p3)
    phase("resume_render", resume_render(dev))
    phase("metrics_and_profile", metrics_and_profile(dev))
    ps = prof_scripts(dev)
    phase("prof_scripts", ps)
    check("jax" not in sys.modules, "jax was never imported")

    def entry(name, source, replaces, launches, k, max_abs_err=None, extra=()):
        out = {
            "name": name, "route": "cuda", "source": f"pathtracerap_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches,
            "max_abs_err": k["max_abs_err"] if max_abs_err is None else max_abs_err,
            "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"],
            # no single PyTorch call computes a nearest hit, nor a profiling
            # kernel's product together with its min or accept chain; the
            # copy kernel's is w[:, 0].contiguous()
            "library_ms": k.get("library_ms"),
        }
        if k.get("matmul_alone_ms") is not None:
            out["library_note"] = f"none (matmul alone: {k['matmul_alone_ms']} ms)"
        out.update(extra if isinstance(extra, dict) else {key: k[key] for key in extra})
        return out

    # kernels 2 to 5: rays a thread sweeps, the build's registers and spills
    sweep = ("rays_per_thread", "registers", "spill_stores", "spill_loads")
    # kernel 1: the same and its chunk; its rows are its main paths' launches,
    # one a slab, with the whole frame's time beside
    k1_extra = {key: k1[key] for key in sweep + ("chunk",)}
    k1_extra["frame_ms"] = k1["parity_primaries"]["ms"]
    mega_k1 = [key for key in mega if key.startswith("kernel1")]
    mega_extra = {"slab1_ms": mega["kernel1_slab1"]["ms"], "frame_ms": mega["kernel1"]["ms"]}

    pallas = "pathtracerap_tpu/pallas/"
    k4q = k4["traced_jittered"]  # the quality render's launch, its main path
    kernels = [
        entry("trace_list", "trace_list.cu", pallas + "trace.py:188", mp["trace_list_launches"],
              k1["render_slab"], max(k1[c]["max_abs_err"] for c in K1_CASES), extra=k1_extra),
        entry("bounce", "bounce.cu", pallas + "megakernel.py:1666", mp["bounce_launches"], k2,
              extra=sweep),
        entry("bounce_trace", "bounce_trace.cu", pallas + "megakernel.py:1846",
              ts["bounce_trace_launches"], k3, extra=sweep + ("sm_clock_mhz", "pairs_per_sm_clock")),
        entry("megakernel", "megakernel.cu", pallas + "megakernel.py:1206",
              qr["sample_fused_launches"], k4q, max(m["max_abs_err"] for m in k4.values()),
              extra=sweep + ("pairs_swept", "pairs_live")),
        # the beyond-pack render's bounces are its launches: the bounce-1
        # wavefront's numbers, with the gate tests made, and the time of a
        # wavefront with no live ray
        entry("nearest_hit", "nearest_hit.cu", pallas + "trace.py:54", bp["nearest_hit_launches"],
              k5["bounce1"], max(v["max_abs_err"] for v in k5.values() if isinstance(v, dict)),
              extra={**{key: k5[key] for key in sweep + ("group",)},
                     "gate_tests": k5["bounce1"]["gate_tests"],
                     "dead_wavefront_ms": k5["dead"]["ms"]}),
        # the TPU kernels' streamed modes, at the megascene's 701 blocks
        entry("trace_list_701_blocks", "trace_list.cu", pallas + "trace.py:222",
              mega["trace_list_launches"], mega["kernel1_slab0"],
              max(mega[c]["max_abs_err"] for c in mega_k1), extra=mega_extra),
        entry("bounce_701_blocks", "bounce.cu", pallas + "megakernel.py:954",
              mega["bounce_launches"], mega["kernel2"], extra=sweep),
    ]
    # the profiling kernels: their path is the scripts' main() (prof_scripts)
    from pathtracerap_tpu_torch.kernels.prof import P1_VARIANTS, P2_VARIANTS

    parts, empties = ps["launches"]["parts"], ps["launches"]["empty"]
    # the parts kernel's share of its bound, bits against the plain version,
    # build, and its product's form (wgmma or mma.sync on the tensor cores, or FFMA)
    parts_extra = ("bound_share", "bit_equal_share", "registers", "spill_stores", "spill_loads",
                   "smem", "smem_dynamic", "tensor_core_form")
    for v in P1_VARIANTS:  # P2's mm_bf16 is the same launch as P1's
        kernels.append(entry(f"prof_parts:{v}", "prof_parts.cu", "scripts/prof_kernel_parts.py:35",
                             parts.get(f"{v}/K=16", 0), pk[v], extra=parts_extra))
    for v, (k, unroll) in P2_VARIANTS.items():
        if v != "mm_bf16":
            kernels.append(entry(f"prof_parts:{v}", "prof_parts.cu",
                                 "scripts/prof_kernel_parts2.py:33",
                                 parts.get(f"mm_bf16/K={k}{'/unrolled' if unroll else ''}", 0),
                                 pk[v], extra=parts_extra))
    kernels.append(entry("prof_parts:empty", "prof_parts.cu",
                         "scripts/prof_kernel_parts2.py:33, scripts/prof_mega_sweep.py:30",
                         empties.get("without_ops", 0), pk["empty"]))
    kernels.append(entry("prof_parts:empty_with_ops", "prof_parts.cu",
                         "scripts/prof_mega_sweep.py:30", empties.get("with_ops", 0),
                         pk["empty_with_ops"]))
    # P3 at the script's 512 x 512, with the launch floor and the 131,072-row reading
    p3s, p3l = p3["512x512"], p3["131072x512"]
    kernels.append(entry("prof_argmin", "prof_argmin.cu", "scripts/prof_r5_shade.py:96",
                         ps["launches"]["argmin_int"], p3s,
                         extra={"launch_floor_ms": p3s["launch_floor_ms"],
                                "argmin_alone_ms": p3s["argmin_alone_ms"],
                                "rows131072_ms": p3l["ms"],
                                "rows131072_bound_share": p3l["bound_share"]}))
    # G1 has no Pallas counterpart: JAX's grid trace is XLA; its launches are
    # the parity render's, its time the primary wavefront's (800,000 rays)
    kernels.append(entry("grid_dda", "grid_dda.cu",
                         "pathtracerap_tpu/ops/intersect.py:276 (XLA; no pallas_call)",
                         pr["grid_dda_launches"], g1["primary"],
                         extra={"bound_share": g1["primary"]["bound_share"],
                                "bounce1_ms": g1["bounce1"]["ms"],
                                "bounce1_bound_ms": g1["bounce1"]["bound_ms"],
                                "bounce1_bound_share": g1["bounce1"]["bound_share"],
                                "bounce1_live_rays": g1["bounce1"]["live_rays"],
                                "bounce1_all_rays_ms": g1["bounce1"]["all_rays_ms"],
                                "plain_rays": g1["plain_rays"], "registers": g1["registers"],
                                "spill_stores": g1["spill_stores"],
                                "smem_bytes": g1["form"]["smem_bytes"],
                                "blocks_per_sm": g1["form"]["blocks_per_sm"],
                                "highpoly_global_form_ms": g1["highpoly"]["ms"]}))
    for k in kernels:
        check(k["ms"] >= k["bound_ms"], f"{k['name']}: {k['ms']} ms not below its bound {k['bound_ms']}")
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
