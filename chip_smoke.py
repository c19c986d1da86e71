"""The card check and the kernel-alone device times of the PyTorch + CUDA
port on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels (nvcc) and the native host library (g++); runs the
card tests (CARD_TESTS under ``pytest --noconftest -m cuda``), which hold
every path of the port on the card; then, for each kernel of ``PERF.md``
section 6 at that table's shapes, reads its device time alone
(``cuda_ms``), its plain PyTorch version's (on PLAIN_SLICE rays where a
full sweep takes seconds) and the least time the card could take
(``bound``), and holds its output to the plain version's on those rays;
then counts each kernel's launches over one call of each main path.  It
prints a line a phase, the kernels' list, and ``{"ok": true, "device":
{...}}``.  A failed test or hold, a reading whose host fell behind the spin
or that calls a plain version, or one below its bound raises.  It needs
one CUDA device and imports no JAX.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
RESOLUTION = (1000, 800)
SPP = 24
MAX_BOUNCES = 5
SLAB = 16 * 8192  # rays of one binned slab (BINNED_SLAB_TILES RNG tiles)
SAMPLE_BATCH = 4
TRAIN_SPP = 8  # bench.py:89-90
F_MAX = 9999999.0
FUSED_SLAB = 64 * 8192  # rays of one fused slab (FUSED_SLAB_TILES RNG tiles)
CORNELL_RES, CORNELL_SPP, CORNELL_BOUNCES = (256, 256), 64, 4  # bench_suite.py:106-114
# the world above the fused pack's budget: build_highpoly_scene(subdiv=736,
# use_asset=False), rendered at the suite megascene's settings
BEYOND_SUBDIV = 736
BEYOND_RES, BEYOND_SPP, BEYOND_BOUNCES = (512, 512), 2, 6  # bench_suite.py megascene
BEYOND_TRAIN_RES, BEYOND_TRAIN_SPP, BEYOND_TRAIN_BOUNCES = (256, 256), 2, 4
PLAIN_SLICE = 16384  # rays the plain versions trace where a full sweep would take seconds
# bounds: NVIDIA H100 SXM data sheet (dense FP32 peak, dense BF16 tensor-core
# peak, HBM3 bandwidth)
PEAK_F32_FLOPS, PEAK_BF16_FLOPS, PEAK_BYTES = 67e12, 989e12, 3.35e12
# the INT32 pipe: 64 lanes a clock on each of the 132 SMs at 1980 MHz
PEAK_INT32_OPS = 132 * 64 * 1.98e9
PAIR_FLOPS = 47  # per (ray, triangle): 22 FMAs, det, division, t/u/v, accept chain
SHADE_FLOPS = 250  # per shaded ray: every scatter candidate and the selects
GATE_FLOPS = 28  # per (live ray, box) test of kernel 5: 6 sub, 6 mul, 10 min/max, 6 for the tests
# the profiling kernels at the scripts' sizes (scripts/prof_kernel_parts.py:26-30)
PROF_N, PROF_R, PROF_TB, PROF_NB = 800256, 512, 512, 8
# per (ray, triangle) pair of P1's accept chain: det 2, reciprocal 1, t/u/v 3,
# u + v 1, the parallel test and 5 range tests 6, select 1, min 1
ACCEPT_FLOPS = 15
# the parity DDA engine (kernel G1): the golden's 2 spp x 5 bounces at
# 1000x800, drawn per 2048-ray RNG tile (scripts/make_golden_parity.py)
PARITY_SPP, PARITY_TILE = 2, 2048
# G1's global-memory form: the 146,688-triangle blob alone under 25^3 voxels
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
# kernel R1 (csrc/rng.cu): (samples, rays, bounces) of the Cornell render's
# chunk_uniforms call and of the reference train step's (one binned slab)
RNG_CALLS = {"cornell": (8, 65536, 4), "reference_step": (1, 131072, 5)}
# R1's operations a uniform on the INT32 pipe, counted in its bound: each of
# the 20 rounds' rotate and xor (SHF and LOP3 run on no other pipe; the
# compiler issues most adds as IMAD on the FMA pipe)
RNG_INT_OPS = 40
# kernel 2 on the benchmark's highpoly configuration (512x512 x 1 spp x 8
# bounces, two slabs): a frame's wavefronts at this seed
HIGHPOLY_CONFIG = os.path.join(ROOT, "ptbench", "configs", "highpoly.json")
HIGHPOLY_SEED = 7
PALLAS = "pathtracerap_tpu/pallas/"
# the card check: the card test files that import no JAX
CARD_TESTS = ("tests/test_torch_cuda.py", "tests/test_torch_rng_kernel.py",
              "tests/test_torch_card_paths.py")
HIT_FIELDS = ("t", "normal", "mat_type", "mat_color", "mat_ri", "model", "tri")
HIT_STATS = ("steps", "tri_tests")

# the device timer (cuda_ms): torch.cuda._sleep spins this many SM clocks a
# millisecond at 2 GHz, above the H100's 1980 MHz, so that a spin lasts at
# least as long as asked
SLEEP_CYCLES_PER_MS = 2.0e6
TIMER_PROBE_MS, TIMER_MAX_SPIN_MS, TIMER_TRIES = 20.0, 500.0, 4
TIMER_DEVICE_MS, TIMER_MAX_REPS = 25.0, 200
# a plain version whose one call takes this long is read from that one call
TIMER_ONE_CALL_MS = 100.0


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, reps: int = 10, lead: bool = True) -> float:
    """Device time of one call of ``fn`` in ms: CUDA events around ``n``
    calls queued behind a spin (``torch.cuda._sleep``, sized from a probe
    call) that lasts until the host has queued them all, so that no host
    time falls between the events; ``n`` is ``reps``, or more for a short
    call (TIMER_DEVICE_MS of device work, at most TIMER_MAX_REPS calls).
    Where the host was still queueing when the spin ran out (a slow host,
    or a full launch queue), the reading is taken again with a quarter of
    the calls behind a longer spin; with ``lead`` (kernels and library
    calls) a reading whose host never got ahead raises.  Without it (plain
    versions, some of which wait for the device) such a reading holds host
    time, and a call of TIMER_ONE_CALL_MS or more is read from one call."""
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
    if not lead and a.elapsed_time(b) >= TIMER_ONE_CALL_MS:
        return a.elapsed_time(b)
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
    return a.elapsed_time(b) / n


def bound(flops: float, n_bytes: float, bf16_flops: float = 0.0, int_ops: float = 0.0) -> dict:
    """The least time the card could take for the work: the larger of the
    operations (f32 ones over the f32 peak plus bf16 products over the
    tensor cores' bf16 peak plus 32-bit integer ones over the INT32 pipe's
    rate) and the bytes over the memory rate."""
    t_ops = flops / PEAK_F32_FLOPS + bf16_flops / PEAK_BF16_FLOPS + int_ops / PEAK_INT32_OPS
    t_bytes = n_bytes / PEAK_BYTES
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes", "flops": flops,
            "bytes": n_bytes, **({"bf16_flops": bf16_flops} if bf16_flops else {}),
            **({"int_ops": int_ops} if int_ops else {})}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def list_pairs(lists, live, ray_tile: int, unit: int, n_valid: int) -> int:
    """(ray, triangle) pairs a worklist kernel needs for these inputs: per
    tile, the real triangles of its listed units (the first ``n_valid``
    of the world; padding is never accepted) times its live rays."""
    ids = lists.long()
    tris = ((n_valid - ids * unit).clamp(0, unit) * (ids >= 0)).sum(dim=1)
    return int((live.reshape(-1, ray_tile).sum(dim=1) * tris).sum().item())


def wrappers() -> dict:
    """The kernels' wrappers by name; each counts its launches."""
    from pathtracerap_tpu_torch.kernels import dda, prof
    from pathtracerap_tpu_torch.kernels import defer_shade as KS
    from pathtracerap_tpu_torch.kernels import megakernel as MK
    from pathtracerap_tpu_torch.kernels import rng as KR
    from pathtracerap_tpu_torch.kernels import trace as TT

    return {"trace_list": TT.nearest_hit_fused, "bounce": MK.bounce,
            "bounce_trace": MK.bounce_trace, "sample_fused": MK.sample_fused,
            "nearest_hit": TT.nearest_hit, "grid_dda": dda.grid_trace, "rng": KR.chunk_uniforms,
            "prof_parts": prof.parts, "prof_empty": prof.empty, "prof_argmin": prof.argmin_int,
            "defer_shade": KS.defer_shade}


def plain_calls() -> int:
    """The plain versions' calls so far."""
    from pathtracerap_tpu_torch.kernels import megakernel as MK
    from pathtracerap_tpu_torch.kernels import prof
    from pathtracerap_tpu_torch.kernels import trace as TT
    from pathtracerap_tpu_torch.ops import rng
    from pathtracerap_tpu_torch.ops.intersect import trace_parity

    return sum(f.calls for f in (
        TT.nearest_hit_fused_plain, MK.bounce_plain, MK.bounce_trace_plain, MK.sample_fused_plain,
        TT.nearest_hit_plain, prof.parts_plain, prof.empty_plain, prof.argmin_int_plain,
        trace_parity, rng.chunk_uniforms_plain, rng.chunk_jitter_uniforms_plain,
        MK.defer_shade_plain, MK.primary_shade_plain))


def timed(kernel: str, kern, plain=None, plain_reps: int = 10, held=None, **extra) -> dict:
    """A reading of ``kern`` (which must launch the ``kernel`` wrapper and
    call no plain version) by cuda_ms, and of ``plain`` unless None, with
    ``extra`` (the bound among them); then ``held(kern(), plain())``,
    unless None, holds the kernel's output to the plain version's."""
    w = wrappers()[kernel]
    launches, calls = w.launches, plain_calls()
    res = {"ms": cuda_ms(kern)}
    check(w.launches > launches and plain_calls() == calls,
          f"{kernel}: the kernel ran and no plain version did")
    res["plain_ms"] = None if plain is None else cuda_ms(plain, plain_reps, lead=False)
    if held is not None:
        held(kern(), None if plain is None else plain())
    res.update(extra)
    return res


def same_bits(what: str, got, want, rows=None) -> None:
    """The kernel's output ``got`` (a tensor or a tuple) bit for bit equal
    to its plain version's ``want`` on the plain version's rows (the first
    ones), or on those of them ``rows`` marks."""
    import torch

    got, want = ((x,) if torch.is_tensor(x) else tuple(x) for x in (got, want))
    check(len(got) == len(want), f"{what}: as many outputs as its plain version")
    for a, b in zip(got, want):
        a = a[:b.shape[0]]
        if a.is_floating_point():
            a, b = a.view(torch.int32), b.view(torch.int32)
        check(torch.equal(a[rows], b[rows]) if rows is not None else torch.equal(a, b),
              f"{what}: bit-equal to its plain version")


def close_share(what: str, got, want, need: float) -> None:
    """At least ``need`` of the kernel's outputs within rtol 1e-5 of the
    plain version's (the card tests' tolerance for P1 and P2)."""
    import torch

    share = torch.isclose(got[:want.shape[0]], want, rtol=1e-5, atol=0.0).float().mean().item()
    check(share >= need, f"{what}: {share} of rays within rtol 1e-5 of its plain version, not {need}")


def ptxas(name: str) -> dict:
    """Registers, spills and shared memory (``ptxas -v``) of the one
    compiled kernel whose mangled name holds ``name``."""
    from pathtracerap_tpu_torch.kernels import _build

    res = _build.kernel_resources()
    (key,) = [k for k in res if name in k]
    return res[key]


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


def kernel1_timing(world, dev, camera=None, resolution=RESOLUTION, rays=slice(None),
                   plain_rows=None, debug=False) -> dict:
    """Kernel 1 on the camera's primaries (the slice ``rays``), its plain
    version on them (on the first ``plain_rows`` when given), t and index
    bit-equal on their live rays, the bound on the live pairs its lists
    hold."""
    from pathtracerap_tpu_torch import CameraConfig
    from pathtracerap_tpu_torch.kernels.trace import (
        RAY_TILE, nearest_hit_fused, nearest_hit_fused_plain, primary_inputs,
    )
    from pathtracerap_tpu_torch.render.camera import generate_rays

    ro, rd = generate_rays(camera or CameraConfig(), resolution, device=dev)
    w16, lists = primary_inputs(world, ro[rays], rd[rays])
    nb, tb = world.block_aabb.shape[0], world.tri_block

    def kern(debug=False):
        return nearest_hit_fused(w16, world, lists, RAY_TILE, debug)

    outs = kern()
    pairs = list_pairs(lists, w16[:, 10] > 0, RAY_TILE, tb, world.n_valid)
    live = w16[:plain_rows, 10] > 0  # the padding to whole tiles is dead
    res = timed("trace_list", kern,
                lambda: nearest_hit_fused_plain(w16[:plain_rows], world.fused_ops, nb, tb),
                3 if plain_rows else 10, lambda k, p: same_bits("B1 on live rays", k, p, live),
                rays=ro[rays].shape[0], plain_rays=plain_rows, blocks=nb,
                **bound(PAIR_FLOPS * pairs, nbytes(w16, world.ops_tri, lists, *outs)))
    if debug:
        res["debug_ms"] = cuda_ms(lambda: kern(True))
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
    ray_tile = binned_ray_tile(world)
    check(ro.shape[0] % ray_tile == 0, "slab fills whole ray tiles")
    hits0 = trace_pallas(world, ro, rd)
    pack, u_flat = first_wavefront(
        world, ro, rd, hits0, prng_key(0, dev), 0, SAMPLE_BATCH, ro.shape[0], bounces, True, 0
    )
    pix = torch.arange(pack.shape[0], device=dev)
    pack, pix = sort_wavefront(pack, pix, *scene_morton_bounds(world.block_aabb))
    lists, unit = bounce_lists(world, _slab_margin(world.block_aabb), pack, ray_tile)
    return pack, u_flat[:, 4:8][pix], lists, unit, ray_tile


def kernel2_timing(world, wavefront, plain_rows=None, debug=False) -> dict:
    """Kernel 2 on a sorted bounce wavefront, its plain version (on the
    first ``plain_rows`` rays when given), the state bit-equal on those
    rays and the index on their live ones, the bound on its lists' live
    pairs."""
    from pathtracerap_tpu_torch.kernels.megakernel import bounce, bounce_plain

    pack, u_b, lists, unit, ray_tile = wavefront

    def kern(debug=False):
        return bounce(pack, u_b, lists, unit, world, ray_tile, True, debug)

    outs = kern()
    pairs = list_pairs(lists, pack[:, 9] > 0, ray_tile, unit, world.n_valid)
    live = pack[:plain_rows, 9] > 0
    res = timed("bounce", kern, lambda: bounce_plain(pack[:plain_rows], u_b[:plain_rows], world, True),
                3 if plain_rows else 10,
                lambda k, p: (same_bits("B2 state", k[0], p[0]),
                              same_bits("B2 index on live rays", k[1], p[1], live)),
                rays=pack.shape[0], plain_rays=plain_rows,
                worklist_width=lists.shape[1],
                **bound(PAIR_FLOPS * pairs,
                        nbytes(pack, u_b, lists, world.ops_tri, world.attr_rows, *outs)))
    if debug:
        res["debug_ms"] = cuda_ms(lambda: kern(True))
    return res, outs


def kernel3_timing(world, wavefront) -> dict:
    """Kernel 3 on the diff forward's first bounce wavefront (the slab is a
    multiple of its 512-ray padding, so the render's rows): t and index
    bit-equal to its plain version's on live rays."""
    from pathtracerap_tpu_torch.kernels.megakernel import bounce_trace, bounce_trace_plain

    pack, _, lists, unit, ray_tile = wavefront

    def kern():
        return bounce_trace(pack, lists, unit, world, ray_tile)

    outs = kern()
    pairs = list_pairs(lists, pack[:, 9] > 0, ray_tile, unit, world.n_valid)
    return timed("bounce_trace", kern, lambda: bounce_trace_plain(pack, world, ray_tile),
                 held=lambda k, p: same_bits("B3 on live rays", k, p, pack[:, 9] > 0),
                 rays=pack.shape[0],
                 **bound(PAIR_FLOPS * pairs, nbytes(pack, lists, world.ops_tri, *outs)))


def defer_shade_timing(world, dev) -> dict:
    """Kernel S1 on the reference step's first slab (SLAB rays, one sample,
    as the train step's index forward runs it): the deferred form on the
    sorted bounce-1 wavefront (kernel 3's winners, the stream read at row
    pix), then the bounce-0 form on the slab's primaries; each beside its
    plain twin on the same inputs, bit-equal on every ray, and bound by the
    bytes a ray moves."""
    import torch

    from pathtracerap_tpu_torch import CameraConfig
    from pathtracerap_tpu_torch.kernels import defer_shade as KS
    from pathtracerap_tpu_torch.kernels import megakernel as MK
    from pathtracerap_tpu_torch.kernels.trace import _slab_margin, trace_pallas
    from pathtracerap_tpu_torch.ops.math import normalize
    from pathtracerap_tpu_torch.ops.rng import prng_key
    from pathtracerap_tpu_torch.render.camera import generate_rays

    ro, rd = generate_rays(CameraConfig(), RESOLUTION, device=dev)
    ro, rd = ro[:SLAB], normalize(rd[:SLAB])
    hits0 = trace_pallas(world, ro, rd)
    pack, u_flat = MK.first_wavefront(world, ro, rd, hits0, prng_key(0, dev), 0, 1, SLAB,
                                      MAX_BOUNCES, True, 0)
    pix = torch.arange(SLAB, device=dev)
    pack, pix = MK.sort_wavefront(pack, pix, *MK.scene_morton_bounds(world.block_aabb))
    ray_tile = MK.binned_ray_tile(world)
    lists, unit = MK.bounce_lists(world, _slab_margin(world.block_aabb), pack, ray_tile)
    t, col1 = MK.bounce_trace(pack, lists, unit, world, ray_tile)

    def kern():
        return KS.defer_shade(pack, t, col1, world.attr_rows, u_flat, True, pix, 1)

    out = kern()
    # a ray reads its pack row, t, column and pix, 4 uniforms, and the
    # winner's 16 attribute floats where it is live and hit; it writes its row
    reads = int(((pack[:, 9] > 0) & (col1 > 0)).sum().item())
    res = timed("defer_shade", kern,
                lambda: MK.defer_shade_plain(world, pack, (t, col1), u_flat[:, 4:8][pix], True),
                held=lambda k, p: same_bits("S1 deferred", k, p), rays=SLAB,
                **bound(SHADE_FLOPS * SLAB, nbytes(pack, t, col1, pix, out) + 64 * reads + 16 * SLAB))
    fields = [getattr(hits0, f) for f in ("t", "normal", "mat_type", "mat_color", "geom_normal",
                                          "mat_ri")]

    def kern0():
        return KS.defer_shade_primary(hits0, ro, rd, u_flat, MAX_BOUNCES, True)

    res["primary"] = timed(
        "defer_shade", kern0, lambda: MK.primary_shade_plain(hits0, ro, rd, u_flat, MAX_BOUNCES, True),
        held=lambda k, p: same_bits("S1 bounce 0", k, p), rays=SLAB,
        **bound(SHADE_FLOPS * SLAB, nbytes(*fields, rd, kern0()) + 16 * SLAB))
    return res


def highpoly_slabs(dev):
    """The primary slabs of one frame of the highpoly configuration
    (``ptbench/configs/highpoly.json``: 149,733 triangles in 293 blocks,
    512x512 x 1 spp x 8 bounces, two slabs, seed HIGHPOLY_SEED) as the
    render traces them: yields (world, max_bounces, key, tile_base, ro, rd,
    hits0) for each."""
    from ptbench import cells, scenes
    from pathtracerap_tpu_torch import RenderConfig, Renderer
    from pathtracerap_tpu_torch.kernels import megakernel as TM
    from pathtracerap_tpu_torch.kernels.trace import trace_pallas
    from pathtracerap_tpu_torch.ops.math import normalize
    from pathtracerap_tpu_torch.ops.rng import RNG_TILE, prng_key
    from pathtracerap_tpu_torch.render.camera import generate_rays

    with open(HIGHPOLY_CONFIG) as f:
        config = json.load(f)
    cfg = RenderConfig(resolution=tuple(config["resolution"]), samples_per_pixel=1,
                       max_bounces=config["max_bounces"], camera=cells.camera(config),
                       engine=config["engine"])
    world = Renderer(scenes.port_scene(scenes.scene_inputs(config)).to_device(dev), cfg,
                     device=dev).world
    ro, rd = generate_rays(cfg.camera, cfg.resolution, device=dev)
    key = prng_key(HIGHPOLY_SEED, dev)
    slab = TM.BINNED_SLAB_TILES * RNG_TILE
    for s0 in range(0, ro.shape[0], slab):
        ro_s, rd_s = ro[s0:s0 + slab], normalize(rd[s0:s0 + slab])
        yield world, cfg.max_bounces, key, s0 // RNG_TILE, ro_s, rd_s, trace_pallas(world, ro_s, rd_s)


def highpoly_wavefronts(dev):
    """The bounce wavefronts of one frame of the highpoly configuration
    (:func:`highpoly_slabs`): yields (world, (pack, uniforms, worklists,
    unit, ray_tile)) for each of its 14, sorted and listed as the render
    does, and advances the frame by kernel 2."""
    import torch

    from pathtracerap_tpu_torch.kernels import megakernel as TM
    from pathtracerap_tpu_torch.kernels.trace import _slab_margin

    for world, bounces, key, tile_base, ro_s, rd_s, hits0 in highpoly_slabs(dev):
        ray_tile = TM.binned_ray_tile(world)
        margin = _slab_margin(world.block_aabb)
        lo, hi = TM.scene_morton_bounds(world.block_aabb)
        pack, u_flat = TM.first_wavefront(world, ro_s, rd_s, hits0, key, 0, 1, ro_s.shape[0],
                                          bounces, True, tile_base)
        pix = torch.arange(pack.shape[0], device=dev)
        for b in range(1, bounces):
            pack, pix = TM.sort_wavefront(pack, pix, lo, hi)
            lists, unit = TM.bounce_lists(world, margin, pack, ray_tile)
            u_b = u_flat[:, 4 * b:4 * b + 4][pix]
            yield world, (pack, u_b, lists, unit, ray_tile)
            pack, _ = TM.bounce(pack, u_b, lists, unit, world, ray_tile, True)


def highpoly_frame(dev) -> dict:
    """Kernel 2 over the wavefronts of one frame of the highpoly
    configuration (:func:`highpoly_wavefronts`): each launch timed and held
    to its plain version on its first PLAIN_SLICE rays, and the frame's
    sums."""
    rows = [{**kernel2_timing(world, wf, PLAIN_SLICE)[0], "blocks": world.block_aabb.shape[0]}
            for world, wf in highpoly_wavefronts(dev)]
    return {"ms": sum(r["ms"] for r in rows), "plain_ms": sum(r["plain_ms"] for r in rows),
            "plain_rays": PLAIN_SLICE, "launches_timed": len(rows), "blocks": rows[0]["blocks"],
            "bound_ms": sum(r["bound_ms"] for r in rows), "bound_by": "operations",
            "flops": sum(r["flops"] for r in rows), "bounce_ms": [r["ms"] for r in rows]}


def kernel4_timing(world, w16, prim, u, bounces, parity, use_primary, emit_idx=False,
                   debug=False) -> dict:
    """Kernel 4 on one set of inputs, its plain version (bit-equal to the
    kernel), and the bound: the sweep visits every real triangle for every
    live traced ray-bounce (the plain version's live rays)."""
    import torch

    from pathtracerap_tpu_torch.kernels.megakernel import (
        sample_fused, sample_fused_plain, sweep_operands,
    )

    def kern(debug=False):
        return sample_fused(w16, prim, u, world, bounces, parity, use_primary, emit_idx,
                            debug=debug)

    def plain(live=None):
        return sample_fused_plain(w16, prim, u, world, bounces, parity, use_primary, emit_idx, live)

    outs, live = kern(), []
    plain(live)
    masks = torch.stack(live).reshape(u.shape[0] if u.dim() == 3 else 1, bounces, w16.shape[0])
    traced = int((masks[:, 1:] if use_primary else masks).sum().item())
    _, n_tris = sweep_operands(world)
    n_tris = min(n_tris, world.block_aabb.shape[0] * world.tri_block)
    outs = list(outs) if emit_idx else [outs]
    res = timed("sample_fused", kern, plain, held=lambda k, p: same_bits("B4", k, p),
                rays=w16.shape[0],
                **bound(PAIR_FLOPS * traced * n_tris,
                        nbytes(w16, prim, u, world.ops_tri, world.attr_rows, *outs)))
    if debug:
        res["debug_ms"] = cuda_ms(lambda: kern(True))
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


def kernel4_timings(ref_world, dev) -> dict:
    """Kernel 4 in three modes: the quality render's first slab (one
    jittered sample traced in the kernel, 5 bounces; with its debug form),
    the Cornell render's first batch (8 samples from the primary rows, 4
    bounces) and the Cornell step's emit_idx pass (one sample)."""
    import torch

    from pathtracerap_tpu_torch import build_cornell_box_scene
    from pathtracerap_tpu_torch.bench_suite import suite_configs
    from pathtracerap_tpu_torch.kernels.megakernel import primary_pack
    from pathtracerap_tpu_torch.kernels.trace import ray_vectors, trace_pallas
    from pathtracerap_tpu_torch.ops.math import normalize
    from pathtracerap_tpu_torch.ops.plucker import bake_world_triangles
    from pathtracerap_tpu_torch.ops.rng import chunk_uniforms, prng_key
    from pathtracerap_tpu_torch.render.camera import generate_rays

    res = {"quality_slab": kernel4_timing(ref_world, *quality_slab(dev), MAX_BOUNCES, False, False,
                                          debug=True)}
    world = bake_world_triangles(build_cornell_box_scene().to_device(dev))
    ro, rd = generate_rays(suite_configs()["cornell"]["cfg"]["camera"], CORNELL_RES, device=dev)
    n = ro.shape[0]
    rd_n = normalize(rd)
    hits, idx = trace_pallas(world, ro, rd_n, return_idx=True)
    w16 = ray_vectors(ro, rd_n)
    u = chunk_uniforms(prng_key(0, dev), range(8), CORNELL_BOUNCES, n, n).reshape(
        8, n, 4 * CORNELL_BOUNCES)
    res["cornell_batch"] = kernel4_timing(world, w16, primary_pack(hits), u, CORNELL_BOUNCES, True, True)
    prim = primary_pack(hits, torch.where(hits.t < F_MAX, idx + 1, 0))
    res["emit_idx"] = kernel4_timing(world, w16, prim, u[0], CORNELL_BOUNCES, True, True, emit_idx=True)
    return res


def kernel5_timing(world, w, wo, plain_rows=None, live_rows=False, phantoms_ok=False) -> dict:
    """Kernel 5 with its gate on one wavefront, its plain version on the
    first ``plain_rows`` rays (with ``live_rows`` the first live ones), held
    to it on those rays: unculled, the index on every live ray; culled, on
    99.99 % of them or, with ``phantoms_ok``, different only where the
    plain winner's cluster box lies beyond the ray's slab test (a phantom
    accept of a sliver triangle, which the gate may skip); t within rtol
    1e-5 where the index agrees.  And the bound: the swept pairs' accept
    chains and the gate's box tests (its own counters), or the bytes: the
    rays, the results and counts, the group boxes, and of the cluster boxes
    and runs at least those of the tile that tested and swept most (6
    floats a box; 22 staged floats a triangle, edge rows 0-5 and plane
    rows 0-3)."""
    import torch

    from pathtracerap_tpu_torch.kernels.trace import (
        DENSE_RUN, DENSE_TILE, _cluster_margin, nearest_hit, nearest_hit_plain, slab_reaches,
    )

    n = w.shape[0]
    if live_rows:
        sel = torch.nonzero(wo[:, 4] > 0).flatten()[:plain_rows]
    else:
        sel = torch.arange(min(n, plain_rows or n), device=w.device)
    nt = n // DENSE_TILE
    swept = torch.zeros(nt, dtype=torch.int32, device=w.device)
    tests = torch.zeros((nt, 2), dtype=torch.int32, device=w.device)

    def kern():
        return nearest_hit(w, wo, world.edge_mat, world.plane_mat, world.cluster_aabb, cull=True,
                           n_valid=world.n_valid, swept=swept, group_aabb=world.group_aabb,
                           tests=tests)

    def held(k, p):
        (t_k, i_k), (t_p, i_p), live = (x[sel] for x in k), p, wo[sel, 4] > 0
        _, i_n = nearest_hit(w, wo, world.edge_mat, world.plane_mat, world.cluster_aabb, cull=False,
                             n_valid=world.n_valid, group_aabb=world.group_aabb)
        check(torch.equal(i_n[sel][live], i_p[live]), "B5 unculled: the index on every live ray")
        differ = torch.nonzero(live & (i_k != i_p)).flatten()
        if phantoms_ok:
            box = world.cluster_aabb[:6, i_p[differ].long() // DENSE_RUN]
            reach = slab_reaches(box, wo[sel[differ], 0:3], w[sel[differ], 0:3],
                                 _cluster_margin(world.cluster_aabb),
                                 torch.full((differ.numel(),), float("inf"), device=w.device))
            check(not reach.diagonal().any(), "B5 culled: different only on phantom accepts")
        else:
            check(differ.numel() <= 1e-4 * live.sum().item(), f"B5 culled: {differ.numel()} rays differ")
        rel = ((t_k - t_p).abs() / t_p.abs().clamp_min(1e-30))[live & (i_k == i_p) & (i_p >= 0)]
        check(rel.numel() == 0 or rel.max().item() <= 1e-5, "B5: t within rtol 1e-5")

    outs = kern()
    live_tile = (wo[:, 4] > 0).reshape(-1, DENSE_TILE).sum(dim=1).long()
    pairs = int((swept.long() * live_tile).sum().item()) * DENSE_RUN
    gate_tests = int((tests.long() * live_tile[:, None]).sum().item())
    read = (int(tests[:, 1].max().item()) * 6 + int(swept.max().item()) * DENSE_RUN * 22) * 4
    return timed("nearest_hit", kern,
                 lambda: nearest_hit_plain(w[sel], wo[sel], world.edge_mat, world.plane_mat,
                                           world.n_valid),
                 3 if plain_rows else 10, held, rays=n, live=int((live_tile).sum().item()),
                 plain_rays=sel.numel(), gate_tests=gate_tests,
                 **bound(PAIR_FLOPS * pairs + GATE_FLOPS * gate_tests,
                         nbytes(w, wo, world.group_aabb[:6], *outs, swept, tests) + read))


def beyond_wavefronts(world, dev) -> dict:
    """The wavefronts kernel 5 traces on the 2,163,864-triangle world (no
    fused pack; ``world`` its bake) by name, as (origins, directions, alive
    or None): the 512x512 primaries and the bounce-1 wavefront the
    per-bounce engine traces next (unsorted, dead rays in place) of the
    suite's room camera and of INSIDE_CAMERA, and the room camera's
    bounce 2 (few live rays)."""
    from pathtracerap_tpu_torch.bench_suite import _ROOM_CAMERA, INSIDE_CAMERA
    from pathtracerap_tpu_torch.kernels.trace import trace_pallas
    from pathtracerap_tpu_torch.ops.rng import chunk_uniforms, prng_key
    from pathtracerap_tpu_torch.render.camera import generate_rays
    from pathtracerap_tpu_torch.render.shade import RayState, shade

    res = {}
    for tag, cam in (("", _ROOM_CAMERA), ("inside_", INSIDE_CAMERA)):
        ro, rd = generate_rays(cam, BEYOND_RES, device=dev)
        u = chunk_uniforms(prng_key(0, dev), 0, BEYOND_BOUNCES, ro.shape[0], ro.shape[0])
        res[tag + "primary"] = (ro, rd, None)
        st = shade(RayState.primary(ro, rd, BEYOND_BOUNCES), trace_pallas(world, ro, rd), u[:, 0:4])
        res[tag + "bounce1"] = (st.orig, st.dir, st.remaining > 0)
        if not tag:
            st = shade(st, trace_pallas(world, st.orig, st.dir, alive=st.remaining > 0), u[:, 4:8])
            res["bounce2"] = (st.orig, st.dir, st.remaining > 0)
    return res


def kernel5_timings(big_scene, dev) -> dict:
    """Kernel 5 on :func:`beyond_wavefronts` (phantom accepts allowed from
    inside), on the room camera's bounce 2 with no ray live, and on the
    reference scene baked without a pack at 1000x800."""
    import torch

    from pathtracerap_tpu_torch import CameraConfig, build_reference_scene
    from pathtracerap_tpu_torch.kernels.trace import dense_inputs, nearest_hit
    from pathtracerap_tpu_torch.ops.plucker import bake_world_triangles
    from pathtracerap_tpu_torch.render.camera import generate_rays

    world = bake_world_triangles(big_scene)
    waves = beyond_wavefronts(world, dev)
    res = {name: kernel5_timing(world, *dense_inputs(o, d, alive), PLAIN_SLICE, name == "bounce2",
                                name.startswith("inside"))
           for name, (o, d, alive) in waves.items()}
    # no live ray: the rays in, the misses out
    w, wo = dense_inputs(waves["bounce2"][0], waves["bounce2"][1], torch.zeros_like(waves["bounce2"][2]))
    res["dead"] = timed(
        "nearest_hit", lambda: nearest_hit(w, wo, world.edge_mat, world.plane_mat, world.cluster_aabb,
                                           n_valid=world.n_valid, group_aabb=world.group_aabb),
        held=lambda k, _: check(bool((k[0] == F_MAX).all() and (k[1] == -1).all()),
                                "B5 writes misses on a dead wavefront"),
        **bound(0.0, nbytes(w, wo) + w.shape[0] * 8))
    del world
    ref = bake_world_triangles(build_reference_scene().to_device(dev), fused_tile=None)
    ro, rd = generate_rays(CameraConfig(), RESOLUTION, device=dev)
    res["reference_nopack"] = kernel5_timing(ref, *dense_inputs(ro, rd))
    return res


def g1_held(what: str, got, want) -> None:
    """G1's record and counters bit for bit against its plain version's
    (each a (record, counters) pair)."""
    (rec, stats), (p_rec, p_stats) = got, want
    same_bits(what, [getattr(rec, f) for f in HIT_FIELDS] + [stats[k] for k in HIT_STATS],
              [getattr(p_rec, f) for f in HIT_FIELDS] + [p_stats[k] for k in HIT_STATS])


def g1_timings(dev) -> dict:
    """Kernel G1 on the 1000x800 primary and bounce-1 wavefronts (the
    parity render's uniforms and liveness mask; bounce 1 also with every
    ray traced), its plain version on 65,536 rays across each (record and
    counters bit-equal to the kernel's on them), the bound from the
    kernel's own counters on the live rays (tri_tests x MT_FLOPS + steps x
    DDA_STEP_FLOPS, or the bytes read and written), the gather of the
    hit's material in the wrapper as a library call; and its global-memory
    form on HIGHPOLY_RAYS rays at the highpoly blob."""
    import numpy as np
    import torch

    from pathtracerap_tpu_torch import CameraConfig, build_reference_scene
    from pathtracerap_tpu_torch.kernels import _build
    from pathtracerap_tpu_torch.kernels import dda as DD
    from pathtracerap_tpu_torch.ops.intersect import trace_parity
    from pathtracerap_tpu_torch.ops.rng import chunk_uniforms, prng_key
    from pathtracerap_tpu_torch.render.camera import generate_rays
    from pathtracerap_tpu_torch.render.shade import RayState, shade
    from pathtracerap_tpu_torch.scene.build import SceneBuilder
    from pathtracerap_tpu_torch.scene.types import Material, MaterialType

    scene = build_reference_scene().to_device(dev)
    ro, rd = generate_rays(CameraConfig(), RESOLUTION, device=dev)
    ro, rd = ro.contiguous(), rd.contiguous()
    n = ro.shape[0]
    u = chunk_uniforms(prng_key(0, dev), 0, MAX_BOUNCES, n, n, 0, rng_tile=PARITY_TILE)
    st = shade(RayState.primary(ro, rd, MAX_BOUNCES), DD.grid_trace(scene, ro, rd), u[:, :4])
    tables = DD._scene_args(scene, dev)
    scene_bytes = nbytes(*(tables[k] for k in ("models", "tris", "tri_nrm", "voxel", "vt_tris")))
    pick = torch.arange(0, n, max(1, n // 65536), device=dev)[:65536]
    res = {}
    for name, (o, d, alive) in {"primary": (ro, rd, None),
                                "bounce1": (st.orig.contiguous(), st.dir.contiguous(),
                                            st.remaining > 0)}.items():
        rec, stats = DD.grid_trace(scene, o, d, alive=alive, return_stats=True)
        live = n if alive is None else int(alive.sum().item())
        hit, idx = rec.model >= 0, rec.model.clamp(min=0).long()
        ri = tables["models"][:, 47]  # MODEL_WORDS' index of refraction
        o_s, d_s = o[pick].contiguous(), d[pick].contiguous()
        a_s = None if alive is None else alive[pick]
        # the live rays' origin and direction read once, the mask read, every
        # ray's record written once
        io_bytes = (24 * live + (0 if alive is None else n)
                    + nbytes(rec.t, rec.normal, rec.mat_type, rec.mat_color, rec.mat_ri, rec.model,
                             rec.tri))
        steps, tri_tests = int(stats["steps"].sum().item()), int(stats["tri_tests"].sum().item())
        g1_held(f"G1 {name}", DD.grid_trace(scene, o_s, d_s, alive=a_s, return_stats=True),
                trace_parity(scene, o_s, d_s, True, a_s))
        res[name] = timed(
            "grid_dda", lambda: DD.grid_trace(scene, o, d, alive=alive),
            lambda: trace_parity(scene, o_s, d_s, alive=a_s), 2, rays=n, live_rays=live,
            plain_rays=65536, steps=steps, tri_tests=tri_tests,
            library_ms=cuda_ms(lambda: (
                torch.where(hit, scene.mat_type[idx], 0),
                torch.where(hit[:, None], scene.mat_color[idx], 0.0), torch.where(hit, ri[idx], 1.5))),
            **bound(MT_FLOPS * tri_tests + DDA_STEP_FLOPS * steps, io_bytes + scene_bytes))
        if alive is not None:
            every = torch.ones_like(alive)
            res[name]["all_rays_ms"] = cuda_ms(lambda: DD.grid_trace(scene, o, d, alive=every))

    b = SceneBuilder(grid_dims=(25, 25, 25))
    b.add_instance(b.add_mesh_file(HIGHPOLY_MESH), Material(MaterialType.DIFFUSE, (0.8, 0.3, 0.2)))
    host = b.build()
    big = host.to_device(dev)
    rng = np.random.default_rng(11)
    lo, hi = host.mesh_bbox_min[0], host.mesh_bbox_max[0]
    o = rng.normal(size=(HIGHPOLY_RAYS, 3))
    o = (lo + hi) / 2 + 2.0 * float(np.linalg.norm(hi - lo)) * o / np.linalg.norm(o, axis=1,
                                                                               keepdims=True)
    d = lo + rng.uniform(size=(HIGHPOLY_RAYS, 3)) * (hi - lo) - o
    o, d = (torch.as_tensor(x.astype(np.float32), device=dev).contiguous() for x in (o, d))
    rec, stats = DD.grid_trace(big, o, d, return_stats=True)
    tri_tests, steps = int(stats["tri_tests"].sum().item()), int(stats["steps"].sum().item())
    g1_held("G1 global form", (rec, stats), trace_parity(big, o, d, True))
    res["highpoly_global"] = timed(
        "grid_dda", lambda: DD.grid_trace(big, o, d), lambda: trace_parity(big, o, d), 2,
        rays=HIGHPOLY_RAYS, form=DD.grid_trace_form(big),
        **bound(MT_FLOPS * tri_tests + DDA_STEP_FLOPS * steps,
                24 * HIGHPOLY_RAYS + DD._scene_args(big, dev)["smem_bytes"]))
    res["form"] = DD.grid_trace_form(scene)
    # ptxas's registers, spills and static shared memory of G1's four forms,
    # grid_dda_kernel<shared, coherent>
    res["resources"] = {f"{('global', 'shared')[int(m[1])]}/{('bounce', 'coherent')[int(m[2])]}": v
                        for k, v in _build.kernel_resources().items()
                        if (m := re.search(r"grid_dda_kernelILb([01])ELb([01])E", k))}
    return res


def rng_timings(dev) -> dict:
    """Kernel R1 at the main paths' calls (RNG_CALLS; samples from 2**32 -
    2, so that they wrap, under the largest seed) and its jitter stream,
    its plain twin on the card (both bit-equal to it), the bound
    (RNG_INT_OPS a uniform over the INT32 rate, or the output's bytes),
    registers and SASS counts."""
    from pathtracerap_tpu_torch.kernels import _build
    from pathtracerap_tpu_torch.ops import rng

    key = rng.prng_key(2**32 - 1, dev)
    res = {}
    for name, (ns, n, bounces) in RNG_CALLS.items():
        samples = range(2**32 - 2, 2**32 - 2 + ns)
        u = rng.chunk_uniforms(key, samples, bounces, n, n)
        res[name] = timed(
            "rng", lambda: rng.chunk_uniforms(key, samples, bounces, n, n),
            lambda: rng.chunk_uniforms_plain(key, samples, bounces, n, n),
            held=lambda k, p: (same_bits("R1", k, p), same_bits(
                "R1 jitter", rng.chunk_jitter_uniforms(key, samples[0], n, n),
                rng.chunk_jitter_uniforms_plain(key, samples[0], n, n))), uniforms=u.numel(),
            jitter_ms=cuda_ms(lambda: rng.chunk_jitter_uniforms(key, samples[0], n, n)),
            **bound(0.0, nbytes(u), int_ops=RNG_INT_OPS * u.numel()))
    (kname,) = [m for m in _build.kernel_resources() if "chunk_uniforms_kernelILi4E" in m]
    res["build"] = {**_build.kernel_resources()[kname],
                    "sass": {op: sass_counts(op).get(kname, 0) for op in ("IADD3", "SHF", "LOP3", "STG")}}
    return res


def parts_build(variant: str, k: int, unroll: bool) -> dict:
    """The parts kernel's instantiation for a configuration: its registers,
    spills and static shared memory (``ptxas -v``), the dynamic shared
    memory its launch allows it and its tensor-core instructions in the
    SASS (HMMA: ``mma.sync``; HGMMA: ``wgmma``); ``mm_f32`` takes its
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

    return cuda_ms(run, 3)


def prof_timings(dev) -> dict:
    """P1, P2 and P4 at the scripts' sizes (800,256 rays, tiles of 512, 8
    visits of 2,048 columns), the plain version on the first PLAIN_SLICE
    rays (P4: all; held as the card tests hold them), with torch.matmul
    on the same operands (P1, P2) or the one PyTorch call that computes
    the copy (P4) as the library call; P3 at 512x512 and 131,072x512 (exact
    on its float4 path and on a misaligned x, the strided path), beside an
    empty kernel on its grid (the launch floor) and torch.argmin."""
    import ctypes

    import torch

    from pathtracerap_tpu_torch.kernels import _build
    from pathtracerap_tpu_torch.kernels import prof as KP
    from pathtracerap_tpu_torch.scripts import prof_kernel_parts as P1
    from pathtracerap_tpu_torch.scripts import prof_kernel_parts2 as P2
    from pathtracerap_tpu_torch.scripts import prof_mega_sweep as P4
    from pathtracerap_tpu_torch.scripts.prof_r5_shade import BASES

    sl, out_bytes, res = PLAIN_SLICE, PROF_N * 4, {}
    w, ops, attr = P1.inputs(dev)
    n_bytes = nbytes(w, ops, attr) + out_bytes
    mm = {"bf16": _matmul_alone_ms(w, ops, torch.bfloat16, 1),
          "f32": _matmul_alone_ms(w, ops, torch.float32, 1)}
    for v in P1.VARIANTS:
        res[v] = timed("prof_parts", lambda v=v: P1.run_kernel(v, w, ops, attr),
                       lambda v=v: KP.parts_plain(v, w[:sl], ops, attr, PROF_R, PROF_TB, PROF_NB), 3,
                       lambda k, p, v=v: close_share(v, k, p, 1.0 if v.startswith("mm_") else 0.999),
                       plain_rays=sl, **_prof_bound(v, 16, PROF_N, n_bytes), **parts_build(v, 16, False),
                       matmul_alone_ms=mm["f32"] if v == "mm_f32"
                       else mm["bf16"] * (1 if v == "mm_bf16" else 3))
    del w, ops, attr
    for variant, k in P2.RUNS:
        if variant in ("empty", "mm_bf16"):  # the same launches as P4's and P1's
            continue
        w, ops = P2.inputs(dev, k)
        res[variant] = timed(
            "prof_parts", lambda: P2.run(variant, w, ops),
            lambda: KP.parts_plain("mm_bf16", w[:sl], ops, None, PROF_R, PROF_TB, PROF_NB), 3,
            lambda k, p: close_share(variant, k, p, 1.0), plain_rays=sl,
            **_prof_bound("mm_bf16", k, PROF_N, nbytes(w, ops) + out_bytes),
            **parts_build("mm_bf16", *KP.P2_VARIANTS[variant]),
            matmul_alone_ms=_matmul_alone_ms(w, ops, torch.bfloat16, 1))
        del w, ops
    w, ops = P4.empty_inputs(dev)
    for with_ops in (False, True):
        # a strided read of one 32-byte sector per 64-byte row, the column written
        res["empty_with_ops" if with_ops else "empty"] = timed(
            "prof_empty", lambda with_ops=with_ops: KP.empty(w, PROF_R, ops if with_ops else None),
            lambda: KP.empty_plain(w), held=lambda k, p: same_bits("P4", k, p),
            library_ms=cuda_ms(lambda: w[:, 0].contiguous()),
            **bound(0.0, PROF_N * 32 + out_bytes))
    del w, ops
    lib = _build.library()
    for rows, cols in P3_SHAPES:
        g = torch.Generator(device="cpu").manual_seed(rows)
        x = torch.randn(rows, cols, generator=g).to(dev)
        bases = torch.tensor(BASES, dtype=torch.int32, device=dev)
        xm = torch.empty(rows * cols + 1, device=dev)[1:].view(rows, cols)
        xm.copy_(x)
        stream = torch.cuda.current_stream(dev).cuda_stream
        res[f"argmin_{rows}x{cols}"] = timed(
            "prof_argmin", lambda: KP.argmin_int(x, bases), lambda: KP.argmin_int_plain(x, bases),
            held=lambda k, p: (same_bits("P3", k, p),
                               same_bits("P3 strided", KP.argmin_int(xm, bases), p)),
            strided_path_ms=cuda_ms(lambda: KP.argmin_int(xm, bases)),
            library_ms=cuda_ms(lambda: torch.argmin(x, dim=1)),
            launch_floor_ms=cuda_ms(lambda: _build.check(
                lib.ptt_noop(rows, 32, ctypes.c_void_p(stream)), "ptt_noop")),
            **bound(2.0 * x.numel(), nbytes(x, bases, KP.argmin_int(x, bases))))
    return res


def launches_per_call(dev, big_scene) -> dict:
    """Each kernel's launches over one call of each main path (after one
    call that loads the kernels), the profiling kernels' by configuration
    over the four scripts' main()."""
    import contextlib
    import io

    import torch

    from ptbench import cells, scenes
    from pathtracerap_tpu_torch import (
        CameraConfig, RenderConfig, Renderer, build_cornell_box_scene, build_reference_scene,
    )
    from pathtracerap_tpu_torch.bench_suite import _ROOM_CAMERA, run_config, suite_configs
    from pathtracerap_tpu_torch.diff import extract_params, make_train_step
    from pathtracerap_tpu_torch.kernels import prof as KP
    from pathtracerap_tpu_torch.ops.rng import prng_key
    from pathtracerap_tpu_torch.render.debug_viz import render_aovs
    from pathtracerap_tpu_torch.render.wavefront import render_accumulate
    from pathtracerap_tpu_torch.scripts import (
        prof_kernel_parts, prof_kernel_parts2, prof_mega_sweep, prof_r5_shade,
    )

    ref = build_reference_scene().to_device(dev)
    cornell = build_cornell_box_scene().to_device(dev)
    key = prng_key(0, dev)

    def render(scene, res, spp, bounces, **kw):
        cfg = RenderConfig(resolution=res, samples_per_pixel=spp, max_bounces=bounces, **kw)
        return Renderer(scene, cfg, device=dev).render

    def step(scene, camera, res, spp, bounces, **kw):
        fn = make_train_step(scene, camera, res, spp, bounces, **kw)
        params = extract_params(scene, ("mat_color",))
        target = torch.zeros((res[0] * res[1], 3), device=dev)
        return lambda: fn(params, target, key)

    cornell_cam = suite_configs()["cornell"]["cfg"]["camera"]
    paths = {
        "reference_render": render(ref, RESOLUTION, SPP, MAX_BOUNCES, engine="fused"),
        "reference_step": step(ref, CameraConfig(), RESOLUTION, TRAIN_SPP, MAX_BOUNCES,
                               tile_size=8192, engine="fused"),
        "quality_render": render(ref, RESOLUTION, SPP, MAX_BOUNCES, engine="fused", parity=False,
                                 camera=CameraConfig(jitter=True)),
        "cornell_render": render(cornell, CORNELL_RES, CORNELL_SPP, CORNELL_BOUNCES,
                                 engine="fused", camera=cornell_cam),
        "cornell_step": step(cornell, cornell_cam, CORNELL_RES, TRAIN_SPP, CORNELL_BOUNCES,
                             engine="fused"),
        "cornell_default_step": step(cornell, cornell_cam, CORNELL_RES, TRAIN_SPP, CORNELL_BOUNCES),
        "beyond_render": render(big_scene, BEYOND_RES, BEYOND_SPP, BEYOND_BOUNCES, engine="fused",
                                camera=_ROOM_CAMERA),
        "beyond_step": step(big_scene, _ROOM_CAMERA, BEYOND_TRAIN_RES, BEYOND_TRAIN_SPP,
                            BEYOND_TRAIN_BOUNCES, engine="fused"),
        "megascene_run_config": lambda: run_config("megascene", device=dev),
        "parity_render": lambda: render_accumulate(ref, key, CameraConfig(), RESOLUTION, PARITY_SPP,
                                                   MAX_BOUNCES, engine="parity", tile_size=PARITY_TILE),
        "parity_step": step(ref, CameraConfig(), RESOLUTION, PARITY_SPP, MAX_BOUNCES,
                            tile_size=PARITY_TILE, engine="parity"),
        "render_aovs": lambda: render_aovs(ref, RenderConfig(resolution=RESOLUTION, engine="parity")),
        "gridparity_run_config": lambda: run_config("gridparity", device=dev),
    }
    with open(HIGHPOLY_CONFIG) as f:
        hp = json.load(f)
    paths["highpoly_frame"] = render(scenes.port_scene(scenes.scene_inputs(hp)).to_device(dev),
                                     tuple(hp["resolution"]), 1, hp["max_bounces"],
                                     camera=cells.camera(hp), engine=hp["engine"])
    ws, out = wrappers(), {}
    for name, fn in paths.items():
        fn()
        before = {k: w.launches for k, w in ws.items()}
        fn()
        out[name] = {k: w.launches - before[k] for k, w in ws.items() if w.launches > before[k]}
    KP.parts.variant_launches.clear()
    KP.empty.variant_launches.clear()
    before = ws["prof_argmin"].launches
    with contextlib.redirect_stdout(io.StringIO()):
        for mod in (prof_kernel_parts, prof_kernel_parts2, prof_r5_shade, prof_mega_sweep):
            mod.main()
    out["prof_scripts"] = {
        "parts": {f"{v}/K={k}{'/unrolled' if u else ''}": c
                  for (v, k, u), c in KP.parts.variant_launches.items()},
        "empty": {("with_ops" if o else "without_ops"): c
                  for o, c in KP.empty.variant_launches.items()},
        "argmin_int": ws["prof_argmin"].launches - before}
    return out


_T0 = time.perf_counter()


def phase(name: str, res: dict) -> None:
    """Print a phase's result, with the seconds since the script started."""
    print(f"{name}: {json.dumps({**res, 'at_s': time.perf_counter() - _T0})}", flush=True)


def card_tests() -> dict:
    """The card check: CARD_TESTS under ``pytest --noconftest -m cuda`` in
    a process of their own; a failure prints their report and raises."""
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "pytest", "--noconftest", "-m", "cuda", "-q",
                          "-p", "no:cacheprovider", *CARD_TESTS], cwd=ROOT, capture_output=True,
                         text=True)
    summary = (run.stdout.strip().splitlines() or [""])[-1]
    if run.returncode:
        print(run.stdout[-20000:], run.stderr[-4000:], file=sys.stderr)
    check(run.returncode == 0, f"the card tests: {summary}")
    return {"files": CARD_TESTS, "summary": summary, "seconds": time.perf_counter() - t0}


def build() -> dict:
    """nvcc on every kernel beside g++ on the native host library: the
    seconds, the native library's state and ptxas's lines."""
    from pathtracerap_tpu_torch import native
    from pathtracerap_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    host = threading.Thread(target=native.get_lib)  # g++ beside the nvcc processes
    host.start()
    _build.library()
    host.join()
    return {"seconds": time.perf_counter() - t0, "native_ok": native.available(),
            "native_library": os.path.relpath(native.library_path(), ROOT),
            "native_error": native.build_error,
            "ptxas": [ln.strip() for ln in _build.build_log().splitlines()
                      if "registers" in ln or "Compiling entry" in ln]}


def entry(name: str, source: str, replaces: str, launches, k: dict, **extra) -> dict:
    """One kernel's line: its device ms, its plain version's and its bound,
    then the rest of its reading ``k`` and ``extra``."""
    return {"name": name, "route": "cuda", "source": f"pathtracerap_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches, "ms": k["ms"], "plain_ms": k["plain_ms"],
            "plain_rays": k.get("plain_rays"), "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            # no one PyTorch call computes a nearest hit, nor a profiling
            # kernel's product together with its min or accept chain
            "library_ms": k.get("library_ms"), **k, **extra}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from pathtracerap_tpu_torch import build_cornell_box_scene, build_reference_scene
    from pathtracerap_tpu_torch.bench_suite import (
        _ROOM_CAMERA, INSIDE_CAMERA, build_highpoly_scene, suite_configs,
    )
    from pathtracerap_tpu_torch.kernels.megakernel import (
        BOUNCE_RAYS_PER_THREAD, BOUNCE_TRACE_RAYS_PER_THREAD,
    )
    from pathtracerap_tpu_torch.kernels.prof import P1_VARIANTS, P2_VARIANTS
    from pathtracerap_tpu_torch.kernels.trace import DENSE_RAYS, TRACE_LIST_CHUNK, TRACE_LIST_RAYS
    from pathtracerap_tpu_torch.ops.plucker import bake_world_triangles

    # the plain versions run on the card: full f32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    phase("environment", {
        "python": sys.version.split()[0], "torch": torch.__version__, "cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
        "card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], capture_output=True, text=True,
                               check=True).stdout.strip().splitlines()[0],
    })
    phase("build", build())
    phase("card_tests", card_tests())

    def resources(mangled, rays_per_thread):
        """Rays a thread sweeps, and the fast form's registers and spills."""
        return {"rays_per_thread": rays_per_thread,
                **{k: ptxas(mangled)[k] for k in ("registers", "spill_stores", "spill_loads")}}

    world = bake_world_triangles(build_reference_scene().to_device(dev))
    b1 = {"slab": kernel1_timing(world, dev, rays=slice(SLAB)),
          "frame": kernel1_timing(world, dev, debug=True),
          "cornell": kernel1_timing(
              bake_world_triangles(build_cornell_box_scene().to_device(dev)), dev,
              suite_configs()["cornell"]["cfg"]["camera"], CORNELL_RES)}
    wavefront = bounce1_wavefront(world, dev)
    b2, _ = kernel2_timing(world, wavefront, debug=True)
    b2_highpoly = highpoly_frame(dev)
    b3 = kernel3_timing(world, wavefront)
    del wavefront
    s1 = defer_shade_timing(world, dev)
    b4 = kernel4_timings(world, dev)
    big = build_highpoly_scene(subdiv=BEYOND_SUBDIV, use_asset=False).to_device(dev)
    b5 = kernel5_timings(big, dev)
    torch.cuda.empty_cache()
    mega = bake_world_triangles(suite_configs()["megascene"]["scene"]().to_device(dev))
    mres, mbounces = (512, 512), 6
    b6 = {f"slab{k}": kernel1_timing(mega, dev, _ROOM_CAMERA, mres, slice(k * SLAB, (k + 1) * SLAB),
                                     PLAIN_SLICE) for k in range(2)}
    b6["frame"] = kernel1_timing(mega, dev, _ROOM_CAMERA, mres, plain_rows=PLAIN_SLICE)
    b6["inside"] = kernel1_timing(mega, dev, INSIDE_CAMERA, mres, plain_rows=PLAIN_SLICE)
    b6["bounce"], _ = kernel2_timing(mega, bounce1_wavefront(mega, dev, _ROOM_CAMERA, mres, mbounces),
                                     PLAIN_SLICE)
    b6["bounce_inside"], _ = kernel2_timing(
        mega, bounce1_wavefront(mega, dev, INSIDE_CAMERA, mres, mbounces), PLAIN_SLICE)
    del mega
    g1 = g1_timings(dev)
    r1 = rng_timings(dev)
    pk = prof_timings(dev)
    torch.cuda.empty_cache()
    launches = launches_per_call(dev, big)
    del big
    phase("launches", launches)

    def main_launches(kernel, *paths):
        return {p: launches[p].get(kernel, 0) for p in paths}

    kernels = [
        entry("trace_list", "trace_list.cu", PALLAS + "trace.py:188",
              main_launches("trace_list", "reference_render", "reference_step",
                            "cornell_default_step"), b1["slab"],
              frame=b1["frame"], cornell=b1["cornell"], chunk=TRACE_LIST_CHUNK,
              **resources("_Z17trace_list_kernelILb0E", TRACE_LIST_RAYS)),
        entry("bounce", "bounce.cu", PALLAS + "megakernel.py:1666",
              main_launches("bounce", "reference_render", "highpoly_frame"), b2,
              highpoly_frame=b2_highpoly, **resources("_Z13bounce_kernelILb0E", BOUNCE_RAYS_PER_THREAD)),
        entry("bounce_trace", "bounce_trace.cu", PALLAS + "megakernel.py:1846",
              main_launches("bounce_trace", "reference_step"), b3,
              **resources("_Z19bounce_trace_kernel", BOUNCE_TRACE_RAYS_PER_THREAD)),
        entry("megakernel", "megakernel.cu", PALLAS + "megakernel.py:1206",
              main_launches("sample_fused", "quality_render", "cornell_render", "cornell_step"),
              b4["quality_slab"], cornell_batch=b4["cornell_batch"], emit_idx=b4["emit_idx"],
              **resources("_Z19sample_fused_kernelILb0E", 1)),
        entry("nearest_hit", "nearest_hit.cu", PALLAS + "trace.py:54",
              main_launches("nearest_hit", "beyond_render", "beyond_step"), b5["bounce1"],
              **{k: v for k, v in b5.items() if k != "bounce1"},
              **resources("_Z18nearest_hit_kernel", DENSE_RAYS)),
        # the TPU kernels' streamed modes, at the megascene's 701 blocks
        entry("trace_list_701_blocks", "trace_list.cu", PALLAS + "trace.py:222",
              main_launches("trace_list", "megascene_run_config"), b6["slab0"],
              slab1=b6["slab1"], frame=b6["frame"], inside=b6["inside"]),
        entry("bounce_701_blocks", "bounce.cu", PALLAS + "megakernel.py:954",
              main_launches("bounce", "megascene_run_config"), b6["bounce"],
              inside=b6["bounce_inside"]),
    ]
    # the profiling kernels: their path is the scripts' main()
    parts, empties = launches["prof_scripts"]["parts"], launches["prof_scripts"]["empty"]
    for v in P1_VARIANTS:
        kernels.append(entry(f"prof_parts:{v}", "prof_parts.cu", "scripts/prof_kernel_parts.py:35",
                             parts.get(f"{v}/K=16", 0), pk[v]))
    for v, (k, unroll) in P2_VARIANTS.items():
        if v != "mm_bf16":  # P2's mm_bf16 is the same launch as P1's
            kernels.append(entry(f"prof_parts:{v}", "prof_parts.cu", "scripts/prof_kernel_parts2.py:33",
                                 parts.get(f"mm_bf16/K={k}{'/unrolled' if unroll else ''}", 0),
                                 pk[v]))
    kernels.append(entry("prof_parts:empty", "prof_parts.cu",
                         "scripts/prof_kernel_parts2.py:33, scripts/prof_mega_sweep.py:30",
                         empties.get("without_ops", 0), pk["empty"]))
    kernels.append(entry("prof_parts:empty_with_ops", "prof_parts.cu",
                         "scripts/prof_mega_sweep.py:30", empties.get("with_ops", 0),
                         pk["empty_with_ops"]))
    kernels.append(entry("prof_argmin", "prof_argmin.cu", "scripts/prof_r5_shade.py:96",
                         launches["prof_scripts"]["argmin_int"], pk["argmin_512x512"],
                         rows131072=pk["argmin_131072x512"]))
    # G1 and R1 have no Pallas counterpart: JAX's grid trace and its
    # jax.random draws are XLA
    kernels.append(entry("grid_dda", "grid_dda.cu",
                         "pathtracerap_tpu/ops/intersect.py:276 (XLA; no pallas_call)",
                         main_launches("grid_dda", "parity_render", "parity_step", "render_aovs",
                                       "gridparity_run_config"), g1["primary"],
                         bounce1=g1["bounce1"], highpoly_global=g1["highpoly_global"],
                         form=g1["form"], resources=g1["resources"]))
    kernels.append(entry("rng", "rng.cu",
                         "pathtracerap_tpu/pallas/megakernel.py:1500 (jax.random; no pallas_call)",
                         main_launches("rng", "cornell_render", "reference_step",
                                       "reference_render", "quality_render"), r1["cornell"],
                         reference_step=r1["reference_step"], int_ops_per_uniform=RNG_INT_OPS,
                         **r1["build"]))
    # S1 has no Pallas counterpart: JAX shades these bounces in XLA
    kernels.append(entry("defer_shade", "defer_shade.cu",
                         "pathtracerap_tpu/pallas/megakernel.py:1957 (XLA; no pallas_call)",
                         main_launches("defer_shade", "reference_step", "reference_render",
                                       "highpoly_frame"), s1, primary=s1["primary"],
                         deferred_form=resources("defer_shade_kernel", 1),
                         primary_form=resources("primary_shade_kernel", 1)))
    for k in kernels:
        check(k["ms"] >= k["bound_ms"], f"{k['name']}: {k['ms']} ms not below its bound {k['bound_ms']}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
