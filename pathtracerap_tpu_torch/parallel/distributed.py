"""Multi-process entry points and the scaling-efficiency harness (port of
``pathtracerap_tpu/parallel/distributed.py``).

JAX joins host processes with ``jax.distributed.initialize`` and then runs
one program over the global device list.  The port runs one process per
card under ``torch.distributed``:

* every process calls :func:`init_distributed` first; it reads torchrun's
  variables (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``)
  where JAX reads ``JAX_COORDINATOR_ADDRESS`` and friends, and does nothing
  in a single-process run;
* the backend is chosen from the machine, with no knob: ``nccl`` when every
  rank has a card of its own, ``gloo`` on the CPU or when ranks share one
  card (NCCL refuses two ranks on one device);
* a rank renders on ``cuda:{LOCAL_RANK % device_count}``
  (:func:`.sharding.rank_device`); rank 0 alone writes files and prints.

:func:`scaling_report` times the data-parallel render at 1, 2, 4, ...
ranks on a fixed image (strong scaling), each count on a subgroup of the
first ranks while the others wait at a barrier.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional

import torch
import torch.distributed as dist

from ..config import RenderConfig
from ..scene.types import SceneDevice
from ..utils.profiling import sync_device
from .sharding import default_mesh, rank_device, render_image_dp


def choose_backend(device, local_processes: int) -> str:
    """``nccl`` when ``device`` is a card and this host has one for each of
    its ``local_processes``; else ``gloo``."""
    if torch.device(device).type != "cuda":
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= local_processes else "gloo"


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
) -> dict:
    """Join the process group (``init_process_group`` with
    ``init_method=f"tcp://{coordinator_address}"``); no-op for a
    single-process run or where the group already exists.

    Arguments default to torchrun's variables: ``MASTER_ADDR:MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK``.  ``device`` is the one this process renders
    on (default :func:`.sharding.rank_device`, the card); it and
    ``LOCAL_WORLD_SIZE`` (default: every process on this host) choose the
    backend.  Returns JAX's summary keys; each process drives one device."""
    if coordinator_address is None and os.environ.get("MASTER_ADDR") and os.environ.get(
            "MASTER_PORT"):
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if num_processes is None and os.environ.get("WORLD_SIZE"):
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and os.environ.get("RANK"):
        process_id = int(os.environ["RANK"])

    multi = coordinator_address is not None or (num_processes or 0) > 1
    if multi and not dist.is_initialized():
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError("a multi-process run needs the coordinator address, the number "
                             "of processes and this process's id")
        device = rank_device() if device is None else torch.device(device)
        local = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
        backend = choose_backend(device, local)
        if backend == "nccl":
            torch.cuda.set_device(device)
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    initialized = dist.is_available() and dist.is_initialized()
    count = dist.get_world_size() if initialized else 1
    return {
        "process_index": dist.get_rank() if initialized else 0,
        "process_count": count,
        "local_devices": 1,
        "global_devices": count,
        "initialized_multiprocess": bool(multi),
    }


def _pow2_counts(n_max: int) -> List[int]:
    out, n = [], 1
    while n <= n_max:
        out.append(n)
        n *= 2
    return out


# Link rates of the card's interconnects, from NVIDIA's spec sheets: NVLink 4
# on an H100 SXM (900 GB/s both directions together) and one 400 Gb/s
# InfiniBand NDR port a card, as in DGX H100.  Assumptions, not measurements.
NVLINK_GB_S = 450.0
IB_NDR_GB_S = 50.0


def comm_model(
    resolution,
    n_devices: int,
    samples_per_pixel: int = 1,
    max_bounces: int = 5,
    param_bytes: int = 0,
    world_triangles: int = 0,
    ring_trace_calls_per_device: int = 0,
    nvlink_gb_s: float = NVLINK_GB_S,
    ib_gb_s: float = IB_NDR_GB_S,
) -> dict:
    """Analytic per-step communication volume, bytes **per device** for one
    full render or train step, with the ring collective costs
    ``2 (n-1)/n * payload`` (all-reduce) and ``(n-1)/n * payload``
    (all-gather).  The byte counts are JAX's (``distributed.py:84-147``):

    * **DP render**: one merge of the W*H*3 f32 image (it does not grow
      with spp or bounces);
    * **DP train step**: one gradient all-reduce of ``param_bytes``;
    * **geometry ring**: per trace call each device passes its share of the
      JAX package's 256-byte-a-triangle fused pack ``n - 1`` hops.

    The times put those bytes over the card's links: NVLink 4 within a
    host, a 400 Gb/s InfiniBand NDR port between hosts.  Both rates are
    spec-sheet assumptions, stated in the result, not measurements."""
    w, h = resolution
    n = max(n_devices, 1)
    ring = (n - 1) / n if n > 1 else 0.0
    image_bytes = w * h * 3 * 4
    dp_render = 2.0 * ring * image_bytes
    dp_train = 2.0 * ring * param_bytes
    shard_pack = 256.0 * world_triangles / n
    ring_bytes = (n - 1) * shard_pack * ring_trace_calls_per_device

    def times(bytes_):
        return {
            "bytes_per_device": int(bytes_),
            "nvlink_ms": round(bytes_ / (nvlink_gb_s * 1e9) * 1e3, 4),
            "ib_ms": round(bytes_ / (ib_gb_s * 1e9) * 1e3, 4),
        }

    return {
        "assumptions": {
            "nvlink_gb_s": nvlink_gb_s,
            "ib_gb_s": ib_gb_s,
            "source": "spec sheets (NVLink 4 per direction on H100 SXM; one 400 Gb/s "
                      "InfiniBand NDR port), not measured",
            "collective": "ring all-reduce 2(n-1)/n, ring pass (n-1) hops",
        },
        "n_devices": n,
        "dp_render_image_allreduce": times(dp_render),
        "dp_train_grad_allreduce": times(dp_train),
        "geometry_ring_pack_rotation": times(ring_bytes),
    }


def scaling_report(
    scene: SceneDevice,
    config: RenderConfig,
    device_counts: Optional[List[int]] = None,
    seed: int = 0,
    repeats: int = 2,
) -> dict:
    """Strong-scaling efficiency of the data-parallel render:
    efficiency(n) = (throughput(n) / throughput(1)) / n, the image split
    over the first n ranks (a subgroup) while the others wait.  Every rank
    calls it and gets rank 0's rows."""
    world = default_mesh(scene.device)
    if device_counts is None:
        device_counts = _pow2_counts(world.world_size)
    w, h = config.resolution
    rays = w * h * config.samples_per_pixel * config.max_bounces
    rows, t1 = [], None
    for n in device_counts:
        group = dist.new_group(ranks=list(range(n))) if world.world_size > 1 else None
        if world.rank < n:
            mesh = default_mesh(scene.device, group)
            render_image_dp(scene, config, mesh=mesh, seed=seed)  # warm-up
            best = float("inf")
            for _ in range(repeats):
                if group is not None:
                    dist.barrier(group)
                sync_device(scene.device)
                t0 = time.perf_counter()
                render_image_dp(scene, config, mesh=mesh, seed=seed)
                sync_device(scene.device)
                best = min(best, time.perf_counter() - t0)
            thr = rays / best / 1e6
            t1 = thr if t1 is None else t1
            rows.append({
                "devices": n,
                "wall_s": round(best, 4),
                "mrays_per_s": round(thr, 2),
                "speedup": round(thr / t1, 3),
                "efficiency": round(thr / t1 / n, 4),
            })
        if world.world_size > 1:
            dist.barrier()
    if world.world_size > 1:
        box = [rows]
        dist.broadcast_object_list(box, src=0)
        rows = box[0]
    dev = scene.device
    return {
        "backend": world.backend or "none",
        "device_kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "process_count": world.world_size,
        "rows": rows,
    }
