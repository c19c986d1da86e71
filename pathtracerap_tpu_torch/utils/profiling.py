"""Profiler hooks (port of ``pathtracerap_tpu/utils/profiling.py``).

* :func:`profile_trace` captures ``torch.profiler`` (CPU activity, and the
  card's CUDA activity when one is present) around a block and writes a
  Chrome/Perfetto trace into a directory;
* :func:`annotate` names a scope: a ``record_function`` range in that trace
  and, while a card is in use, an NVTX range;
* :func:`device_memory_report` gives each card's allocator use and size,
  ``{}`` without a card;
* :func:`sync_device` waits for a card's queued work (nothing on the CPU),
  so that a wall clock read after it holds that work.

JAX's ``enable_compile_cache`` has no counterpart: the port compiles
nothing at run time but its kernels, which ``kernels/_build.py`` caches by
the hash of their sources.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Profile the enclosed block; on exit the trace is written to
    ``log_dir/trace_<ns>.json`` (load it in Perfetto or chrome://tracing).
    Yields the ``torch.profiler.profile`` object (``key_averages()``)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, f"trace_{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named scope visible in profiler traces (and, on the card, in NVTX)."""
    with torch.profiler.record_function(name):
        if torch.cuda.is_initialized():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield


def sync_device(device) -> None:
    """Wait for ``device``'s queued work when it is a card."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_memory_report() -> dict:
    """Per card: the allocator's bytes in use and peak, the card's free and
    total bytes (the cudaMemGetInfo analog).  ``{}`` without a card."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        free, total = torch.cuda.mem_get_info(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": torch.cuda.memory_allocated(i),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(i),
            "bytes_reserved": torch.cuda.memory_reserved(i),
            "bytes_free": free,
            "bytes_limit": total,
        }
    return out
