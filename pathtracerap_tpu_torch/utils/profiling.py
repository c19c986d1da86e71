"""Profiler hooks (port of ``pathtracerap_tpu/utils/profiling.py``).

* :func:`profile_trace` captures ``torch.profiler`` (CPU activity, and the
  card's CUDA activity when one is present) around a block and writes a
  Chrome/Perfetto trace into a directory;
* :func:`annotate` names a span of the program: a ``record_function``
  range while a PyTorch profiler runs, nothing otherwise (see below);
* :func:`device_memory_report` gives each card's allocator use and size,
  ``{}`` without a card;
* :func:`sync_device` waits for a card's queued work (nothing on the CPU),
  so that a wall clock read after it holds that work.

**Spans.**  Tracing is on exactly while a PyTorch profiler runs
(``torch.autograd._profiler_enabled()``): inside ``torch.profiler.profile``,
:func:`profile_trace`, the benchmark's traced window (``python3 -m
ptbench.run --trace 1``) and ``torch.autograd.profiler.emit_nvtx()``.  Then
every span is a host event of the profiler's trace, kept in memory and
written out when the profile ends, on the clock of the card's operations;
under ``emit_nvtx()`` each one is also an NVTX range, for ``nsys``.  Off,
:func:`annotate` costs one check.  Spans, each in the function that does
the work (``ptap.`` is the program's namespace; ``ptbench.`` is the
benchmark's, ``aten::`` PyTorch's):

* ``ptap.render``: ``Renderer.render``, one a frame;
* ``ptap.bake``: ``ops/plucker.py`` ``bake_world_triangles`` (the train
  step bakes inside its loss, one a step);
* ``ptap.rng``: ``ops/rng.py`` ``chunk_uniforms`` and
  ``chunk_jitter_uniforms`` (kernel R1's one launch a call on the card);
* ``ptap.trace_primary``: the engines' primary trace (kernel 1), one a slab;
  ``ptap.trace``: the per-bounce engine's later bounces;
* ``ptap.sort``: the binned engines' wavefront sort (keys, argsort,
  gather), a bounce; ``ptap.worklists``: their per-tile worklists
  (``bounce_lists``), a bounce; ``ptap.bounce``: the binned render's
  kernel 2, a bounce;
* ``ptap.shade``: the per-bounce engine's shading, and the binned engines'
  bounce 0 and deferred bounces;
* ``ptap.accumulate``: the render engines' sum of contributions;
* ``ptap.train.step``: ``make_train_step``'s and
  ``make_sharded_train_step``'s step;
* ``ptap.train.index_forward``: each ``torch.no_grad()`` kernel block of
  the fused diff forward (``diff/fast.py``);
* ``ptap.train.replay``: the fused diff forward's replay of a sample;
* ``ptap.train.backward``: ``value_and_grad``'s ``torch.autograd.grad``.

Spans nest: ``ptap.rng``, ``ptap.sort``, ``ptap.worklists`` and
``ptap.shade`` sit inside ``ptap.train.index_forward`` in a step, and
every train span inside ``ptap.train.step``.

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


_OFF = contextlib.nullcontext()


def annotate(name: str):
    """The span ``name`` around a ``with`` block: a ``record_function``
    range while a PyTorch profiler runs, else a context that does
    nothing."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


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
