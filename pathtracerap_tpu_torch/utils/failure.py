"""Failure detection, elastic recovery and fault injection (port of
``pathtracerap_tpu/utils/failure.py``).

The reference has none of this: it is a single process whose CUDA error
codes are assigned and never checked (``Renderer.cpp:578,590,605``), and a
crash at iteration 499/500 loses the whole render.  This module supplies:

* **Heartbeats** -- each host process writes a tiny JSON heartbeat file
  with atomic renames at iteration boundaries; a monitor flags peers whose
  heartbeat goes stale.
* **Elastic recovery loop** -- :func:`run_with_recovery` drives a chunked
  render/train loop through the checkpoint layer: every chunk is
  checkpointed atomically, any exception reloads the last checkpoint and
  retries, and because the sample RNG is stateless and counter-based, a
  resumed run is bit-identical to an unbroken one.
* **Collective liveness** -- :func:`liveness_probe` all-reduces a ones
  tensor over a ``torch.distributed`` group (the port's counterpart of
  JAX's ``shard_map`` psum over the device mesh) and returns how many
  ranks answered.
* **Fault injection** -- :class:`FaultInjector` deterministically raises at
  a chosen chunk (or via ``PTAP_FAULT_INJECT_AT``) so the recovery path is
  itself testable.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .checkpoint import RenderCheckpoint, load_checkpoint, save_checkpoint

# ------------------------------------------------------------------ heartbeat


@dataclasses.dataclass
class Heartbeat:
    """Atomic heartbeat writer for one host process."""

    directory: str
    host_id: int = 0

    def path(self, host_id: Optional[int] = None) -> str:
        hid = self.host_id if host_id is None else host_id
        return os.path.join(self.directory, f"heartbeat_{hid}.json")

    def beat(self, iteration: int, extra: Optional[dict] = None) -> None:
        os.makedirs(self.directory, exist_ok=True)
        payload = {"ts": time.time(), "iteration": int(iteration),
                   "host_id": self.host_id}
        if extra:
            payload.update(extra)
        fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".hb.tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, self.path())
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def read(self, host_id: int) -> Optional[dict]:
        p = self.path(host_id)
        if not os.path.exists(p):
            return None
        try:
            with open(p) as f:
                return json.load(f)
        except (json.JSONDecodeError, OSError):
            return None  # torn read of a non-atomic writer; treat as absent

    def stale_hosts(self, host_ids, timeout_s: float,
                    now: Optional[float] = None) -> List[int]:
        """Hosts whose heartbeat is missing or older than ``timeout_s``."""
        now = time.time() if now is None else now
        stale = []
        for hid in host_ids:
            hb = self.read(hid)
            if hb is None or (now - hb["ts"]) > timeout_s:
                stale.append(hid)
        return stale


# ------------------------------------------------------- collective liveness


def liveness_probe(group=None) -> int:
    """All-reduce a ones tensor over ``group`` (default: the default
    process group); returns the number of ranks that answered, 1 without an
    initialized group.  With a hung peer the collective blocks: run it
    under a caller-side deadline.  Under ``gloo`` the tensor lies on the
    host, under ``nccl`` on this rank's card."""
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    device = "cpu" if dist.get_backend(group) == "gloo" else torch.device(
        "cuda", torch.cuda.current_device())
    ones = torch.ones(1, device=device)
    dist.all_reduce(ones, op=dist.ReduceOp.SUM, group=group)
    return int(ones.item())


# --------------------------------------------------------------- fault inject


class InjectedFault(RuntimeError):
    """Raised by :class:`FaultInjector` -- distinguishable from real faults."""


class FaultInjector:
    """Deterministically fail at chunk ``fail_at`` (once).

    ``fail_at`` defaults to the ``PTAP_FAULT_INJECT_AT`` env var (-1 =
    disabled).  ``maybe_fail(chunk)`` raises the first time the chunk index
    reaches the trigger; subsequent calls pass, modeling a transient fault
    healed by restart.
    """

    def __init__(self, fail_at: Optional[int] = None):
        if fail_at is None:
            fail_at = int(os.environ.get("PTAP_FAULT_INJECT_AT", "-1"))
        self.fail_at = fail_at
        self.fired = False

    def maybe_fail(self, chunk: int) -> None:
        if not self.fired and self.fail_at >= 0 and chunk >= self.fail_at:
            self.fired = True
            raise InjectedFault(f"injected fault at chunk {chunk}")


# ----------------------------------------------------------- recovery driver


def run_with_recovery(
    step_chunk: Callable[[np.ndarray, int, int], np.ndarray],
    *,
    total_samples: int,
    chunk_samples: int,
    accum_shape,
    seed: int,
    config: dict,
    checkpoint_path: str,
    max_restarts: int = 3,
    heartbeat: Optional[Heartbeat] = None,
    injector: Optional[FaultInjector] = None,
    on_restart: Optional[Callable[[int, BaseException], None]] = None,
) -> Dict[str, object]:
    """Drive ``step_chunk(accum, samples_done, n_samples) -> accum`` to
    ``total_samples``, checkpointing each chunk and restarting from the
    last checkpoint on failure.

    Returns ``{"accum", "samples_done", "restarts"}``.  Because chunks are
    keyed by ``samples_done`` and the RNG is stateless, the recovered
    accumulation equals an unbroken run exactly.
    """
    restarts = 0
    while True:
        try:
            ckpt = load_checkpoint(checkpoint_path)
            if ckpt is not None and ckpt.config == config:
                accum = np.asarray(ckpt.accum)
                done = ckpt.samples_done
            else:
                accum = np.zeros(accum_shape, np.float32)
                done = 0
            chunk_idx = done // max(chunk_samples, 1)
            while done < total_samples:
                n = min(chunk_samples, total_samples - done)
                if injector is not None:
                    injector.maybe_fail(chunk_idx)
                accum = np.asarray(step_chunk(accum, done, n))
                done += n
                chunk_idx += 1
                save_checkpoint(
                    checkpoint_path,
                    RenderCheckpoint(accum=accum, samples_done=done,
                                     seed=seed, config=config),
                )
                if heartbeat is not None:
                    heartbeat.beat(done)
            return {"accum": accum, "samples_done": done, "restarts": restarts}
        except KeyboardInterrupt:
            raise
        except BaseException as e:  # noqa: BLE001 -- recovery layer by design
            restarts += 1
            if on_restart is not None:
                on_restart(restarts, e)
            if restarts > max_restarts:
                raise
