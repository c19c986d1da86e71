"""Checkpoint / resume for long renders and inverse-rendering runs.

A copy of ``pathtracerap_tpu/utils/checkpoint.py`` (NumPy only), kept so
that the port imports nothing of the JAX package; the file format is the
same, so a checkpoint written by either package loads in the other.

The reference has nothing of the kind: its 500-iteration loop runs to
completion or the work is lost, and only the final BMP is persisted
(``Renderer.cpp:41,582``; SURVEY.md section 5).  Here the accumulation
state is tiny — image sum + sample counter + PRNG key (+ optimizer/param
state for inverse rendering) — and is saved with atomic-rename writes every
N sample chunks, so a preempted run resumes exactly (the stateless
counter-based RNG makes resumed samples bit-identical to an unbroken run).
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass
class RenderCheckpoint:
    accum: np.ndarray  # (N, 3) contribution sums
    samples_done: int
    seed: int
    config: dict  # RenderConfig.to_dict() for validation on resume
    extra: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)


def save_checkpoint(path: str, ckpt: RenderCheckpoint) -> None:
    """Atomic write: temp file in the target dir + os.replace."""
    directory = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".ckpt.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(
                f,
                accum=ckpt.accum,
                samples_done=np.int64(ckpt.samples_done),
                seed=np.int64(ckpt.seed),
                config=np.frombuffer(
                    json.dumps(ckpt.config).encode("utf-8"), dtype=np.uint8
                ),
                **{f"extra_{k}": v for k, v in ckpt.extra.items()},
            )
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str) -> Optional[RenderCheckpoint]:
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        extra = {
            k[len("extra_"):]: z[k] for k in z.files if k.startswith("extra_")
        }
        return RenderCheckpoint(
            accum=z["accum"],
            samples_done=int(z["samples_done"]),
            seed=int(z["seed"]),
            config=json.loads(bytes(z["config"]).decode("utf-8")),
            extra=extra,
        )
