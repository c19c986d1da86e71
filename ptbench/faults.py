"""Faults planted in the program's timed path, to show that the check of
``correct`` catches them (``ptbench/tests/test_ptbench_harness.py`` and
``python -m ptbench.calibrate``).

Each is a context manager that patches the program for its duration:

* ``unchanged``: a frame returns the previous frame's image; a train step
  returns the parameters it was given;
* ``half_batch``: a frame renders half its samples and takes their mean;
  a train step's loss is the mean over the first half of the rays;
* ``altered``: a step's loss, or one tile of a frame (its first
  ``TILE`` pixels), is scaled by 1.01 where it is produced;
* ``stale``: every frame or step after set-up reuses the random key of
  set-up's last one (state left stale across units).

One chip runs no exchange between chips, so that fault does not apply.
"""

from __future__ import annotations

import contextlib
import dataclasses

from .cells import TRAIN_CHECK_STEPS

FAULTS = ("unchanged", "half_batch", "altered", "stale")
TILE = 8192  # pixels of a frame that ``altered`` scales


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def render_fault(name: str):
    from pathtracerap_tpu_torch.render.wavefront import Renderer

    real = Renderer.render
    last = {}

    def render(self, seed=None, **kw):
        if name == "stale":
            last.setdefault("seed", seed)  # the warm-up frame's
            return real(self, seed=last["seed"], **kw)
        if name == "unchanged":
            img = last.get("img")
            last["img"] = real(self, seed=seed, **kw) if img is None else img
            return last["img"]
        if name == "half_batch":
            cfg = self.config
            self.config = dataclasses.replace(cfg, samples_per_pixel=cfg.samples_per_pixel // 2)
            try:
                return real(self, seed=seed, **kw)
            finally:
                self.config = cfg
        img = real(self, seed=seed, **kw)
        flat = img.reshape(-1, img.shape[-1]).clone()
        flat[:TILE] *= 1.01
        return flat.reshape(img.shape)

    return _patched(Renderer, "render", render)


def train_fault(name: str):
    import torch

    from pathtracerap_tpu_torch import diff
    from pathtracerap_tpu_torch.diff import grad

    if name == "half_batch":
        real_loss = grad.image_loss

        def image_loss(params, scene, target, *args, weight=None, **kw):
            n = target.shape[0]
            w = (torch.arange(n, device=target.device) < n // 2).to(target.dtype) * 2.0
            return real_loss(params, scene, target, *args, weight=w, **kw)

        return _patched(grad, "image_loss", image_loss)
    real_make = diff.make_train_step

    def make_train_step(*args, **kw):
        step = real_make(*args, **kw)
        keys = []

        def broken(params, target, key):
            if name == "stale":
                keys.append(key)
                return step(params, target, keys[min(len(keys), TRAIN_CHECK_STEPS) - 1])
            loss, new = step(params, target, key)
            if name == "unchanged":
                return loss, params
            return loss * 1.01, new

        return broken

    return _patched(diff, "make_train_step", make_train_step)


def fault(kind: str, name: str):
    """The context manager of fault ``name`` for a cell of ``kind``."""
    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}")
    return render_fault(name) if kind == "render" else train_fault(name)
