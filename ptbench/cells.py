"""The general generator: a closed loop of frames or of train steps through
the program's own entry points, set up from a configuration and a traffic
mix, and the check of what the timed path produced against the plain
reference.

Traffic (``ptbench/workloads/<traffic>.json``):

* ``kind``: ``render`` (``Renderer.render`` frames) or ``train``
  (``make_train_step`` steps on ``param``, SGD at ``lr``);
* ``spp``: samples a frame or a step; ``engine`` (optional) overrides the
  configuration's;
* ``rate``, ``tail`` (a metric name each) and ``tail_pct``: the end-to-end
  metrics the window gives;
* ``check_units``: frames or steps of the window compared with the
  reference (a sample drawn from the seed); ``trace_units``: frames or
  steps timed under the profiler, all of them compared;
* ``limits``: the limit of each number compared.

A frame or step ``i`` draws its own seed from ``--seed`` and ``i``; every
seed gives the same sizes, so every run does the same work.
"""

from __future__ import annotations

import functools
import random

import torch

from . import scenes
from .reference import pathtrace, train as ref_train, world as ref_world

PIXEL_TOL = 1e-3  # a pixel whose channels all lie within this of the reference's agrees
TRAIN_CHECK_STEPS = 3  # the train steps of set-up the reference follows from the start


def unit_seed(seed: int, i: int) -> int:
    """The 32-bit seed of frame or step ``i``: splitmix64 of the pair."""
    x = (seed * 0x9E3779B97F4A7C15 + i + 1) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (x ^ (x >> 31)) & 0xFFFFFFFF


def camera(config: dict):
    from pathtracerap_tpu_torch import CameraConfig

    c = config["camera"]
    return CameraConfig(position=tuple(c["position"]), plane_x=tuple(c["plane_x"]),
                        plane_y=tuple(c["plane_y"]), plane_z=c["plane_z"])


class Cell:
    """One configuration under one traffic mix on one device.

    ``setup()`` builds the program's objects and runs the set-up units;
    ``unit(i)`` runs frame or step ``i`` and returns its output (the
    caller synchronizes); ``keep(i, out)`` offers an output of the window
    for the check (``kept`` holds the sample); ``release()`` drops the program's state;
    ``check(count_units, count_every)`` compares with the reference and
    returns ``({name: value}, counts)``, ``counts`` the reference's work
    counts of ``count_units`` (:mod:`ptbench.roofline`) when
    ``count_every``."""

    first_unit = 1  # window units are numbered from here

    def __init__(self, config: dict, traffic: dict, seed: int, device, root: str = scenes.ROOT):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.inputs = scenes.scene_inputs(config, root)
        self.resolution = tuple(config["resolution"])
        self.bounces = config["max_bounces"]
        self.spp = traffic["spp"]
        self.engine = traffic.get("engine", config["engine"])
        self.work = pathtrace.frame_rays(self.resolution, self.spp, self.bounces)
        self.limits = traffic.get("limits", {})
        self._rand = random.Random(seed)
        self.kept = []
        self.seen = 0

    def keep(self, i: int, out) -> None:
        """Reservoir sampling, from the seed, of ``check_units`` outputs."""
        k = self.traffic["check_units"]
        self.seen += 1
        if len(self.kept) < k:
            self.kept.append((i, cloned(out)))
        else:
            j = self._rand.randrange(self.seen)
            if j < k:
                self.kept[j] = (i, cloned(out))

    def reference_world(self, dtype=torch.float32):
        return ref_world.build_world(self.inputs, self.device, dtype)

    def reference(self, w, i: int, dtype=torch.float32, count_every: int = 0):
        """The reference's (image, topology, counts) of frame or step ``i``."""
        return pathtrace.render(w, self.config["camera"], self.resolution, self.spp,
                                self.bounces, unit_seed(self.seed, i), dtype=dtype,
                                count_every=count_every)


class RenderCell(Cell):
    def setup(self):
        from pathtracerap_tpu_torch import RenderConfig, Renderer

        scene = scenes.port_scene(self.inputs).to_device(self.device)
        cfg = RenderConfig(resolution=self.resolution, samples_per_pixel=self.spp,
                           max_bounces=self.bounces, camera=camera(self.config),
                           engine=self.engine)
        self.renderer = Renderer(scene, cfg, device=self.device)
        self.unit(0)  # warm-up: builds or loads the kernels, first launches

    def unit(self, i: int):
        return self.renderer.render(seed=unit_seed(self.seed, i))

    def release(self):
        self.renderer = None

    def check(self, count_units=(), count_every: int = 0):
        """Worst over the kept frames of ``render_numbers`` against the
        reference; the kept frames are the traced ones where counts are
        asked for."""
        w = self.reference_world()
        worst, counts = {}, []
        for i, img in self.kept:
            ref, _, c = self.reference(w, i, count_every=count_every if i in count_units else 0)
            for k, v in render_numbers(img.reshape(-1, 3), ref).items():
                worst[k] = max(worst.get(k, 0.0), v)
            if c is not None:
                counts.append(c)
        return worst, counts


class TrainCell(Cell):
    """A step's output is ``(loss, parameter before, parameter after)``."""

    first_unit = TRAIN_CHECK_STEPS

    def setup(self):
        from pathtracerap_tpu_torch.diff import extract_params, make_train_step

        scene = scenes.port_scene(self.inputs).to_device(self.device)
        self.param = self.traffic["param"]
        if self.param != "mat_color":
            raise ValueError(f"the reference trains mat_color only, not {self.param!r}")
        self.params = {k: v.clone() for k, v in extract_params(scene, (self.param,)).items()}
        self.step = make_train_step(scene, camera(self.config), self.resolution, self.spp,
                                    self.bounces, lr=self.traffic["lr"], engine=self.engine)
        g = torch.Generator(device=self.device)
        g.manual_seed(self.seed)
        n = self.resolution[0] * self.resolution[1]
        self.target = torch.rand((n, 3), generator=g, device=self.device)
        self.losses, self.history = [], [self.params[self.param].clone()]
        for i in range(TRAIN_CHECK_STEPS):  # the first steps, which the reference follows
            loss, _, after = self.unit(i)
            self.losses.append(float(loss))
            self.history.append(after.clone())

    def unit(self, i: int):
        from pathtracerap_tpu_torch.ops.rng import prng_key

        before = self.params[self.param].clone()
        loss, self.params = self.step(self.params, self.target,
                                      prng_key(unit_seed(self.seed, i), self.device))
        return loss, before, self.params[self.param]

    def release(self):
        self.step = self.params = None

    def check(self, count_units=(), count_every: int = 0):
        """``train_numbers`` of set-up's steps against the reference's from
        the configuration's parameters, and the worst ``step_numbers`` of
        the kept window steps, each against one reference step from the
        program's parameters before it."""
        w = self.reference_world()
        ref = functools.partial(ref_train.sgd_steps, w, self.config["camera"], self.resolution,
                                self.spp, self.bounces, target=self.target, lr=self.traffic["lr"])
        losses, hist = ref([unit_seed(self.seed, i) for i in range(TRAIN_CHECK_STEPS)],
                           colors=torch.as_tensor(self.inputs.mat_color, device=self.device))
        worst = train_numbers(self.losses, self.history, losses, hist, self.traffic["lr"])
        for i, (loss, before, after) in self.kept:
            rl, rh = ref([unit_seed(self.seed, i)], colors=before)
            for k, v in step_numbers(float(loss), before, after, rl[0], rh[1]).items():
                worst[k] = max(worst.get(k, 0.0), v)
        counts = [self.reference(w, i, count_every=count_every)[2] for i in count_units]
        return worst, counts


KINDS = {"render": RenderCell, "train": TrainCell}


def make_cell(config: dict, traffic: dict, seed: int, device, **kw) -> Cell:
    return KINDS[traffic["kind"]](config, traffic, seed, device, **kw)


def cloned(out):
    """A copy of a frame, or of a train step's tensors, for the check."""
    return tuple(t.clone() for t in out) if isinstance(out, tuple) else out.clone()


def render_numbers(img: torch.Tensor, ref: torch.Tensor) -> dict:
    """``mismatch_share``: the share of pixels with a channel more than
    ``PIXEL_TOL`` from the reference's (a path that went another way);
    ``mean_abs_diff``: the mean over all channels of |image - reference|."""
    d = (img.float() - ref.float()).abs()
    return {"mismatch_share": float((d.amax(dim=1) > PIXEL_TOL).float().mean()),
            "mean_abs_diff": float(d.mean())}


def train_numbers(losses, hist, ref_losses, ref_hist, lr: float) -> dict:
    """``loss_gap``: the largest relative gap of a step's loss;
    ``grad_gap``: the gap between the norms of the first gradient (worked
    out from the parameters after step 1) over the reference's norm;
    ``change_gap``: the same of the parameters' change over the three
    steps.  One leaf is trained, so it is the worst leaf."""
    def norm(x):
        return float(torch.linalg.vector_norm(x.double()))

    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    g, gr = (hist[0] - hist[1]) / lr, (ref_hist[0] - ref_hist[1]) / lr
    n = len(losses)
    c, cr = hist[n] - hist[0], ref_hist[n] - ref_hist[0]
    return {"loss_gap": loss_gap,
            "grad_gap": abs(norm(g) - norm(gr)) / norm(gr),
            "change_gap": abs(norm(c) - norm(cr)) / norm(cr)}


def step_numbers(loss: float, before, after, ref_loss: float, ref_after) -> dict:
    """One step from the same parameters: ``window_loss_gap``, the
    relative gap of its loss; ``window_step_gap``, the gap between the
    norms of the parameters' change over the reference's norm."""
    def norm(x):
        return float(torch.linalg.vector_norm(x.double()))

    d, dr = norm(after - before), norm(ref_after - before)
    return {"window_loss_gap": abs(loss - ref_loss) / abs(ref_loss),
            "window_step_gap": abs(d - dr) / dr}
