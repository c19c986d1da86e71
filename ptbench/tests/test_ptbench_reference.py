"""The plain reference (``ptbench/reference``) against the port's CPU path at
32x16, on both configurations: the uniform stream, the image, and the
loss and gradient of the train steps.

On the reference scene the two agree bit for bit.  On the Cornell box the
port's CPU path is kernel 4's plain version, which normalizes with
``rsqrt`` where the reference divides by the square root; a last-bit
difference in a direction sends about one path in a few thousand another
way (each of the first three steps here), so there the image is held to
the share of pixels that differ and the train steps to the gaps that one
such path leaves.

Run: ``python -m pytest ptbench/tests -q`` from the repository's root.
"""

import json
import os

import pytest
import torch

from ptbench import cells, scenes
from ptbench.reference import pathtrace, rng, train as ref_train, world as ref_world

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
RES = (32, 16)
SEED = 2**31 + 4321  # above 31 bits, as the benchmark's seeds are


def config(name):
    with open(os.path.join(ROOT, "ptbench", "configs", name + ".json")) as f:
        return json.load(f)


@pytest.fixture(scope="module", params=["pathtracerap-reference", "cornell-box"])
def scene(request):
    cfg = config(request.param)
    inputs = scenes.scene_inputs(cfg)
    return request.param, cfg, inputs, scenes.port_scene(inputs).to_device("cpu")


@pytest.mark.parametrize("n_rays", [512, 20000])
def test_uniform_stream_equals_the_ports(n_rays):
    from pathtracerap_tpu_torch.ops.rng import chunk_uniforms, prng_key

    bounces = 5
    port = chunk_uniforms(prng_key(SEED, "cpu"), 3, bounces, n_rays, n_rays)
    ray = torch.arange(n_rays, dtype=torch.int64)
    for b in range(bounces):
        ref = rng.uniforms(SEED, 3, bounces - b, ray)
        assert torch.equal(ref, port[:, 4 * b:4 * b + 4])


def test_scene_inputs_equal_the_ports_builders():
    from pathtracerap_tpu_torch.scene.build import build_cornell_box_scene, build_reference_scene

    for name, build in (("pathtracerap-reference", build_reference_scene),
                        ("cornell-box", build_cornell_box_scene)):
        a, b = scenes.port_scene(scenes.scene_inputs(config(name))), build()
        for field in ("vertex_pos", "vertex_nrm", "tri_vidx", "model_mesh", "model_to_world",
                      "world_to_model", "mat_type", "mat_color", "per_voxel_tris"):
            assert (getattr(a, field) == getattr(b, field)).all(), (name, field)


def test_image_against_the_port(scene):
    from pathtracerap_tpu_torch import RenderConfig, Renderer

    name, cfg, inputs, dev_scene = scene
    spp = 2 if name == "pathtracerap-reference" else 8
    rc = RenderConfig(resolution=RES, samples_per_pixel=spp, max_bounces=cfg["max_bounces"],
                      camera=cells.camera(cfg), engine=cfg["engine"])
    port = Renderer(dev_scene, rc, device="cpu").render(seed=SEED).reshape(-1, 3)
    ref, _, _ = pathtrace.render(ref_world.build_world(inputs, "cpu"), cfg["camera"], RES, spp,
                                 cfg["max_bounces"], SEED)
    nums = cells.render_numbers(port, ref)
    if name == "pathtracerap-reference":
        assert torch.equal(port, ref)
    else:
        assert nums["mismatch_share"] <= 2 / 512 and nums["mean_abs_diff"] < 3e-4


def test_train_steps_against_the_port(scene):
    from pathtracerap_tpu_torch.diff import make_train_step
    from pathtracerap_tpu_torch.ops.rng import prng_key

    name, cfg, inputs, dev_scene = scene
    spp = 2 if name == "pathtracerap-reference" else 8
    lr = 0.05
    step = make_train_step(dev_scene, cells.camera(cfg), RES, spp, cfg["max_bounces"], lr=lr,
                           engine=cfg["engine"])
    target = torch.rand((RES[0] * RES[1], 3), generator=torch.Generator().manual_seed(SEED))
    seeds = [cells.unit_seed(SEED, i) for i in range(3)]
    params = {"mat_color": dev_scene.mat_color.clone()}
    losses, hist = [], [params["mat_color"]]
    for s in seeds:
        loss, params = step(params, target, prng_key(s, "cpu"))
        losses.append(float(loss))
        hist.append(params["mat_color"])
    rl, rh = ref_train.sgd_steps(ref_world.build_world(inputs, "cpu"), cfg["camera"], RES, spp,
                                 cfg["max_bounces"], seeds, target,
                                 torch.as_tensor(inputs.mat_color), lr)
    gaps = cells.train_numbers(losses, hist, rl, rh, lr)
    if name == "pathtracerap-reference":
        assert losses == rl
        assert max(gaps.values()) < 1e-6
    else:
        assert gaps["loss_gap"] < 2e-3 and gaps["grad_gap"] < 5e-3 and gaps["change_gap"] < 5e-3

