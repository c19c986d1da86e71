"""The dense-mesh deployment (``ptbench/configs/highpoly.json``): BASELINE
config 2's 146,688-triangle OBJ in the upstream scene, 8 bounces, on the
port's binned engine, on the CPU.

* the benchmark's scene inputs and the port's scene hold the same 149,733
  world triangles, and ``Renderer(engine="fused")`` resolves to the binned
  engine over the bake's fused pack;
* the binned render through the kernels' plain twins, at 32x32 x 1 spp x
  8 bounces of the full scene, agrees with the benchmark's plain reference
  (``ptbench/reference``) within the cell's limits;
* an 8-bounce binned render of the upstream scene (past
  ``constants.MAX_BOUNCES``) agrees with the reference bit for bit;
* the binned engine's ``ptap.sort`` and ``ptap.worklists`` spans: one each
  a bounce and slab under a profiler, side by side, and no
  ``record_function`` entered without one;
* a render of no samples (half of the cell's one, as the benchmark's
  ``half_batch`` fault asks for) returns their mean, NaN, and does not raise.
"""

import collections
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pathtracerap_tpu_torch import RenderConfig, Renderer, constants
from pathtracerap_tpu_torch.kernels import megakernel as MK
from pathtracerap_tpu_torch.ops.plucker import PACK_MAX_TRIANGLES
from ptbench import cells, scenes
from ptbench.reference import pathtrace, world as ref_world

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 3_000_000_029  # a 32-bit seed above 2**31, as the benchmark's
WORLD_TRIANGLES = 149_733  # 3,045 of the upstream scene and 146,688 of the OBJ
BLOCKS = 293  # 512-triangle blocks of the fused pack: 6 upstream, 287 the OBJ's


def _json(*parts):
    with open(os.path.join(ROOT, *parts), encoding="utf-8") as f:
        return json.load(f)


def _renderer(config, resolution, bounces, scene=None):
    scene = scene or scenes.port_scene(scenes.scene_inputs(config)).to_device("cpu")
    cfg = RenderConfig(resolution=resolution, samples_per_pixel=1, max_bounces=bounces,
                       camera=cells.camera(config), engine=config["engine"])
    return Renderer(scene, cfg, device="cpu")


def _reference(config, inputs, resolution, bounces):
    w = ref_world.build_world(inputs, "cpu")
    return pathtrace.render(w, config["camera"], resolution, 1, bounces, SEED)[0]


@pytest.fixture(scope="module")
def highpoly():
    config = _json("ptbench", "configs", "highpoly.json")
    inputs = scenes.scene_inputs(config)
    scene = scenes.port_scene(inputs).to_device("cpu")
    return config, inputs, scene


def test_the_configuration_extends_the_upstream_scene():
    config = _json("ptbench", "configs", "highpoly.json")
    upstream = _json("ptbench", "configs", "pathtracerap-reference.json")
    assert config["instances"][:-1] == upstream["instances"]
    assert {k: v for k, v in config["meshes"].items() if k != "highpoly_blob"} == upstream["meshes"]
    assert config["instances"][-1]["mesh"] == "highpoly_blob"
    assert config["instances"][-1]["material"] == "DIFFUSE"
    assert (tuple(config["resolution"]), config["max_bounces"]) == ((512, 512), 8)
    assert config["engine"] == "fused" and config["precision"] == "float32"
    assert config["reduced"] == []


def test_the_same_world_triangles_and_the_binned_engine(highpoly):
    config, inputs, scene = highpoly
    ref = ref_world.build_world(inputs, "cpu")
    r = _renderer(config, (16, 16), 8, scene)
    w = r.world
    assert inputs.num_triangles == ref.a.shape[0] == w.n_valid == WORLD_TRIANGLES
    n = WORLD_TRIANGLES
    # the bake reorders the triangles: compare the two soups sorted by
    # corner a and the edges from it, then instance, material and normal
    mine = torch.cat([w.v0[:n], w.e1[:n], w.e2[:n],
                      w.tri_model[:n, None].float(), w.mat_type[:n, None].float(),
                      w.shade_normal[:n]], dim=1).double().numpy()
    theirs = torch.cat([ref.a, ref.b - ref.a, ref.c - ref.a, ref.model[:, None].float(),
                        ref.mat_type[:, None].float(), ref.shade_n], dim=1).double().numpy()
    mine, theirs = (x[np.lexsort(x.T[::-1])] for x in (mine, theirs))
    np.testing.assert_array_equal(mine[:, :11], theirs[:, :11])
    np.testing.assert_allclose(mine[:, 11:], theirs[:, 11:], rtol=0, atol=1e-6)
    assert w.fused_ops is not None and w.block_aabb.shape[0] == BLOCKS
    assert w.tri_block == 512 and w.fused_ops.shape[1] // 4 < PACK_MAX_TRIANGLES // 8
    assert r.engine == "binned"
    # above SUB_MAX_BLOCKS the worklists are of whole blocks, in 512-ray tiles
    assert not MK.use_sub_blocks(w) and MK.binned_ray_tile(w) == 512


def test_the_binned_render_holds_to_the_reference(highpoly):
    config, inputs, scene = highpoly
    limits = _json("ptbench", "workloads", "frames-1spp.json")["limits"]
    # 1,024 pixels: one path parted by a last-bit difference (the kernels'
    # rsqrt against the reference's division) stays under both of the
    # cell's limits, set for 262,144 pixels; at 16x16 one such pixel alone
    # exceeds them
    res = (32, 32)
    img = _renderer(config, res, config["max_bounces"], scene).render(seed=SEED)
    ref = _reference(config, inputs, res, config["max_bounces"])
    nums = cells.render_numbers(img.reshape(-1, 3), ref)
    assert all(nums[k] <= limits[k] for k in limits), nums
    assert float(img.std()) > 0.0  # lit, not a blank frame


def test_eight_bounces_of_the_upstream_scene_equal_the_reference():
    config = _json("ptbench", "configs", "pathtracerap-reference.json")
    inputs = scenes.scene_inputs(config)
    bounces = 8
    assert bounces > constants.MAX_BOUNCES
    res = (32, 16)
    r = _renderer(config, res, bounces)
    assert r.engine == "binned"
    img = r.render(seed=SEED)
    ref = _reference(config, inputs, res, bounces)
    np.testing.assert_array_equal(img.reshape(-1, 3).numpy(), ref.numpy())


def test_sort_and_worklists_spans_under_a_profiler():
    config = _json("ptbench", "configs", "pathtracerap-reference.json")
    bounces = 8
    r = _renderer(config, (32, 16), bounces)
    plain = r.render(seed=SEED)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = r.render(seed=SEED)
    events = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                    for e in prof.profiler.kineto_results.events() if e.name().startswith("ptap."))
    counts = collections.Counter(name for _, _, name in events)
    # one slab of one sample: a sort and a worklist build each later bounce
    assert counts["ptap.sort"] == counts["ptap.worklists"] == counts["ptap.bounce"] == bounces - 1
    sorts = [e for e in events if e[2] == "ptap.sort"]
    lists = [e for e in events if e[2] == "ptap.worklists"]
    assert all(s_end <= l_start for (_, s_end, _), (l_start, _, _) in zip(sorts, lists))
    assert torch.equal(traced, plain)


def test_sort_and_worklists_spans_enter_nothing_without_a_profiler(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    config = _json("ptbench", "configs", "pathtracerap-reference.json")
    img = _renderer(config, (32, 16), 8).render(seed=SEED)
    assert bool(torch.isfinite(img).all())


def test_a_render_of_no_samples_is_nan():
    config = _json("ptbench", "configs", "pathtracerap-reference.json")
    r = _renderer(config, (32, 16), 8)
    r.config = dataclasses.replace(r.config, samples_per_pixel=0)
    img = r.render(seed=SEED)
    assert img.shape == (16, 32, 3) and bool(torch.isnan(img).all())
