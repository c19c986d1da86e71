"""The port's data-parallel layer (``parallel/sharding.py``,
``parallel/distributed.py``, ``diff/grad.py::make_sharded_train_step``,
``utils/failure.py::liveness_probe``, ``parallel/dryrun.py``) against the
JAX package's on the CPU.

Mirrors tests/test_sharding.py:31-96, tests/test_distributed.py:22-48 and
tests/test_failure.py:37.  The port's ranks are two processes under
``gloo`` (``tests/_torch_distributed_worker.py``, launched once for the
module with a deadline); JAX runs on the 8-device CPU mesh in this process.
Data-parallel images must equal the port's single-process render bit for
bit and JAX's within 1e-5; the sharded step must equal JAX's within rtol
1e-5 and the port's one-rank step within rtol 1e-6 (the sums' order
differs).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_distributed_worker as W
from pathtracerap_tpu.config import CameraConfig as JCamera
from pathtracerap_tpu.config import RenderConfig as JRenderConfig
from pathtracerap_tpu.diff.grad import extract_params as jax_extract_params
from pathtracerap_tpu.diff.grad import make_sharded_train_step as jax_sharded_step
from pathtracerap_tpu.parallel import distributed as JD
from pathtracerap_tpu.parallel.sharding import default_mesh as jax_default_mesh
from pathtracerap_tpu.parallel.sharding import render_image_dp as jax_render_image_dp
from pathtracerap_tpu.scene.build import build_cornell_box_scene as jax_cornell
from pathtracerap_tpu_torch import CameraConfig, RenderConfig, Renderer, build_cornell_box_scene
from pathtracerap_tpu_torch.diff import extract_params, make_sharded_train_step
from pathtracerap_tpu_torch.ops.plucker import bake_world_triangles
from pathtracerap_tpu_torch.ops.rng import prng_key
from pathtracerap_tpu_torch.parallel import (
    comm_model, default_mesh, init_distributed, render_accumulate_sample_parallel,
    render_image_dp, scaling_report,
)
from pathtracerap_tpu_torch.parallel.distributed import _pow2_counts
from pathtracerap_tpu_torch.parallel.sharding import (
    Mesh, rank_rows, rank_share, render_rank_slab,
)
from pathtracerap_tpu_torch.utils.failure import liveness_probe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = W.RES[0] * W.RES[1]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The worker's run over two gloo ranks: (arrays, meta, per-rank slabs)."""
    prefix = str(tmp_path_factory.mktemp("ranks") / "run")
    results = W.run_job(prefix, n=2, timeout=120)
    assert all(rc == 0 for rc, _ in results), "\n".join(t[-3000:] for _, t in results)
    with open(prefix + ".json") as f:
        meta = json.load(f)
    slabs = [dict(np.load(f"{prefix}.rank{r}.npz")) for r in range(2)]
    return dict(np.load(prefix + ".npz")), meta, slabs


@pytest.fixture(scope="module")
def scenes():
    return jax_cornell().to_device(), build_cornell_box_scene().to_device("cpu")


def _cfg(name, jax_side=False):
    engine, res, spp, bounces, _ = W.DP_RENDERS[name]
    cam, cfg = (JCamera, JRenderConfig) if jax_side else (CameraConfig, RenderConfig)
    return cfg(resolution=res, samples_per_pixel=spp, max_bounces=bounces,
               camera=cam(**W.CAMERA), engine=engine)


def test_default_mesh_without_a_group_has_one_rank():
    mesh = default_mesh("cpu")
    assert (mesh.rank, mesh.world_size, mesh.backend) == (0, 1, "")
    assert mesh.device == torch.device("cpu")
    assert default_mesh().device.type == "cuda"  # the card, unless asked otherwise


def test_rank_shares_pad_to_whole_tiles():
    # sharding.py:100-101: the even split, rounded up to whole RNG tiles
    assert rank_share(16384, 8, 8192) == 8192
    assert rank_share(512, 2, 64) == 256
    assert [rank_rows(4096, rank_share(4096, 2, 8192), r) for r in range(2)] == [4096, 0]
    assert [rank_rows(1000, 512, r) for r in range(2)] == [512, 488]


def test_ray_sharded_render_matches_jax_and_one_rank(two_ranks, scenes):
    """tests/test_sharding.py:36: 32x16, mxu, tile 64 over two ranks."""
    arrays, _, _ = two_ranks
    js, ps = scenes
    img = arrays["dp_mxu"]
    assert img.shape == (W.RES[1], W.RES[0], 3)
    assert np.all(np.isfinite(img)) and img.max() > 0.05
    jimg = np.asarray(jax_render_image_dp(js, _cfg("mxu", True), mesh=jax_default_mesh(),
                                          tile_size=64))
    np.testing.assert_allclose(img, jimg, rtol=0, atol=1e-5)
    single = render_image_dp(ps, _cfg("mxu"), mesh=default_mesh("cpu"), tile_size=64).numpy()
    np.testing.assert_array_equal(img, single)
    facade = Renderer(ps, _cfg("mxu"), device="cpu").render().numpy()
    assert abs(img.mean() - facade.mean()) < 0.05


@pytest.mark.parametrize("name", ["fused", "binned", "binned_padding_rank"])
def test_dp_megakernel_bitmatches_single_process(two_ranks, scenes, name):
    """tests/test_sharding.py:63: each rank's share padded to whole 8192-ray
    RNG tiles keeps every ray's uniforms, so the two-rank image is the
    facade's bit for bit (at 64x64 rank 1 holds padding only)."""
    arrays, _, _ = two_ranks
    js, ps = scenes
    img = arrays[f"dp_{name}"]
    np.testing.assert_array_equal(img, Renderer(ps, _cfg(name), device="cpu").render().numpy())
    if name != "binned_padding_rank":
        jimg = np.asarray(jax_render_image_dp(js, _cfg(name, True), mesh=jax_default_mesh()))
        np.testing.assert_allclose(img, jimg, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", list(W.DP_RENDERS))
def test_rank_slabs_in_one_process_equal_the_two_process_run(two_ranks, scenes, name):
    """The pure per-rank function, called for both ranks here, gives each
    rank's padded slab of the two-process run and, concatenated and
    trimmed to the image, its image."""
    arrays, _, slabs = two_ranks
    _, ps = scenes
    engine, res, spp, bounces, tile = W.DP_RENDERS[name]
    world = bake_world_triangles(ps)
    here = [render_rank_slab(ps, prng_key(0, "cpu"), CameraConfig(**W.CAMERA), res, spp, bounces,
                             r, 2, engine=engine, world=world, tile_size=tile).numpy()
            for r in range(2)]
    for r in range(2):
        np.testing.assert_array_equal(here[r], slabs[r][f"slab_{name}"])
    img = np.concatenate(here)[:res[0] * res[1]].reshape(res[1], res[0], 3) / spp
    np.testing.assert_array_equal(img, arrays[f"dp_{name}"])


def test_sample_parallel_sums_as_one_rank(two_ranks, scenes):
    """tests/test_sharding.py:83: shape, range, and the same sums as one
    rank that renders all 8 samples."""
    arrays, _, _ = two_ranks
    _, ps = scenes
    acc = arrays["sample_parallel"]
    sp = W.SAMPLE_PARALLEL
    assert acc.shape == (N, 3) and np.all(np.isfinite(acc))
    assert acc.max() <= sp["n_samples"] + 1e-5 and acc.max() > 0.2
    one = render_accumulate_sample_parallel(
        ps, prng_key(sp["seed"], "cpu"), CameraConfig(**W.CAMERA), W.RES, sp["n_samples"],
        sp["max_bounces"], default_mesh("cpu"), world=bake_world_triangles(ps),
        tile_size=sp["tile_size"]).numpy()
    np.testing.assert_allclose(acc, one, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="not divisible"):
        render_accumulate_sample_parallel(ps, prng_key(0, "cpu"), CameraConfig(**W.CAMERA),
                                          W.RES, 3, 1, _mesh(2), tile_size=512)


def _mesh(world_size):
    return Mesh(0, world_size, torch.device("cpu"))


def _port_step(ps, name, mesh):
    chunks, names, parity = W.STEPS[name]
    step = make_sharded_train_step(ps, CameraConfig(**W.CAMERA), W.RES, mesh=mesh,
                                   overlap_chunks=chunks, parity=parity, **W.STEP_KW)
    loss, new = step(extract_params(ps, names), torch.full((N, 3), W.STEP_TARGET),
                     prng_key(W.STEP_SEED, "cpu"))
    return float(loss), {k: v.numpy() for k, v in new.items()}


@pytest.mark.parametrize("name", list(W.STEPS))
def test_sharded_step_matches_jax(two_ranks, scenes, name):
    """The two-rank step against JAX's make_sharded_train_step on the
    8-device mesh (tests/test_distributed.py:48's step): loss within rtol
    1e-5, new parameters within 1e-5."""
    arrays, meta, _ = two_ranks
    js, _ = scenes
    chunks, names, parity = W.STEPS[name]
    kw = dict(W.STEP_KW)
    step = jax_sharded_step(js, JCamera(**W.CAMERA), W.RES, kw.pop("n_samples"),
                            kw.pop("max_bounces"), jax_default_mesh(), overlap_chunks=chunks,
                            parity=parity, **kw)
    loss, new = step(jax_extract_params(js, names), jnp.full((N, 3), W.STEP_TARGET, jnp.float32),
                     jax.random.PRNGKey(W.STEP_SEED))
    np.testing.assert_allclose(meta[f"loss_{name}"], float(loss), rtol=1e-5)
    for k in names:
        np.testing.assert_allclose(arrays[f"step_{name}_{k}"], np.asarray(new[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    moved = np.abs(arrays[f"step_{name}_mat_color"] - np.asarray(js.mat_color)).max()
    assert moved > 0


@pytest.mark.parametrize("name", list(W.STEPS))
def test_sharded_step_does_not_depend_on_the_world_size(two_ranks, scenes, name):
    """Ray r's RNG tile is r // tile_size for any world size: the two-rank
    step equals the one-rank step up to the order of the sums."""
    arrays, meta, _ = two_ranks
    _, ps = scenes
    loss, new = _port_step(ps, name, default_mesh("cpu"))
    np.testing.assert_allclose(meta[f"loss_{name}"], loss, rtol=1e-6)
    for k, v in new.items():
        np.testing.assert_allclose(arrays[f"step_{name}_{k}"], v, rtol=1e-6, atol=1e-7,
                                   err_msg=k)


def test_init_distributed_single_process_noop():
    info = init_distributed()
    assert info == {"process_index": 0, "process_count": 1, "local_devices": 1,
                    "global_devices": 1, "initialized_multiprocess": False}
    assert not torch.distributed.is_initialized()


def test_pow2_counts():
    for n in (1, 6, 8, 13):
        assert _pow2_counts(n) == JD._pow2_counts(n)
    assert _pow2_counts(8) == [1, 2, 4, 8]


def test_two_process_job_joins_and_scales(two_ranks):
    """tests/test_distributed.py:35 and :48 over two processes: the group
    forms under gloo, and the scaling table has rows [1, 2] with
    efficiency 1.0 at one rank."""
    _, meta, _ = two_ranks
    info = meta["info"]
    assert info["initialized_multiprocess"] is True
    assert info["process_count"] == info["global_devices"] == 2
    assert meta["backend"] == "gloo"
    rep = meta["scaling"]
    assert rep["backend"] == "gloo" and rep["process_count"] == 2
    assert rep["device_kind"] == "cpu"
    assert [r["devices"] for r in rep["rows"]] == [1, 2]
    assert rep["rows"][0]["efficiency"] == 1.0
    for r in rep["rows"]:  # Mrays/s are rounded to 2 places: a loaded CPU may read 0.0
        assert r["wall_s"] > 0.0 and np.isfinite(r["wall_s"]) and r["mrays_per_s"] >= 0.0


def test_scaling_report_single_process(scenes):
    _, ps = scenes
    cfg = RenderConfig(resolution=W.RES, samples_per_pixel=1, max_bounces=2,
                       camera=CameraConfig(**W.CAMERA), engine="mxu")
    rep = scaling_report(ps, cfg, repeats=1)
    assert set(rep) == {"backend", "device_kind", "process_count", "rows"}
    assert [r["devices"] for r in rep["rows"]] == [1]
    assert rep["rows"][0]["efficiency"] == 1.0 and rep["backend"] == "none"


@pytest.mark.parametrize("n", [1, 2, 8])
def test_comm_model_bytes_equal_jax(n):
    kw = dict(samples_per_pixel=4, max_bounces=5, param_bytes=132, world_triangles=1039,
              ring_trace_calls_per_device=20)
    port, ref = comm_model((1000, 800), n, **kw), JD.comm_model((1000, 800), n, **kw)
    assert port["n_devices"] == ref["n_devices"]
    for mode in ("dp_render_image_allreduce", "dp_train_grad_allreduce",
                 "geometry_ring_pack_rotation"):
        assert port[mode]["bytes_per_device"] == ref[mode]["bytes_per_device"], mode
        assert set(port[mode]) == {"bytes_per_device", "nvlink_ms", "ib_ms"}
    # the port's links are the card's: spec-sheet assumptions, stated
    assert port["assumptions"]["nvlink_gb_s"] == 450.0 and port["assumptions"]["ib_gb_s"] == 50.0
    assert "not measured" in port["assumptions"]["source"]


def test_liveness_probe_counts_ranks(two_ranks):
    """tests/test_failure.py:37: one process answers 1, two gloo ranks 2."""
    assert liveness_probe() == 1
    assert two_ranks[1]["liveness"] == 2


def test_dryrun_over_two_ranks():
    """``python -m pathtracerap_tpu_torch.parallel.dryrun``: one sharded step
    (two overlapped chunks, mat_color and vertex_pos) over two gloo ranks,
    held against the one-process sum-loss gradient."""
    proc = subprocess.run(
        [sys.executable, "-m", "pathtracerap_tpu_torch.parallel.dryrun", "--ranks", "2",
         "--timeout", "100", "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
        timeout=120, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    res = json.loads(next(l for l in proc.stdout.splitlines() if l.startswith("{")))
    assert res["info"]["process_count"] == 2 and res["params_moved"] > 0
    assert (res["device"], res["backend"]) == ("cpu", "gloo")
    np.testing.assert_allclose(res["loss"], res["single_process_loss"], rtol=1e-5)


def test_dryrun_asks_for_the_card_by_default(monkeypatch, capsys):
    """The dry run runs on the card unless ``--device cpu``: with no card it
    exits non-zero before it starts a rank."""
    from pathtracerap_tpu_torch.parallel import dryrun

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(dryrun, "run_local_ranks", lambda *a, **k: pytest.fail("ranks started"))
    assert dryrun.main(["--ranks", "2"]) != 0
    assert "no CUDA device" in capsys.readouterr().err
