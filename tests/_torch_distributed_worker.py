"""One rank of the port's multi-process tests on the CPU (the counterpart of
``tests/_distributed_worker.py``):

    python tests/_torch_distributed_worker.py OUT_PREFIX [dp|ring]

with torchrun's variables (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``) set by :func:`run_job`, which launches the ranks with
:func:`pathtracerap_tpu_torch.parallel.dryrun.run_local_ranks` on a fresh
localhost port and a deadline.  JAX is blocked: the ranks run the port
alone, under ``gloo``.  Every rank runs the same collectives; rank 0 writes
``OUT_PREFIX.npz`` and ``OUT_PREFIX.json``, and each rank its own slabs to
``OUT_PREFIX.rank{r}.npz``.  The ``dp`` job (the default) runs the
data-parallel layer; the ``ring`` job the geometry ring
(``parallel/geometry.py``): its renders and train steps, each rank's
payloads moving over ``batch_isend_irecv``.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAMERA = dict(position=(0.0, 0.0, 150.0), plane_x=(-40.0, 40.0), plane_y=(-30.0, 30.0),
              plane_z=100.0)
RES = (32, 16)
# the data-parallel renders: name -> (engine, resolution, spp, bounces, tile_size)
DP_RENDERS = {
    "mxu": ("mxu", RES, 4, 3, 64),
    "fused": ("fused", (128, 128), 1, 3, 2048),
    "binned": ("binned", (128, 128), 1, 3, 2048),
    # 4096 rays: rank 1's share is padding only
    "binned_padding_rank": ("binned", (64, 64), 1, 3, 2048),
}
# the sharded train steps: name -> (overlap_chunks, params, parity)
STEPS = {
    "chunks1": (1, ("mat_color", "vertex_pos"), True),
    "chunks2": (2, ("mat_color", "vertex_pos"), True),
    "chunks2_quality": (2, ("mat_color", "vertex_pos"), False),
}
STEP_KW = dict(n_samples=2, max_bounces=3, tile_size=32, engine="pallas")
STEP_TARGET, STEP_SEED = 0.25, 3
SAMPLE_PARALLEL = dict(n_samples=8, max_bounces=2, tile_size=512, seed=3)
# the ring job: renders name -> (engine, spp, bounces, tile_size) at RES, and
# train steps name -> (params, parity, target, seed), n_samples 2, 3 bounces
RING_RENDERS = {"fused": ("fused", 4, 3, 64), "dense": ("dense", 4, 3, 64)}
RING_STEPS = {"mat_color": (("mat_color",), True, 0.0, 0),
              "vertex_pos": (("mat_color", "vertex_pos"), False, 0.3, 2)}
RING_STEP_KW = dict(n_samples=2, max_bounces=3, tile_size=64)


def run_job(out_prefix: str, n: int = 2, timeout: float = 120.0, job: str = "dp"):
    """Run this worker's ``job`` as ``n`` ranks; returns [(return code, output)]."""
    from pathtracerap_tpu_torch.parallel.dryrun import run_local_ranks

    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": ROOT}
    return run_local_ranks(lambda r: [sys.executable, os.path.abspath(__file__), out_prefix, job],
                           n, timeout=timeout, env=env, cwd=ROOT)


def ring_main(out_prefix: str) -> None:
    """The ring job: each of RING_RENDERS through
    ``render_image_geometry_sharded`` (with its stats) and each of
    RING_STEPS through ``make_geometry_sharded_train_step``."""
    sys.modules["jax"] = None  # the ranks run the port alone
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from pathtracerap_tpu_torch import CameraConfig, RenderConfig, build_cornell_box_scene
    from pathtracerap_tpu_torch.diff import extract_params
    from pathtracerap_tpu_torch.ops.rng import prng_key
    from pathtracerap_tpu_torch.parallel import (
        default_mesh, init_distributed, make_geometry_sharded_train_step,
        render_image_geometry_sharded,
    )

    info = init_distributed(device="cpu")
    mesh = default_mesh("cpu")
    camera = CameraConfig(**CAMERA)
    scene = build_cornell_box_scene().to_device("cpu")
    arrays, meta = {}, {"info": info, "backend": mesh.backend}
    for name, (engine, spp, bounces, tile) in RING_RENDERS.items():
        cfg = RenderConfig(resolution=RES, samples_per_pixel=spp, max_bounces=bounces,
                           camera=camera, engine="pallas")
        stats = {}
        arrays[f"ring_{name}"] = render_image_geometry_sharded(
            scene, cfg, mesh=mesh, tile_size=tile, engine=engine, stats=stats).numpy()
        meta[f"stats_{name}_rank{mesh.rank}"] = stats
    n = RES[0] * RES[1]
    for name, (names, parity, target, seed) in RING_STEPS.items():
        step = make_geometry_sharded_train_step(scene, camera, RES, mesh=mesh, parity=parity,
                                                param_names=names, **RING_STEP_KW)
        loss, new = step(extract_params(scene, names), torch.full((n, 3), target),
                         prng_key(seed, "cpu"))
        meta[f"loss_{name}"] = loss.item()
        for k, v in new.items():
            arrays[f"step_{name}_{k}"] = v.numpy()
    # every rank's stats reach rank 0
    box = [None] * mesh.world_size
    torch.distributed.all_gather_object(box, meta)
    if mesh.rank == 0:
        for other in box:
            meta.update({k: v for k, v in other.items() if k.startswith("stats_")})
        np.savez(f"{out_prefix}.npz", **arrays)
        with open(f"{out_prefix}.json", "w") as f:
            json.dump(meta, f)
    torch.distributed.destroy_process_group()


def main(out_prefix: str) -> None:
    sys.modules["jax"] = None  # the ranks run the port alone
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from pathtracerap_tpu_torch import CameraConfig, RenderConfig, build_cornell_box_scene
    from pathtracerap_tpu_torch.diff import extract_params, make_sharded_train_step
    from pathtracerap_tpu_torch.ops.plucker import bake_world_triangles
    from pathtracerap_tpu_torch.ops.rng import prng_key
    from pathtracerap_tpu_torch.parallel import (
        default_mesh, init_distributed, render_accumulate_sample_parallel, render_image_dp,
        scaling_report,
    )
    from pathtracerap_tpu_torch.parallel.sharding import render_rank_slab
    from pathtracerap_tpu_torch.utils.failure import liveness_probe

    info = init_distributed(device="cpu")
    mesh = default_mesh("cpu")
    camera = CameraConfig(**CAMERA)
    scene = build_cornell_box_scene().to_device("cpu")
    world = bake_world_triangles(scene)
    arrays, mine = {}, {}
    meta = {"info": info, "liveness": liveness_probe(), "backend": mesh.backend}

    for name, (engine, res, spp, bounces, tile) in DP_RENDERS.items():
        cfg = RenderConfig(resolution=res, samples_per_pixel=spp, max_bounces=bounces,
                           camera=camera, engine=engine)
        arrays[f"dp_{name}"] = render_image_dp(scene, cfg, mesh=mesh, tile_size=tile).numpy()
        mine[f"slab_{name}"] = render_rank_slab(
            scene, prng_key(cfg.seed, "cpu"), camera, res, spp, bounces, mesh.rank,
            mesh.world_size, engine=engine, world=world, tile_size=tile).numpy()

    sp = SAMPLE_PARALLEL
    arrays["sample_parallel"] = render_accumulate_sample_parallel(
        scene, prng_key(sp["seed"], "cpu"), camera, RES, sp["n_samples"], sp["max_bounces"],
        mesh, world=world, tile_size=sp["tile_size"]).numpy()

    n = RES[0] * RES[1]
    for name, (chunks, names, parity) in STEPS.items():
        step = make_sharded_train_step(scene, camera, RES, mesh=mesh, overlap_chunks=chunks,
                                       parity=parity, **STEP_KW)
        loss, new = step(extract_params(scene, names), torch.full((n, 3), STEP_TARGET),
                         prng_key(STEP_SEED, "cpu"))
        meta[f"loss_{name}"] = float(loss)
        for k, v in new.items():
            arrays[f"step_{name}_{k}"] = v.numpy()

    cfg = RenderConfig(resolution=RES, samples_per_pixel=1, max_bounces=2, camera=camera,
                       engine="mxu")
    meta["scaling"] = scaling_report(scene, cfg, device_counts=[1, 2], repeats=1)

    np.savez(f"{out_prefix}.rank{mesh.rank}.npz", **mine)
    if mesh.rank == 0:
        np.savez(f"{out_prefix}.npz", **arrays)
        with open(f"{out_prefix}.json", "w") as f:
            json.dump(meta, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    (ring_main if sys.argv[2:3] == ["ring"] else main)(sys.argv[1])
