"""A multi-process dry run of the sharded train step:

    python -m pathtracerap_tpu_torch.parallel.dryrun [--ranks N] [--device cuda|cpu]

The port's counterpart of ``__graft_entry__.py::dryrun_multichip``: one
sharded inverse-rendering step (:func:`..diff.grad.make_sharded_train_step`,
``overlap_chunks=2``, ``mat_color`` and ``vertex_pos``) on the Cornell box
at 32x16 over N ranks, held against the single-process sum-loss gradient;
then its geometry half (:func:`geometry_half`): the geometry ring's image
against the replicated ``pallas`` render, one ring ``mat_color`` step, and
the re-baking ``vertex_pos`` ring step against the single-process
gradient.
It runs on the card (each rank on ``cuda:{LOCAL_RANK % device_count}``,
under ``nccl`` where every rank has a card of its own and ``gloo`` where
they share one) unless ``--device cpu`` asks for the CPU (``gloo``); with
no card and no ``--device cpu`` it exits non-zero.  Run without torchrun's
variables it starts the N rank processes itself on a free localhost port,
each with a deadline; under ``torchrun --nproc-per-node N`` every process
is one rank.  Exits non-zero if any rank fails.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from typing import Callable, List, Optional, Sequence, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
RESOLUTION = (32, 16)
N_SAMPLES, MAX_BOUNCES, LR = 2, 3, 0.05
# the Cornell box's camera in the dry run (CameraConfig's arguments)
CAMERA = dict(position=(0.0, 0.0, 150.0), plane_x=(-40.0, 40.0), plane_y=(-30.0, 30.0),
              plane_z=100.0)


def free_port() -> int:
    """A localhost port that was free when asked (bound to port 0)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_local_ranks(argv_of_rank: Callable[[int], Sequence[str]], n: int, timeout: float = 120.0,
                    env: Optional[dict] = None, cwd: Optional[str] = None) -> List[Tuple[int, str]]:
    """Start ``n`` rank processes on this host (``argv_of_rank(r)`` each)
    with torchrun's variables for a fresh localhost rendezvous, wait for
    all of them within ``timeout`` seconds in total, and kill whatever is
    left at the deadline (its code is then -9).  Returns each rank's
    (return code, stdout and stderr)."""
    port = free_port()
    procs = []
    for r in range(n):
        rank_env = {**(os.environ if env is None else env), "RANK": str(r),
                    "LOCAL_RANK": str(r), "WORLD_SIZE": str(n), "LOCAL_WORLD_SIZE": str(n),
                    "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
        procs.append(subprocess.Popen(list(argv_of_rank(r)), env=rank_env, cwd=cwd,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + timeout
    out = []
    try:
        for p in procs:
            try:
                text, _ = p.communicate(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                text, _ = p.communicate()
                text += f"\n[killed after {timeout} s]"
            out.append((p.returncode, text))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def geometry_half(scene, camera, mesh) -> dict:
    """The geometry ring's part of the dry run on ``mesh``
    (``__graft_entry__.py:124-187``): the fused ring's 16x8 image (1 spp, 2
    bounces, 16-ray tiles) equal to the replicated per-bounce ``pallas``
    render bit for bit; one ring ``mat_color`` step at 32x16 that moves the
    parameters; and the re-baking ring step on ``mat_color`` and
    ``vertex_pos`` in quality mode against the single-process sum loss
    (loss rtol 1e-5, parameters rtol 1e-4 / atol 1e-6).  Raises on a failed
    check."""
    import numpy as np
    import torch

    from ..config import RenderConfig
    from ..diff.grad import extract_params, loss_and_grad
    from ..ops.rng import prng_key
    from ..render.wavefront import render_accumulate
    from .geometry import make_geometry_sharded_train_step, render_image_geometry_sharded

    dev = scene.device
    cfg = RenderConfig(resolution=(16, 8), samples_per_pixel=1, max_bounces=2, camera=camera,
                       engine="pallas")
    img = render_image_geometry_sharded(scene, cfg, mesh=mesh, tile_size=16)
    if not (torch.isfinite(img).all() and img.max() > 0.0):
        raise RuntimeError("the ring image is not finite and positive")
    ref = render_accumulate(scene, prng_key(cfg.seed, dev), camera, cfg.resolution, 1, 2,
                            engine="pallas", tile_size=16).reshape(img.shape)
    if not torch.equal(img, ref):
        raise RuntimeError("the ring image differs from the replicated pallas render")
    n = RESOLUTION[0] * RESOLUTION[1]
    tile = n // mesh.world_size // 2
    target = torch.zeros((n, 3), device=dev)
    key = prng_key(0, dev)
    gstep = make_geometry_sharded_train_step(scene, camera, RESOLUTION, 1, 2, mesh=mesh,
                                             tile_size=tile)
    gparams = extract_params(scene, ("mat_color",))
    gloss, gnew = gstep(gparams, target, key)
    delta = float((gnew["mat_color"] - gparams["mat_color"]).abs().sum())
    if not (torch.isfinite(gloss) and delta > 0.0):
        raise RuntimeError("the ring mat_color step is not finite or does not move")
    vstep = make_geometry_sharded_train_step(scene, camera, RESOLUTION, 1, 2, mesh=mesh,
                                             tile_size=tile, parity=False,
                                             param_names=("mat_color", "vertex_pos"))
    vparams = extract_params(scene, ("mat_color", "vertex_pos"))
    vloss, vnew = vstep(vparams, target, key)
    vloss1, vg1 = loss_and_grad(vparams, scene, target, key, camera, RESOLUTION, 1, 2,
                                tile_size=tile, reduce="sum", parity=False)
    np.testing.assert_allclose(float(vloss), float(vloss1), rtol=1e-5)
    vmax = float(vg1["vertex_pos"].abs().max())
    if not vmax > 0.0:
        raise RuntimeError("the vertex_pos gradient is identically zero")
    for k in vparams:
        np.testing.assert_allclose(vnew[k].cpu().numpy(),
                                   (vparams[k] - LR * vg1[k]).cpu().numpy(), rtol=1e-4, atol=1e-6)
    return {"ring_image_equal": True, "ring_image_mean": float(img.mean()),
            "ring_step_loss": float(gloss), "ring_step_delta": delta,
            "ring_vertex_loss": float(vloss), "ring_vertex_single_process_loss": float(vloss1),
            "ring_vertex_max_grad": vmax}


def rank_main(device: str = "cuda") -> dict:
    """One rank of the dry run on ``device`` (``"cuda"``: this rank's card);
    returns its summary (raises on a failed check)."""
    import numpy as np
    import torch

    from ..config import CameraConfig
    from ..diff.grad import extract_params, loss_and_grad, make_sharded_train_step
    from ..ops.rng import prng_key
    from ..scene.build import build_cornell_box_scene
    from .distributed import init_distributed
    from .sharding import default_mesh, rank_device

    dev = rank_device() if device == "cuda" else torch.device(device)
    info = init_distributed(device=dev)
    mesh = default_mesh(dev)
    scene = build_cornell_box_scene().to_device(dev)
    camera = CameraConfig(**CAMERA)
    n = RESOLUTION[0] * RESOLUTION[1]
    tile = n // mesh.world_size // 2
    step = make_sharded_train_step(scene, camera, RESOLUTION, N_SAMPLES, MAX_BOUNCES, mesh,
                                   lr=LR, tile_size=tile, overlap_chunks=2)
    params = extract_params(scene, ("mat_color", "vertex_pos"))
    target = torch.zeros((n, 3), device=dev)
    key = prng_key(0, dev)
    loss, new = step(params, target, key)
    if not torch.isfinite(loss):
        raise RuntimeError("sharded train step produced a non-finite loss")
    moved = sum(float((new[k] - params[k]).abs().sum()) for k in params)
    if not moved > 0.0:
        raise RuntimeError("sharded gradients are identically zero")
    # the same tiles in one process: the sum loss's gradient
    loss1, g1 = loss_and_grad(params, scene, target, key, camera, RESOLUTION, N_SAMPLES,
                              MAX_BOUNCES, tile_size=tile, reduce="sum")
    np.testing.assert_allclose(float(loss), float(loss1), rtol=1e-5)
    for k in params:
        np.testing.assert_allclose(new[k].cpu().numpy(), (params[k] - LR * g1[k]).cpu().numpy(),
                                   rtol=1e-4, atol=1e-6)
    return {"info": info, "device": str(dev), "backend": mesh.backend, "loss": float(loss),
            "single_process_loss": float(loss1), "params_moved": moved, "tile_size": tile,
            "geometry": geometry_half(scene, camera, mesh)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="pathtracerap_tpu_torch.parallel.dryrun",
                                     description=__doc__)
    parser.add_argument("--ranks", type=int, default=2)
    parser.add_argument("--timeout", type=float, default=120.0,
                        help="seconds the ranks may take together")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where the ranks run: the card (default) or the CPU")
    args = parser.parse_args(argv)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("dryrun: no CUDA device; pass --device cpu to run on the CPU", file=sys.stderr)
            return 1
    if "RANK" in os.environ:
        import torch.distributed as dist

        try:
            res = rank_main(args.device)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        if res["info"]["process_index"] == 0:
            print(json.dumps(res), flush=True)
        return 0
    results = run_local_ranks(
        lambda r: [sys.executable, "-m", "pathtracerap_tpu_torch.parallel.dryrun",
                   "--device", args.device], args.ranks,
        timeout=args.timeout, cwd=ROOT)
    for r, (rc, text) in enumerate(results):
        print(f"--- rank {r}: exit {rc}\n{text}", end="" if text.endswith("\n") else "\n")
    return 0 if all(rc == 0 for rc, _ in results) else 1


if __name__ == "__main__":
    sys.exit(main())
