"""Command-line interface: ``python -m pathtracerap_tpu_torch.cli <cmd>``
(port of ``pathtracerap_tpu/cli.py``, with the same subcommands, flags,
defaults, printed lines and JSON keys).

* ``render``    -- render a scene file (or the built-in reference/cornell
                  scenes) to BMP, with checkpoint/resume and metrics;
                  ``--dp`` splits the rays over the ranks of a process group.
* ``benchmark`` -- throughput measurement, JSON output (``--scaling``,
                  ``--suite``).
* ``invert``    -- inverse rendering: fit material colors to a target image
                  (``--dp``: the sharded train step).
* ``info``      -- print scene statistics.
* ``visualize`` -- first-hit AOV and traversal heatmap BMPs (the grid DDA).

One flag JAX does not need: ``--device`` (default ``cuda``), the port's
counterpart of ``JAX_PLATFORMS``.  Every command runs on the card unless
``--device cpu`` asks for the CPU, and exits non-zero when asked for a card
it does not find.  ``--distributed`` (or ``--dp`` under ``torchrun``) joins
the process group (:func:`.parallel.distributed.init_distributed`); each
rank then uses ``cuda:{LOCAL_RANK % device_count}``, and rank 0 alone
writes files and prints the render's line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch
import torch.distributed as dist


def _load_scene(args):
    """Returns (scene_host, config) honoring scene file + CLI overrides."""
    from .config import RenderConfig
    from .scene.build import build_cornell_box_scene, build_reference_scene

    overrides = {}
    if args.width or args.height:
        w = args.width or 1000
        h = args.height or 800
        overrides["resolution"] = (w, h)
    if args.spp:
        overrides["samples_per_pixel"] = args.spp
    if args.bounces:
        overrides["max_bounces"] = args.bounces
    if args.engine:
        overrides["engine"] = args.engine
    if args.seed is not None:
        overrides["seed"] = args.seed
    if args.samples_per_chunk:
        overrides["samples_per_chunk"] = args.samples_per_chunk
    if getattr(args, "quality", False):
        overrides["parity"] = False

    if args.scene == "reference":
        return build_reference_scene(), RenderConfig(**overrides)
    if args.scene == "cornell":
        from .config import CameraConfig

        overrides.setdefault("resolution", (256, 256))
        overrides.setdefault(
            "camera",
            CameraConfig(
                position=(0.0, 0.0, 150.0),
                plane_x=(-40.0, 40.0),
                plane_y=(-40.0, 40.0),
                plane_z=100.0,
            ),
        )
        return build_cornell_box_scene(), RenderConfig(**overrides)

    from .scene.dsl import load_scene_file, render_config_from_parsed

    parsed = load_scene_file(args.scene)
    return parsed.scene, render_config_from_parsed(parsed, **overrides)


def _add_common(p):
    p.add_argument("--scene", default="reference",
                   help="scene file path, or 'reference' / 'cornell'")
    p.add_argument("--width", type=int, default=0)
    p.add_argument("--height", type=int, default=0)
    p.add_argument("--spp", type=int, default=0)
    p.add_argument("--bounces", type=int, default=0)
    p.add_argument("--engine", default="", choices=["", "parity", "mxu", "pallas", "fused", "binned"])
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--samples-per-chunk", type=int, default=0)
    p.add_argument("--quality", action="store_true",
                   help="quality mode (parity quirks off: cosine factor, "
                        "real SPECULAR/REFRACTIVE BSDFs)")
    p.add_argument("--device", default="cuda",
                   help="device to run on: 'cuda' (default, this rank's card) or 'cpu'")
    # multi-process entry; values default to torchrun's variables
    p.add_argument("--distributed", action="store_true",
                   help="join the torch.distributed process group before device use")
    p.add_argument("--coordinator", default="",
                   help="coordinator host:port (MASTER_ADDR:MASTER_PORT)")
    p.add_argument("--num-processes", type=int, default=0)
    p.add_argument("--process-id", type=int, default=-1)


def _device(args) -> torch.device:
    """The device ``--device`` names; a rank's own card under a process
    group.  Exits non-zero when it names a card that is not there."""
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"--device {args.device}: no CUDA device found "
                             "(pass --device cpu to run on the CPU)")
        if device.index is None and (args.distributed or getattr(args, "dp", False)):
            from .parallel.sharding import rank_device

            device = rank_device()
    return device


def _maybe_init_distributed(args, device):
    """``--distributed`` joins the process group; ``--dp`` joins the one
    torchrun's variables describe (a no-op without them)."""
    if not (args.distributed or getattr(args, "dp", False)):
        return None
    from .parallel.distributed import init_distributed

    owned = not dist.is_initialized()
    info = init_distributed(
        coordinator_address=args.coordinator or None,
        num_processes=args.num_processes or None,
        process_id=args.process_id if args.process_id >= 0 else None,
        device=device,
    )
    args.owns_group = owned and dist.is_initialized()
    if args.distributed and info["process_index"] == 0:
        print(f"[distributed] {json.dumps(info)}", file=sys.stderr, flush=True)
    return info


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def cmd_render(args):
    from .io.bmp import quantize_image, write_bmp
    from .render.wavefront import Renderer
    from .utils.metrics import MetricsLogger

    device = _device(args)
    _maybe_init_distributed(args, device)
    scene, cfg = _load_scene(args)

    if args.distributed or args.dp:
        from .parallel.sharding import default_mesh, render_image_dp

        mesh = default_mesh(device)
        image = render_image_dp(scene.to_device(device), cfg, mesh=mesh,
                                seed=cfg.seed).cpu().numpy()
        if mesh.rank == 0:
            accum = image * cfg.samples_per_pixel
            write_bmp(args.out, quantize_image(accum, cfg.samples_per_pixel),
                      parity=not args.standard_bmp)
            if not args.quiet:
                print(f"wrote {args.out} (DP over {mesh.world_size} devices)")
        return 0
    renderer = Renderer(scene.to_device(device), cfg, device=device)
    metrics = MetricsLogger(cfg, enabled=not args.quiet)
    image = renderer.render(checkpoint_path=args.checkpoint, metrics=metrics)
    image = image.cpu().numpy()
    metrics.finalize(cfg.samples_per_pixel)
    accum = image * cfg.samples_per_pixel
    write_bmp(args.out, quantize_image(accum, cfg.samples_per_pixel), parity=not args.standard_bmp)
    if not args.quiet:
        print(f"wrote {args.out} ({cfg.resolution[0]}x{cfg.resolution[1]}, "
              f"{cfg.samples_per_pixel} spp, engine={cfg.engine})")
    return 0


def cmd_benchmark(args):
    from .utils.profiling import sync_device
    from .render.wavefront import Renderer

    device = _device(args)
    _maybe_init_distributed(args, device)
    scene, cfg = _load_scene(args)

    if args.scaling:
        from .parallel.distributed import scaling_report

        rep = scaling_report(scene.to_device(device), cfg)
        print(json.dumps(rep, indent=2))
        return 0

    if args.suite:
        from .bench_suite import run_suite

        print(json.dumps(run_suite(args.suite, engine=cfg.engine, device=device), indent=2))
        return 0
    renderer = Renderer(scene.to_device(device), cfg, device=device)
    renderer.render()  # warm-up
    sync_device(device)
    times = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        renderer.render()
        sync_device(device)
        times.append(time.perf_counter() - t0)
    w, h = cfg.resolution
    rays = w * h * cfg.samples_per_pixel * cfg.max_bounces
    out = {
        "engine": cfg.engine,
        "resolution": [w, h],
        "spp": cfg.samples_per_pixel,
        "bounces": cfg.max_bounces,
        "best_wall_s": round(min(times), 4),
        "mrays_per_s": round(rays / min(times) / 1e6, 2),
    }
    print(json.dumps(out))
    return 0


def cmd_invert(args):
    from .diff.grad import (
        extract_params,
        make_sharded_train_step,
        make_train_step,
        render_for_params,
    )
    from .io.bmp import read_bmp
    from .ops.rng import prng_key
    from .utils.checkpoint import RenderCheckpoint, load_checkpoint, save_checkpoint

    device = _device(args)
    _maybe_init_distributed(args, device)

    scene, cfg = _load_scene(args)
    dev = scene.to_device(device)
    key = prng_key(cfg.seed, device)
    w, h = cfg.resolution
    n = w * h

    if args.target:
        img = read_bmp(args.target).astype(np.float32) / 255.0
        if img.shape[:2] != (h, w):
            raise SystemExit(f"target is {img.shape[1]}x{img.shape[0]}, render is {w}x{h}")
        target = torch.as_tensor(img.reshape(n, 3), device=device)
    else:
        # self-calibration demo: recover the true colors from a perturbed start
        with torch.no_grad():
            target = render_for_params(
                extract_params(dev, ("mat_color",)), dev, key, cfg.camera,
                cfg.resolution, cfg.samples_per_pixel, cfg.max_bounces,
                parity=cfg.parity,
            )

    params = extract_params(dev, ("mat_color",))
    if not args.target:
        params = {"mat_color": params["mat_color"] * 0.5}

    # the invert config signature a resume must match; the optimizer state
    # rides the checkpoint's ``extra``
    ck_config = {"render": cfg.to_dict(), "lr": args.lr, "dp": bool(args.dp)}
    start = 0
    if args.checkpoint:
        ck = load_checkpoint(args.checkpoint)
        if ck is not None:
            if ck.config != ck_config or ck.seed != cfg.seed:
                raise SystemExit(
                    f"checkpoint {args.checkpoint} was written by a different "
                    "invert config/seed; refusing to resume"
                )
            if not np.allclose(ck.accum, target.cpu().numpy(), atol=1e-6):
                raise SystemExit(
                    f"checkpoint {args.checkpoint} was fit against a "
                    "different target image; refusing to resume"
                )
            params = {k: torch.as_tensor(v, device=device) for k, v in ck.extra.items()}
            start = ck.samples_done
            print(f"resuming from step {start}", flush=True)

    if args.dp:
        from .parallel.sharding import default_mesh

        # the sharded step's loss is the SUM over rays (all-reduced);
        # rescale lr so --dp takes the same SGD steps as the mean-loss
        # path, and print the comparable mean loss
        loss_scale = float(n * 3)
        step = make_sharded_train_step(
            dev, cfg.camera, cfg.resolution, cfg.samples_per_pixel,
            cfg.max_bounces, default_mesh(device), lr=args.lr / loss_scale,
            parity=cfg.parity,
        )
    else:
        loss_scale = 1.0
        step = make_train_step(
            dev, cfg.camera, cfg.resolution, cfg.samples_per_pixel,
            cfg.max_bounces, lr=args.lr, parity=cfg.parity,
        )
    for i in range(start, args.steps):
        loss, params = step(params, target, key)
        print(f"step {i}: loss={float(loss) / loss_scale:.6f}", flush=True)
        if args.checkpoint and _rank() == 0:
            save_checkpoint(
                args.checkpoint,
                RenderCheckpoint(
                    accum=target.cpu().numpy(),
                    samples_done=i + 1,
                    seed=cfg.seed,
                    config=ck_config,
                    extra={k: v.cpu().numpy() for k, v in params.items()},
                ),
            )
    out = params["mat_color"].cpu().numpy()
    print("optimized mat_color:")
    print(np.array2string(out, precision=4))
    return 0


def cmd_visualize(args):
    from .render.debug_viz import write_aov_bmps

    device = _device(args)
    scene, cfg = _load_scene(args)
    paths = write_aov_bmps(scene.to_device(device), cfg, args.out_dir)
    for name, p in sorted(paths.items()):
        print(f"{name}: {p}")
    return 0


def cmd_info(args):
    _device(args)
    scene, cfg = _load_scene(args)
    stats = {
        "models": scene.num_models,
        "meshes": int(scene.mesh_tri_start.shape[0]),
        "triangles": scene.num_triangles,
        "grids": int(scene.grid_mesh.shape[0]),
        "voxels": int(scene.voxel_tri_start.shape[0]),
        "per_voxel_entries": int(scene.per_voxel_tris.shape[0]),
        "ell_width": int(scene.voxel_tris_ell.shape[1]),
        "config": cfg.to_dict(),
    }
    print(json.dumps(stats, indent=2))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="pathtracerap_tpu_torch", description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("render", help="render a scene to BMP")
    _add_common(p)
    p.add_argument("--dp", action="store_true",
                   help="data-parallel render over the ranks of the process group")
    p.add_argument("--out", default="Render.bmp")
    p.add_argument("--checkpoint", default="", help="checkpoint file for resume")
    p.add_argument("--standard-bmp", action="store_true",
                   help="write standards-compliant BMP instead of reference-parity bytes")
    p.add_argument("--quiet", action="store_true")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("benchmark", help="measure render throughput")
    _add_common(p)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--scaling", action="store_true",
                   help="scaling-efficiency table at 1,2,4,... ranks")
    p.add_argument("--suite", default="",
                   help="run a named benchmark suite: 'baseline' = the four "
                        "BASELINE.json forward configs")
    p.set_defaults(fn=cmd_benchmark)

    p = sub.add_parser("invert", help="inverse rendering (fit material colors)")
    _add_common(p)
    p.add_argument("--target", default="", help="target BMP (default: self-demo)")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--dp", action="store_true",
                   help="shard the train step's rays over the ranks of the process "
                        "group (gradient all-reduce per step)")
    p.add_argument("--checkpoint", default="",
                   help="checkpoint file: saves optimizer/params each step, "
                        "resumes a killed run exactly")
    p.set_defaults(fn=cmd_invert)

    p = sub.add_parser("info", help="print scene statistics")
    _add_common(p)
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("visualize",
                       help="write first-hit AOV + traversal heatmap BMPs")
    _add_common(p)
    p.add_argument("--out-dir", default="aovs")
    p.set_defaults(fn=cmd_visualize)

    args = parser.parse_args(argv)
    args.owns_group = False
    try:
        return args.fn(args)
    finally:
        if args.owns_group and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
