"""The benchmark suite's scenes and configs (port of
``pathtracerap_tpu/bench_suite.py``).

Configs (BASELINE.md "Benchmark configs"):
  1. cornell    — Cornell box, diffuse-only, 256x256, 4 bounces, 64 spp
  2. highpoly   — dense OBJ mesh traversal, 512x512, 8 bounces: the
                  committed 147k-triangle ``assets/meshes/highpoly_blob.obj``
                  through the port's OBJ import
  3. metallic   — the reference scene, 1024x1024, 256 spp
  4. multimesh  — multi-mesh mixed-material scene, 1024x1024, 1024 spp
  5. megascene  — a 358,824-triangle sphere in the room: 701 blocks of the
                  fused pack, above JAX's streaming threshold of 313
  6. gridparity — the reference scene on the uniform-grid DDA parity
                  engine (kernel G1), driven as JAX's row drives it:
                  one RNG tile over all the rays

Each config renders ``measure_spp`` samples per pixel and reports Mrays/s
(pixels x spp x bounces over the wall, dead lanes counted) and the wall a
full-spp render would take at that rate.  Timing ends in
``torch.cuda.synchronize()`` on the card.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .config import CameraConfig, RenderConfig
from .scene.build import (
    SceneBuilder,
    build_cornell_box_scene,
    build_reference_scene,
    make_box_mesh,
    make_sphere_mesh,
)
from .scene.types import Material, MaterialType
from .utils.profiling import sync_device

ASSET = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "assets", "meshes",
                     "highpoly_blob.obj")


def build_highpoly_scene(subdiv: int = 192, use_asset: bool = True):
    """A dense OBJ mesh (the committed 147k-triangle displaced sphere) in a
    diffuse room, with an emissive panel; ``use_asset=False`` (or a missing
    asset) puts a synthetic sphere of ``subdiv`` subdivisions there
    instead, as the megascene does."""
    b = SceneBuilder()
    room = b.add_mesh(make_box_mesh(size=(400.0, 400.0, 400.0), inward=True))
    if use_asset and os.path.exists(ASSET):
        ball = b.add_mesh_file(ASSET)
    else:
        ball = b.add_mesh(make_sphere_mesh(radius=80.0, subdiv=subdiv))
    panel = b.add_mesh(make_box_mesh(size=(120.0, 4.0, 120.0)))
    M = MaterialType
    b.add_instance(room, Material(M.DIFFUSE, (0.9, 0.9, 0.9)))
    b.add_instance(ball, Material(M.DIFFUSE, (0.8, 0.3, 0.2)), translate=(0.0, -40.0, 0.0))
    b.add_instance(panel, Material(M.EMISSIVE, (1.0, 1.0, 1.0)), translate=(0.0, 190.0, 0.0))
    return b.build()


def build_multimesh_scene():
    """Mixed materials over several meshes (BASELINE config 4)."""
    b = SceneBuilder()
    room = b.add_mesh(make_box_mesh(size=(400.0, 400.0, 400.0), inward=True))
    ball = b.add_mesh(make_sphere_mesh(radius=50.0, subdiv=48))
    cube = b.add_mesh(make_box_mesh(size=(70.0, 70.0, 70.0)))
    panel = b.add_mesh(make_box_mesh(size=(140.0, 4.0, 140.0)))
    M = MaterialType
    b.add_instance(room, Material(M.DIFFUSE, (0.85, 0.85, 0.85)))
    b.add_instance(ball, Material(M.METAL, (0.9, 0.7, 0.2)), translate=(-90.0, -60.0, 20.0))
    b.add_instance(ball, Material(M.COAT, (0.3, 0.5, 0.9)), translate=(90.0, -60.0, -30.0))
    b.add_instance(cube, Material(M.REFLECTIVE, (0.9, 0.9, 0.9)),
                   translate=(0.0, -120.0, -80.0), rotate_y_deg=30.0)
    b.add_instance(cube, Material(M.DIFFUSE, (0.2, 0.8, 0.3)),
                   translate=(20.0, -120.0, 100.0), rotate_y_deg=-20.0)
    b.add_instance(panel, Material(M.EMISSIVE, (1.0, 1.0, 1.0)), translate=(0.0, 190.0, 0.0))
    return b.build()


_ROOM_CAMERA = CameraConfig(
    position=(0.0, 0.0, 380.0),
    plane_x=(-120.0, 120.0),
    plane_y=(-96.0, 96.0),
    plane_z=240.0,
)
# _ROOM_CAMERA stands outside the 400-unit room, so its rays stop on the front
# wall; this camera stands inside it, facing the sphere, so that rays also
# meet the sphere's triangles
INSIDE_CAMERA = CameraConfig(
    position=(0.0, 0.0, 190.0),
    plane_x=(-60.0, 60.0),
    plane_y=(-48.0, 48.0),
    plane_z=120.0,
)


def suite_configs() -> Dict[str, dict]:
    return {
        "cornell": dict(
            scene=build_cornell_box_scene,
            cfg=dict(resolution=(256, 256), samples_per_pixel=64, max_bounces=4,
                     camera=CameraConfig(position=(0.0, 0.0, 150.0), plane_x=(-40.0, 40.0),
                                         plane_y=(-40.0, 40.0), plane_z=100.0)),
            measure_spp=16,
        ),
        "highpoly": dict(
            scene=build_highpoly_scene,
            cfg=dict(resolution=(512, 512), samples_per_pixel=64, max_bounces=8,
                     camera=_ROOM_CAMERA),
            measure_spp=4,
        ),
        "metallic": dict(
            scene=build_reference_scene,
            cfg=dict(resolution=(1024, 1024), samples_per_pixel=256, max_bounces=5),
            measure_spp=8,
        ),
        "multimesh": dict(
            scene=build_multimesh_scene,
            cfg=dict(resolution=(1024, 1024), samples_per_pixel=1024, max_bounces=5,
                     camera=_ROOM_CAMERA),
            measure_spp=8,
        ),
        "megascene": dict(
            scene=lambda: build_highpoly_scene(subdiv=300, use_asset=False),
            cfg=dict(resolution=(512, 512), samples_per_pixel=64, max_bounces=6,
                     camera=_ROOM_CAMERA),
            measure_spp=2,
        ),
        "gridparity": dict(
            scene=build_reference_scene,
            cfg=dict(resolution=(256, 256), samples_per_pixel=8, max_bounces=5),
            measure_spp=2,
            engine="parity",
        ),
    }


def render_gridparity(scene, cfg: RenderConfig) -> torch.Tensor:
    """The gridparity row's render: the parity engine with one RNG tile
    over all the rays, as JAX's row draws them
    (``pathtracerap_tpu/bench_suite.py::_render_parity_stepwise``; the
    Renderer's tiles are 8192 rays).  Returns the (H, W, 3) image."""
    from .ops.rng import prng_key
    from .render.wavefront import render_accumulate

    w, h = cfg.resolution
    acc = render_accumulate(scene, prng_key(cfg.seed, scene.device), cfg.camera, cfg.resolution,
                            cfg.samples_per_pixel, cfg.max_bounces, engine="parity",
                            parity=cfg.parity, tile_size=w * h)
    return acc.reshape(h, w, 3) / cfg.samples_per_pixel


def run_config(name: str, engine: str = "fused", repeats: int = 2, device="cuda") -> dict:
    """Render config ``name`` at its ``measure_spp`` on ``device``: one
    warm-up render, then the fastest of ``repeats`` timed ones."""
    from .render.wavefront import Renderer

    spec = suite_configs()[name]
    engine = spec.get("engine", engine)
    device = torch.device(device)
    host = spec["scene"]()
    spp = spec["measure_spp"]
    cfg = RenderConfig(engine=engine, **{**spec["cfg"], "samples_per_pixel": spp,
                                         "samples_per_chunk": spp})
    r = Renderer(host.to_device(device), cfg, device=device)
    w, h = cfg.resolution
    render = (lambda: render_gridparity(r.scene, cfg)) if engine == "parity" else r.render
    img = render()  # warm-up
    best = float("inf")
    for _ in range(repeats):
        sync_device(device)
        t0 = time.perf_counter()
        img = render()
        sync_device(device)
        best = min(best, time.perf_counter() - t0)
    full_spp = spec["cfg"].get("samples_per_pixel", spp)
    return {
        "config": name,
        "engine": r.engine,
        "resolution": [w, h],
        "full_spp": full_spp,
        "measured_spp": spp,
        "bounces": cfg.max_bounces,
        "triangles": host.num_triangles,
        "wall_s": best,
        "mrays_per_s": w * h * spp * cfg.max_bounces / best / 1e6,
        "projected_full_render_s": best * full_spp / spp,
        "image_mean": float(np.asarray(img.cpu()).mean()),
    }


def run_suite(which: str = "baseline", engine: str = "fused",
              names: Optional[List[str]] = None, device="cuda") -> dict:
    if which != "baseline":
        raise ValueError(f"unknown suite {which!r}; only 'baseline' exists")
    device = torch.device(device)
    names = names or list(suite_configs().keys())
    return {
        "suite": which,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else str(device),
        "configs": [run_config(n, engine=engine, device=device) for n in names],
    }
