"""Text scene description language (port of ``pathtracerap_tpu/scene/dsl.py``).

The reference ships ``Config.txt`` sketching a block-based scene format
(SPHERE/BOX/MESH entity blocks with transforms, material blocks —
``Config.txt:1-31``) that **no code parses**; ``main()``'s config string is
likewise dead (``main.cpp:14``, ``Scene.cpp:3`` ignores it).  This module
implements that format for real (modernized to ``key: value`` fields, which
the sketch's ``translate:[...]`` lines already use):

    # comment
    DIFFUSE white
    color: [0.99, 0.99, 0.99]

    EMISSIVE lamp
    color: [0.99, 0.99, 0.99]

    MESH monkey
    file: blender_monkey.obj
    translate: [-50, -25, 150]
    rotateY: 45
    scale: [0.08, 0.08, 0.08]
    material: white

    BOX floor
    min: [-1, -1, -1]
    max: [1, 1, 1]
    material: white

    SPHERE ball
    radius: 5
    subdiv: 12
    material: lamp

    CAMERA
    position: [0, 0, 920]
    plane_x: [-10, 10]
    plane_y: [-4, 12]
    plane_z: 900

    RENDER
    resolution: [1000, 800]
    spp: 500
    bounces: 5

Entity blocks become mesh+instance pairs; material blocks define named
materials (DIFFUSE/SPECULAR/REFLECTIVE/REFRACTIVE/EMISSIVE/COAT/METAL,
matching the reference enum ``Primitive.h:70-79``).  Transform composition
is glm-style T * Rz * Ry * Rx * S.  MESH files are OBJ (the port has no
PLY reader yet).
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, Optional, Tuple

import numpy as np

from .. import constants
from ..config import CameraConfig, RenderConfig
from .build import (
    SceneBuilder,
    make_box_mesh,
    make_sphere_mesh,
    rotation_x_matrix,
    rotation_y_matrix,
    rotation_z_matrix,
    scale_matrix,
    translation_matrix,
)
from .types import Material, MaterialType, SceneHost

_MATERIAL_KINDS = {m.name: m for m in MaterialType}
_ENTITY_KINDS = ("MESH", "BOX", "SPHERE")
_SPECIAL_BLOCKS = ("CAMERA", "RENDER")


class SceneParseError(ValueError):
    pass


@dataclasses.dataclass
class ParsedScene:
    scene: SceneHost
    camera: Optional[CameraConfig]
    render: dict


def _parse_value(text: str):
    text = text.strip()
    # lowercase booleans first: ast.literal_eval only knows True/False,
    # and falling through to the bare-string path made `quality: false`
    # TRUTHY (bool("false") is True) — silently enabling the mode it
    # asked to disable
    low = text.lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text  # bare identifiers (material names, file paths)


def _blocks(source: str):
    """Split into (kind, name, fields) blocks."""
    cur = None
    for lineno, raw in enumerate(source.splitlines(), 1):
        line = raw.split("#", 1)[0].split("//", 1)[0].strip()
        if not line:
            continue
        head = line.split()
        kind = head[0].upper()
        if kind in _MATERIAL_KINDS or kind in _ENTITY_KINDS or kind in _SPECIAL_BLOCKS:
            if cur:
                yield cur
            name = head[1] if len(head) > 1 else None
            cur = (kind, name, {}, lineno)
        else:
            if cur is None:
                raise SceneParseError(f"line {lineno}: field outside any block: {raw!r}")
            if ":" not in line:
                raise SceneParseError(f"line {lineno}: expected 'key: value', got {raw!r}")
            k, v = line.split(":", 1)
            cur[2][k.strip().lower()] = _parse_value(v)
    if cur:
        yield cur


def _transform_from_fields(f: dict) -> np.ndarray:
    m = np.eye(4)
    if "scale" in f:
        s = f["scale"]
        s = (s, s, s) if isinstance(s, (int, float)) else tuple(s)
        m = scale_matrix(s) @ m
    if "rotatex" in f:
        m = rotation_x_matrix(float(f["rotatex"])) @ m
    if "rotatey" in f:
        m = rotation_y_matrix(float(f["rotatey"])) @ m
    if "rotatez" in f:
        m = rotation_z_matrix(float(f["rotatez"])) @ m
    if "translate" in f:
        m = translation_matrix(tuple(f["translate"])) @ m
    return m


def parse_scene(
    source: str,
    base_dir: str = ".",
    grid_dims: Tuple[int, int, int] = (25, 25, 25),
) -> ParsedScene:
    """Parse scene text into a built SceneHost + optional camera/render cfg."""
    materials: Dict[str, Material] = {}
    builder = SceneBuilder(grid_dims=grid_dims)
    mesh_cache: Dict[str, int] = {}
    camera = None
    render: dict = {}
    n_instances = 0

    for kind, name, fields, lineno in _blocks(source):
        if kind in _MATERIAL_KINDS:
            if name is None:
                raise SceneParseError(f"line {lineno}: material block needs a name")
            color = tuple(fields.get("color", (0.9, 0.9, 0.9)))
            materials[name] = Material(
                _MATERIAL_KINDS[kind],
                color,
                refractive_index=float(fields.get("refractive_index", 1.0)),
                reflectivity=float(fields.get("reflectivity", 0.0)),
            )
        elif kind in _ENTITY_KINDS:
            mat_name = fields.get("material")
            if mat_name is None:
                raise SceneParseError(f"line {lineno}: entity {name!r} needs material:")
            if mat_name not in materials:
                raise SceneParseError(
                    f"line {lineno}: unknown material {mat_name!r} "
                    f"(defined: {sorted(materials)})"
                )
            if kind == "MESH":
                path = fields.get("file")
                if path is None:
                    raise SceneParseError(f"line {lineno}: MESH {name!r} needs file:")
                full = path if os.path.isabs(path) else os.path.join(base_dir, path)
                ck = ("mesh", full, float(fields.get("import_scale", constants.BASE_MODEL_SCALE)))
                if ck not in mesh_cache:
                    mesh_cache[ck] = builder.add_mesh_file(full, scale=ck[2])
                mesh_id = mesh_cache[ck]
            elif kind == "BOX":
                lo = np.asarray(fields.get("min", (-0.5, -0.5, -0.5)), np.float64)
                hi = np.asarray(fields.get("max", (0.5, 0.5, 0.5)), np.float64)
                size = tuple(hi - lo)
                center = tuple((hi + lo) / 2.0)
                ck = ("box", tuple(size), tuple(center))
                if ck not in mesh_cache:
                    mesh = make_box_mesh(size)
                    mesh.positions += np.asarray(center, np.float32)
                    mesh.bbox_min = mesh.positions.min(axis=0)
                    mesh.bbox_max = mesh.positions.max(axis=0)
                    mesh_cache[ck] = builder.add_mesh(mesh)
                mesh_id = mesh_cache[ck]
            else:  # SPHERE
                radius = float(fields.get("radius", 1.0))
                subdiv = int(fields.get("subdiv", 16))
                ck = ("sphere", radius, subdiv)
                if ck not in mesh_cache:
                    mesh_cache[ck] = builder.add_mesh(make_sphere_mesh(radius, subdiv))
                mesh_id = mesh_cache[ck]
            builder.add_instance(
                mesh_id, materials[mat_name], transform=_transform_from_fields(fields)
            )
            n_instances += 1
        elif kind == "CAMERA":
            camera = CameraConfig(
                position=tuple(fields.get("position", (0.0, 0.0, 920.0))),
                plane_x=tuple(fields.get("plane_x", (-10.0, 10.0))),
                plane_y=tuple(fields.get("plane_y", (-4.0, 12.0))),
                plane_z=float(fields.get("plane_z", 900.0)),
                jitter=bool(fields.get("jitter", False)),
            )
        elif kind == "RENDER":
            render = dict(fields)

    if n_instances == 0:
        raise SceneParseError("scene has no entity blocks")
    return ParsedScene(scene=builder.build(), camera=camera, render=render)


def load_scene_file(path: str, grid_dims=(25, 25, 25)) -> ParsedScene:
    with open(path, "r", encoding="utf-8") as f:
        return parse_scene(f.read(), base_dir=os.path.dirname(os.path.abspath(path)),
                           grid_dims=grid_dims)


def render_config_from_parsed(p: ParsedScene, **overrides) -> RenderConfig:
    """Fold the RENDER/CAMERA blocks into a RenderConfig."""
    kw = {}
    r = p.render
    if "resolution" in r:
        kw["resolution"] = tuple(r["resolution"])
    if "spp" in r:
        kw["samples_per_pixel"] = int(r["spp"])
    if "bounces" in r:
        kw["max_bounces"] = int(r["bounces"])
    if "engine" in r:
        kw["engine"] = str(r["engine"])
    if "quality" in r:
        # quality mode: parity quirks off — AA jitter stays a CAMERA-block
        # choice, but SPECULAR/REFRACTIVE get real BSDFs (r5) and diffuse
        # the cosine factor (render/shade.py)
        kw["parity"] = not bool(r["quality"])
    if p.camera is not None:
        kw["camera"] = p.camera
    kw.update(overrides)
    return RenderConfig(**kw)
