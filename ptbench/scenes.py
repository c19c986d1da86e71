"""Scene inputs made from a configuration file, handed alike to the
program and to the plain reference.

A configuration (``ptbench/configs/<name>.json``) lists meshes (an OBJ file
of the checkout with its SHA-256, or an axis-aligned box of given size) and
instances (a mesh, a material and a translate / rotate-about-y / scale
transform).  :func:`scene_inputs` reads it into plain NumPy arrays;
:func:`port_scene` gives the same arrays to the program's ``SceneBuilder``;
:mod:`ptbench.reference.world` bakes them itself.

OBJ import follows the upstream renderer's (``Scene.cpp:229-281``):
positions and normals scaled by 1000, a vertex per distinct corner token,
triangles only.  Transforms are glm's ``T * R * S`` in float64, stored as
float32.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import os
from typing import Dict, List

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # the checkout
OBJ_SCALE = 1000.0  # Config.h:17 BASE_MODEL_SCALE

# the upstream material enum (Primitive.h:70-79)
MATERIALS = {
    "DIFFUSE": 0, "SPECULAR": 1, "REFLECTIVE": 2, "REFRACTIVE": 3, "EMISSIVE": 4, "COAT": 5,
    "METAL": 6,
}


@dataclasses.dataclass
class Mesh:
    positions: np.ndarray  # (V, 3) float32
    normals: np.ndarray  # (V, 3) float32
    triangles: np.ndarray  # (T, 3) int32


@dataclasses.dataclass
class SceneInputs:
    """Meshes and instances of one configuration, as plain arrays."""

    meshes: List[Mesh]
    instance_mesh: np.ndarray  # (I,) int32
    transform: np.ndarray  # (I, 4, 4) float64, as composed
    mat_type: np.ndarray  # (I,) int32
    mat_color: np.ndarray  # (I, 3) float32

    @property
    def model_to_world(self) -> np.ndarray:
        """(I, 4, 4) float32, as the renderer stores it."""
        return self.transform.astype(np.float32)

    @property
    def num_triangles(self) -> int:
        return int(sum(self.meshes[m].triangles.shape[0] for m in self.instance_mesh))


def load_obj(path: str, scale: float = OBJ_SCALE) -> Mesh:
    """A pre-triangulated OBJ; ``ValueError`` on any other face."""
    raw_v, raw_vn, corner, pos, nrm, tris = [], [], {}, [], [], []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            if tok[0] == "v":
                raw_v.append(tuple(float(x) for x in tok[1:4]))
            elif tok[0] == "vn":
                raw_vn.append(tuple(float(x) for x in tok[1:4]))
            elif tok[0] == "f":
                if len(tok) != 4:
                    raise ValueError(f"{path}: a face of {len(tok) - 1} corners")
                face = []
                for c in tok[1:]:
                    if c not in corner:
                        parts = c.split("/")
                        vi = int(parts[0])
                        vi = vi - 1 if vi > 0 else len(raw_v) + vi
                        ni = -1
                        if len(parts) > 2 and parts[2]:
                            ni = int(parts[2])
                            ni = ni - 1 if ni > 0 else len(raw_vn) + ni
                        corner[c] = len(pos)
                        pos.append(raw_v[vi])
                        nrm.append(raw_vn[ni] if ni >= 0 else (0.0, 0.0, 0.0))
                    face.append(corner[c])
                tris.append(face)
    return Mesh(
        positions=np.asarray(pos, np.float32) * np.float32(scale),
        normals=np.asarray(nrm, np.float32) * np.float32(scale),
        triangles=np.asarray(tris, np.int32),
    )


def box_mesh(size) -> Mesh:
    """An axis-aligned box centred at the origin: 6 faces of two triangles,
    each vertex carrying its face's unit normal (outward winding)."""
    sx, sy, sz = (s / 2.0 for s in size)
    c = np.array(
        [[-sx, -sy, -sz], [sx, -sy, -sz], [sx, sy, -sz], [-sx, sy, -sz],
         [-sx, -sy, sz], [sx, -sy, sz], [sx, sy, sz], [-sx, sy, sz]],
        np.float32,
    )
    faces = [(0, 1, 2, 3), (5, 4, 7, 6), (4, 0, 3, 7), (1, 5, 6, 2), (4, 5, 1, 0), (3, 2, 6, 7)]
    pos, nrm, tris = [], [], []
    for k, (i0, i1, i2, _i3) in enumerate(faces):
        quad = c[list(faces[k])]
        n = np.cross(c[i1] - c[i0], c[i2] - c[i0])
        n = (n / np.linalg.norm(n)).astype(np.float32)
        pos.append(quad)
        nrm.append(np.tile(n, (4, 1)))
        tris.append(np.array([[0, 1, 2], [0, 2, 3]], np.int32) + 4 * k)
    return Mesh(np.concatenate(pos), np.concatenate(nrm), np.concatenate(tris).astype(np.int32))


def trs(translate, rotate_y_deg: float, scale) -> np.ndarray:
    """glm's ``T * Ry * S`` in float64."""
    r = math.radians(rotate_y_deg)
    c, s = math.cos(r), math.sin(r)
    m = np.eye(4)
    m[:3, :3] = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]]) @ np.diag(scale)
    m[:3, 3] = translate
    return m


def checked_path(root: str, spec: Dict) -> str:
    """The OBJ file of a mesh entry, relative to the checkout ``root``;
    ``ValueError`` where its contents are not the ones the configuration
    was measured on."""
    path = os.path.join(root, spec["obj"])
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    if digest != spec["sha256"]:
        raise ValueError(f"{spec['obj']}: SHA-256 {digest}, the configuration's {spec['sha256']}")
    return path


def scene_inputs(config: Dict, root: str = ROOT) -> SceneInputs:
    """The inputs of ``config``; OBJ paths are relative to the checkout ``root``."""
    names = list(config["meshes"])
    meshes = []
    for name in names:
        spec = config["meshes"][name]
        if "obj" in spec:
            meshes.append(load_obj(checked_path(root, spec)))
        else:
            meshes.append(box_mesh(spec["box"]))
    inst = config["instances"]
    return SceneInputs(
        meshes=meshes,
        instance_mesh=np.array([names.index(i["mesh"]) for i in inst], np.int32),
        transform=np.stack(
            [trs(i.get("translate", (0.0, 0.0, 0.0)), i.get("rotate_y_deg", 0.0),
                 i.get("scale", (1.0, 1.0, 1.0))) for i in inst]
        ),
        mat_type=np.array([MATERIALS[i["material"]] for i in inst], np.int32),
        mat_color=np.array([i["color"] for i in inst], np.float32),
    )


def port_scene(inputs: SceneInputs):
    """The program's ``SceneHost`` of these inputs, through its
    ``SceneBuilder``: the same meshes, transforms and materials."""
    from pathtracerap_tpu_torch.io.obj import ObjMesh
    from pathtracerap_tpu_torch.scene.build import SceneBuilder
    from pathtracerap_tpu_torch.scene.types import Material, MaterialType

    b = SceneBuilder()
    for m in inputs.meshes:
        b.add_mesh(ObjMesh(positions=m.positions, normals=m.normals,
                           uvs=np.zeros((m.positions.shape[0], 2), np.float32),
                           triangles=m.triangles, bbox_min=m.positions.min(axis=0),
                           bbox_max=m.positions.max(axis=0)))
    for i in range(inputs.instance_mesh.shape[0]):
        b.add_instance(int(inputs.instance_mesh[i]),
                       Material(MaterialType(int(inputs.mat_type[i])),
                                tuple(float(x) for x in inputs.mat_color[i])),
                       transform=inputs.transform[i])
    return b.build()
