"""Minimal Wavefront OBJ loader (the port's copy of
``pathtracerap_tpu/io/obj.py``): pure Python, or the native library's
parser (:mod:`..native`), which gives the same arrays.

The reference imports meshes through Assimp and asserts every face is a
triangle (``Scene.cpp:229,281``).  Mirrored import semantics: positions
and normals are both scaled by ``BASE_MODEL_SCALE`` (``Scene.cpp:255-262``;
the shading rule re-normalizes), a vertex is a unique (position, normal)
index pair, and faces that are not triangles are rejected.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from .. import constants


@dataclasses.dataclass
class ObjMesh:
    """A triangle mesh as parallel numpy arrays (host side)."""

    positions: np.ndarray  # (V, 3) float32
    normals: np.ndarray  # (V, 3) float32 (zero if the file had no normals)
    uvs: np.ndarray  # (V, 2) float32
    triangles: np.ndarray  # (T, 3) int32 indices into positions/normals
    bbox_min: np.ndarray  # (3,) float32
    bbox_max: np.ndarray  # (3,) float32

    @property
    def num_vertices(self) -> int:
        return int(self.positions.shape[0])

    @property
    def num_triangles(self) -> int:
        return int(self.triangles.shape[0])


def load_obj(path: str, scale: float = constants.BASE_MODEL_SCALE,
             backend: str = "auto") -> ObjMesh:
    """Parse a pre-triangulated OBJ file; ``ValueError`` on a face that is
    not a triangle.

    ``backend``: ``"auto"`` uses the native C++ parser when the library
    loads (:mod:`..native`) and pure Python otherwise; ``"native"``
    requires it (``RuntimeError`` when it does not load); ``"python"``
    forces the pure-Python path.  Both give the same arrays.  A missing
    file raises ``FileNotFoundError``, except under ``"native"``, whose
    parser raises ``ValueError`` as JAX's does."""
    from .. import native

    if native.use(backend, "OBJ") and (backend == "native" or os.path.isfile(path)):
        pos, nrm, uv, tris, bbmin, bbmax = native.load_obj_native(path, float(scale))
        return ObjMesh(positions=pos, normals=nrm, uvs=uv, triangles=tris, bbox_min=bbmin,
                       bbox_max=bbmax)
    raw_v, raw_vn, raw_vt = [], [], []
    corner_map: dict = {}
    positions, normals, uvs, triangles = [], [], [], []

    def corner_index(token: str) -> int:
        if token in corner_map:
            return corner_map[token]
        parts = token.split("/")
        vi = int(parts[0])
        vi = vi - 1 if vi > 0 else len(raw_v) + vi
        ti, ni = 0, -1
        if len(parts) > 1 and parts[1]:
            t = int(parts[1])
            ti = t - 1 if t > 0 else len(raw_vt) + t
        if len(parts) > 2 and parts[2]:
            n = int(parts[2])
            ni = n - 1 if n > 0 else len(raw_vn) + n
        idx = len(positions)
        positions.append(raw_v[vi])
        normals.append(raw_vn[ni] if ni >= 0 else (0.0, 0.0, 0.0))
        uvs.append(raw_vt[ti] if raw_vt and len(parts) > 1 and parts[1] else (0.0, 0.0))
        corner_map[token] = idx
        return idx

    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tok = line.split()
            if tok[0] == "v":
                raw_v.append((float(tok[1]), float(tok[2]), float(tok[3])))
            elif tok[0] == "vn":
                raw_vn.append((float(tok[1]), float(tok[2]), float(tok[3])))
            elif tok[0] == "vt":
                raw_vt.append((float(tok[1]), float(tok[2])))
            elif tok[0] == "f":
                if len(tok) != 4:
                    raise ValueError(
                        f"{path}: face with {len(tok) - 1} corners; only "
                        "pre-triangulated OBJs are supported (Scene.cpp:281)"
                    )
                triangles.append(tuple(corner_index(t) for t in tok[1:4]))
            # everything else (mtllib, usemtl, o, g, s, ...) is ignored

    pos = np.asarray(positions, dtype=np.float32) * np.float32(scale)
    nrm = np.asarray(normals, dtype=np.float32) * np.float32(scale)
    if pos.size == 0:
        raise ValueError(f"{path}: no vertices")
    return ObjMesh(
        positions=pos, normals=nrm, uvs=np.asarray(uvs, dtype=np.float32),
        triangles=np.asarray(triangles, dtype=np.int32),
        bbox_min=pos.min(axis=0), bbox_max=pos.max(axis=0),
    )
