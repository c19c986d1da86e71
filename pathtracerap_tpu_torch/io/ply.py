"""Minimal Stanford PLY loader, ASCII and binary little/big endian (the
port's copy of ``pathtracerap_tpu/io/ply.py``, pure numpy).

The reference imports meshes through Assimp (``Scene.cpp:226-238``), whose
format coverage includes PLY — the format the Stanford scans referenced by
the dead code paths (bunny/armadillo/dragon, ``Scene.cpp:18-28``) ship in.
BASELINE config 4 calls for "multi-mesh assimp-imported" scenes; together
with the OBJ subset parser (``io/obj.py``) this covers the formats the
reference's asset set actually uses.

Supported subset:

* ``element vertex`` with at least ``x y z`` properties (any numeric type);
  ``nx ny nz`` and ``u v`` / ``s t`` are picked up when present, other
  properties are skipped;
* ``element face`` with a ``list <count_t> <index_t> vertex_indices``
  property (``vertex_index`` also accepted);
* polygons are fan-triangulated (Assimp's ``aiProcess_Triangulate``
  behavior; the reference's OBJ path instead *asserts* triangles,
  ``Scene.cpp:281`` — PLY scans routinely contain quads, so rejecting them
  here would be gratuitous).

Import-time semantics match :func:`.obj.load_obj`: positions and normals
are scaled by ``BASE_MODEL_SCALE`` (``Scene.cpp:255-262``).
"""

from __future__ import annotations

import struct

import numpy as np

from .. import constants
from .obj import ObjMesh

_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


class PlyParseError(ValueError):
    pass


def _parse_header(f) -> dict:
    magic = f.readline().strip()
    if magic != b"ply":
        raise PlyParseError("not a PLY file (missing 'ply' magic)")
    fmt = None
    elements = []  # [{name, count, props: [(name, type) | (name, 'list', ct, it)]}]
    while True:
        line = f.readline()
        if not line:
            raise PlyParseError("unexpected EOF in header")
        tok = line.decode("ascii", "replace").strip().split()
        if not tok or tok[0] == "comment" or tok[0] == "obj_info":
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            elements.append({"name": tok[1], "count": int(tok[2]), "props": []})
        elif tok[0] == "property":
            if not elements:
                raise PlyParseError("property before element")
            if tok[1] == "list":
                elements[-1]["props"].append((tok[4], "list", _TYPES[tok[2]], _TYPES[tok[3]]))
            else:
                elements[-1]["props"].append((tok[2], _TYPES[tok[1]]))
        elif tok[0] == "end_header":
            break
        else:
            raise PlyParseError(f"unknown header line: {' '.join(tok)}")
    if fmt not in ("ascii", "binary_little_endian", "binary_big_endian"):
        raise PlyParseError(f"unsupported format {fmt!r}")
    return {"format": fmt, "elements": elements}


def _read_vertices_ascii(f, el):
    rows = np.loadtxt(
        (f.readline() for _ in range(el["count"])), dtype=np.float64, ndmin=2
    )
    names = [p[0] for p in el["props"]]
    return rows, names


def _read_vertices_binary(f, el, endian):
    if any(p[1] == "list" for p in el["props"]):
        raise PlyParseError("list property on vertex element unsupported")
    dt = np.dtype([(p[0], endian + p[1]) for p in el["props"]])
    buf = f.read(dt.itemsize * el["count"])
    arr = np.frombuffer(buf, dtype=dt, count=el["count"])
    names = [p[0] for p in el["props"]]
    rows = np.stack([arr[n].astype(np.float64) for n in names], axis=1)
    return rows, names


def _check_face_props(el):
    """The face element must carry exactly one property: the
    ``vertex_indices`` list.  Both readers validate identically — a
    header-legal scalar property before the list would otherwise be
    silently misparsed into garbage indices by the ascii path (ADVICE r3)."""
    lp = [p for p in el["props"] if p[1] == "list"]
    if len(lp) != 1 or lp[0][0] not in ("vertex_indices", "vertex_index"):
        raise PlyParseError("face element needs a vertex_indices list property")
    if len(el["props"]) != 1:
        raise PlyParseError("extra face properties unsupported")
    return lp[0]


def _fan_triangulate(counts, flat_idx):
    """Fan-triangulate variable-count faces given per-face vertex counts and
    the flattened index stream; vectorized for the all-triangles case."""
    counts = np.asarray(counts, dtype=np.int64)
    flat_idx = np.asarray(flat_idx, dtype=np.int64)
    if counts.size == 0:
        return []
    if np.all(counts == 3):
        return flat_idx.reshape(-1, 3)
    tris = []
    off = 0
    for k in counts:
        idx = flat_idx[off : off + k]
        off += k
        for j in range(1, k - 1):
            tris.append((idx[0], idx[j], idx[j + 1]))
    return tris


def _read_faces_ascii(f, el):
    _check_face_props(el)
    counts, flat = [], []
    for _ in range(el["count"]):
        tok = f.readline().split()
        k = int(tok[0])
        counts.append(k)
        flat.extend(int(x) for x in tok[1 : 1 + k])
    return _fan_triangulate(counts, flat)


def _read_faces_binary(f, el, endian):
    lp = _check_face_props(el)
    ct = np.dtype(endian + lp[2])
    it = np.dtype(endian + lp[3])
    # Read the whole face block at once and fast-path the (overwhelmingly
    # common for Stanford scans) all-triangles case with one frombuffer +
    # reshape — the per-face f.read loop was minutes of pure Python at the
    # ~1M-face sizes this loader exists for (ADVICE r3).
    buf = f.read()
    stride = ct.itemsize + 3 * it.itemsize
    n = el["count"]
    if len(buf) >= n * stride:
        head = np.frombuffer(buf, dtype=np.uint8, count=n * stride)
        rows = head.reshape(n, stride)
        counts = rows[:, : ct.itemsize].copy().view(ct)[:, 0]
        if np.all(counts == 3):
            idx = (
                rows[:, ct.itemsize :].copy().view(it).astype(np.int64)
            )  # (n, 3)
            # un-consumed tail (trailing elements) must stay readable
            f.seek(-(len(buf) - n * stride), 1) if len(buf) > n * stride else None
            return idx
    # variable counts: per-face walk over the in-memory buffer
    counts, flat = [], []
    off = 0
    for _ in range(n):
        k = int(np.frombuffer(buf, dtype=ct, count=1, offset=off)[0])
        off += ct.itemsize
        counts.append(k)
        flat.append(
            np.frombuffer(buf, dtype=it, count=k, offset=off).astype(np.int64)
        )
        off += it.itemsize * k
    if len(buf) > off:
        f.seek(-(len(buf) - off), 1)
    return _fan_triangulate(counts, np.concatenate(flat) if flat else [])


def load_ply(path: str, scale: float = constants.BASE_MODEL_SCALE) -> ObjMesh:
    """Parse a PLY file into the same host mesh type as :func:`load_obj`."""
    with open(path, "rb") as f:
        hdr = _parse_header(f)
        endian = ">" if hdr["format"] == "binary_big_endian" else "<"
        verts = None
        vnames = None
        tris = []
        for el in hdr["elements"]:
            if el["name"] == "vertex":
                if hdr["format"] == "ascii":
                    verts, vnames = _read_vertices_ascii(f, el)
                else:
                    verts, vnames = _read_vertices_binary(f, el, endian)
            elif el["name"] == "face":
                if hdr["format"] == "ascii":
                    tris = _read_faces_ascii(f, el)
                else:
                    tris = _read_faces_binary(f, el, endian)
            else:
                # skip unknown elements (only possible pre-face in ascii by
                # consuming their lines; binary unknown elements are an error
                # because their byte size is list-dependent)
                if hdr["format"] == "ascii":
                    for _ in range(el["count"]):
                        f.readline()
                elif any(p[1] == "list" for p in el["props"]):
                    raise PlyParseError(
                        f"cannot skip binary element {el['name']!r} with list properties"
                    )
                else:
                    size = sum(np.dtype(p[1]).itemsize for p in el["props"])
                    f.read(size * el["count"])
    if verts is None:
        raise PlyParseError(f"{path}: no vertex element")

    def col(name, alt=None, default=0.0):
        if name in vnames:
            return verts[:, vnames.index(name)]
        if alt is not None and alt in vnames:
            return verts[:, vnames.index(alt)]
        return np.full((verts.shape[0],), default, np.float64)

    pos = np.stack([col("x"), col("y"), col("z")], axis=1).astype(np.float32)
    nrm = np.stack([col("nx"), col("ny"), col("nz")], axis=1).astype(np.float32)
    uv = np.stack([col("u", "s"), col("v", "t")], axis=1).astype(np.float32)
    pos = pos * np.float32(scale)
    nrm = nrm * np.float32(scale)  # quirk parity: reference scales normals too
    t = np.asarray(tris, dtype=np.int32).reshape(-1, 3)
    if pos.shape[0] == 0:
        raise PlyParseError(f"{path}: empty vertex element")
    if np.any(t < 0) or (t.size and t.max() >= pos.shape[0]):
        raise PlyParseError(f"{path}: face index out of range")
    return ObjMesh(
        positions=pos,
        normals=nrm,
        uvs=uv,
        triangles=t,
        bbox_min=pos.min(axis=0),
        bbox_max=pos.max(axis=0),
    )


def save_ply(path: str, mesh: ObjMesh, binary: bool = True) -> None:
    """Write an ObjMesh as PLY (for round-trip tests and asset export)."""
    has_n = bool(np.any(mesh.normals))
    props = ["x", "y", "z"] + (["nx", "ny", "nz"] if has_n else [])
    with open(path, "wb") as f:
        fmt = "binary_little_endian" if binary else "ascii"
        f.write(b"ply\n")
        f.write(f"format {fmt} 1.0\n".encode())
        f.write(f"element vertex {mesh.num_vertices}\n".encode())
        for p in props:
            f.write(f"property float {p}\n".encode())
        f.write(f"element face {mesh.num_triangles}\n".encode())
        f.write(b"property list uchar int vertex_indices\n")
        f.write(b"end_header\n")
        cols = [mesh.positions]
        if has_n:
            cols.append(mesh.normals)
        data = np.concatenate(cols, axis=1).astype("<f4")
        if binary:
            f.write(data.tobytes())
            for t in mesh.triangles:
                f.write(struct.pack("<Biii", 3, int(t[0]), int(t[1]), int(t[2])))
        else:
            for row in data:
                f.write((" ".join(f"{v:.9g}" for v in row) + "\n").encode())
            for t in mesh.triangles:
                f.write(f"3 {t[0]} {t[1]} {t[2]}\n".encode())
