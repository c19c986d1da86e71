"""ctypes bindings for the port's native host library (port of
``pathtracerap_tpu/native.py``).

``host/ptap_native.cc`` is the C++ OBJ loader, uniform-grid builder and
BMP writer, with the same semantics as the pure-Python implementations in
:mod:`.io.obj`, :mod:`.scene.grid` and :mod:`.io.bmp`: either backend can
oracle the other (``tests/test_torch_native.py``).  Those functions take
``backend="auto" | "native" | "python"``.

Loading policy:

* ``PTAP_NATIVE=0`` disables the library (pure Python everywhere);
* otherwise it is built with ``g++`` (or ``$CXX``) at first use into
  ``build/pathtracerap_tpu_torch/`` beside the package, keyed by a hash of
  the source and the flags, and loaded from there; a failed build leaves
  it unavailable, and ``backend="auto"`` falls back to Python.  The device
  path never depends on it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "host" / "ptap_native.cc"
BUILD_DIR = _PKG.parent / "build" / "pathtracerap_tpu_torch"
FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-fno-exceptions", "-shared"]

_lock = threading.Lock()
_lib = None
_load_attempted = False
build_error: Optional[str] = None  # why the library is unavailable, if it is


def _compiler() -> str:
    return os.environ.get("CXX") or "g++"


def library_path() -> Path:
    """Where the build of this source and these flags lives."""
    h = hashlib.sha256(" ".join([_compiler()] + FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libptap_native_{h.hexdigest()[:16]}.so"


def _build(so: Path) -> None:
    """Compile the source into ``so`` (atomically: a temporary name, then
    a rename, so concurrent builders never load half a file)."""
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_compiler(), *FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"{_compiler()} failed ({proc.returncode}):\n{proc.stderr[-3000:]}")
    os.replace(tmp, so)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_i64 = ctypes.c_int64
    c_p = ctypes.c_void_p
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)

    lib.ptap_obj_load.restype = c_p
    lib.ptap_obj_load.argtypes = [ctypes.c_char_p, ctypes.c_float]
    lib.ptap_obj_error.restype = ctypes.c_char_p
    lib.ptap_obj_error.argtypes = [c_p]
    lib.ptap_obj_sizes.restype = None
    lib.ptap_obj_sizes.argtypes = [c_p, i64p, i64p]
    lib.ptap_obj_copy.restype = None
    lib.ptap_obj_copy.argtypes = [c_p, f32p, f32p, f32p, i32p, f32p, f32p]
    lib.ptap_obj_free.restype = None
    lib.ptap_obj_free.argtypes = [c_p]

    lib.ptap_grid_build.restype = c_p
    lib.ptap_grid_build.argtypes = [
        f32p, c_i64, f32p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.ptap_grid_nindices.restype = c_i64
    lib.ptap_grid_nindices.argtypes = [c_p]
    lib.ptap_grid_copy.restype = None
    lib.ptap_grid_copy.argtypes = [c_p, i32p, i32p, i32p, f32p]
    lib.ptap_grid_free.restype = None
    lib.ptap_grid_free.argtypes = [c_p]

    lib.ptap_write_bmp.restype = ctypes.c_int
    lib.ptap_write_bmp.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
    ]
    return lib


def get_lib():
    """The loaded library, built on first use; ``None`` if unavailable
    (``PTAP_NATIVE=0``, or the build failed: see :data:`build_error`)."""
    global _lib, _load_attempted, build_error
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None or _load_attempted:
            return _lib
        _load_attempted = True
        if os.environ.get("PTAP_NATIVE", "1") == "0":
            build_error = "disabled by PTAP_NATIVE=0"
            return None
        try:
            so = library_path()
            if not so.exists():
                _build(so)
            _lib = _bind(ctypes.CDLL(str(so)))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            build_error = str(e)
            _lib = None
        return _lib


def available() -> bool:
    return get_lib() is not None


def require(what: str):
    """The library for ``backend="native"``: raises ``RuntimeError`` when
    it does not load."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"native {what} backend requested but unavailable: {build_error}")
    return lib


BACKENDS = ("auto", "native", "python")


def use(backend: str, what: str) -> bool:
    """Whether a function taking ``backend=`` runs its native path:
    ``"auto"`` when the library loads, ``"native"`` always (``RuntimeError``
    when it does not load), ``"python"`` never; ``ValueError`` for any
    other string."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown {what} backend {backend!r}: one of {BACKENDS}")
    if backend == "native":
        require(what)
        return True
    return backend == "auto" and available()


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def load_obj_native(path: str, scale: float):
    """Native OBJ import: (positions, normals, uvs, triangles, bbox_min,
    bbox_max), the arrays the Python loader builds.  ``ValueError`` for a
    face that is not a triangle, a missing file or an empty mesh."""
    lib = require("OBJ")
    h = lib.ptap_obj_load(path.encode(), ctypes.c_float(scale))
    try:
        err = lib.ptap_obj_error(h)
        if err is not None:
            raise ValueError(err.decode())
        nv = ctypes.c_int64()
        nt = ctypes.c_int64()
        lib.ptap_obj_sizes(h, ctypes.byref(nv), ctypes.byref(nt))
        pos = np.empty((nv.value, 3), np.float32)
        nrm = np.empty((nv.value, 3), np.float32)
        uv = np.empty((nv.value, 2), np.float32)
        tris = np.empty((nt.value, 3), np.int32)
        bbmin = np.empty(3, np.float32)
        bbmax = np.empty(3, np.float32)
        lib.ptap_obj_copy(h, _f32p(pos), _f32p(nrm), _f32p(uv), _i32p(tris), _f32p(bbmin),
                          _f32p(bbmax))
        return pos, nrm, uv, tris, bbmin, bbmax
    finally:
        lib.ptap_obj_free(h)


def build_grid_native(tri_verts: np.ndarray, bbox_min: np.ndarray, bbox_max: np.ndarray, dims,
                      tri_index_base: int):
    """Native CSR uniform-grid build of (T, 3, 3) triangles: (voxel_width,
    starts, counts, indices), equal to
    :func:`..scene.grid.build_uniform_grid`'s."""
    lib = require("grid")
    tv = np.ascontiguousarray(tri_verts, dtype=np.float32).reshape(-1, 9)
    bmin = np.ascontiguousarray(bbox_min, dtype=np.float32)
    bmax = np.ascontiguousarray(bbox_max, dtype=np.float32)
    gx, gy, gz = (int(d) for d in dims)
    nvox = gx * gy * gz
    h = lib.ptap_grid_build(_f32p(tv), ctypes.c_int64(tv.shape[0]), _f32p(bmin), _f32p(bmax),
                            gx, gy, gz, int(tri_index_base))
    try:
        n_idx = lib.ptap_grid_nindices(h)
        starts = np.empty(nvox, np.int32)
        counts = np.empty(nvox, np.int32)
        indices = np.empty(max(n_idx, 1), np.int32)
        width = np.empty(3, np.float32)
        lib.ptap_grid_copy(h, _i32p(starts), _i32p(counts), _i32p(indices), _f32p(width))
        return width, starts, counts, indices[:n_idx].copy()
    finally:
        lib.ptap_grid_free(h)


def write_bmp_native(path: str, image: np.ndarray, parity: bool) -> None:
    """Native BMP write, byte-identical to :func:`..io.bmp.write_bmp`."""
    lib = require("BMP")
    img = np.ascontiguousarray(image, dtype=np.uint8)
    h, w = img.shape[:2]
    rc = lib.ptap_write_bmp(path.encode(), img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                            int(w), int(h), 1 if parity else 0)
    if rc != 0:
        raise OSError(f"ptap_write_bmp failed with code {rc} for {path}")
