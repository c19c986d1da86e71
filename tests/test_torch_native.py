"""The port's native host library (``pathtracerap_tpu_torch/native.py``,
``host/ptap_native.cc``) against its own pure-Python backends and the JAX
package's.

Mirrors tests/test_native.py:31-104: the OBJ files, quads rejected,
negative indices, the three grid cases, the empty and planar grids, and
the four BMP cases.  Each port result is checked three ways: native
against the port's ``"python"`` backend, against the JAX package's result,
and for the BMPs byte for byte.  ``backend="native"`` raises when the
library is disabled (``PTAP_NATIVE=0``) and ``"auto"`` then falls back.
"""

import os

import numpy as np
import pytest

from pathtracerap_tpu.io.bmp import write_bmp as jax_write_bmp
from pathtracerap_tpu.io.obj import load_obj as jax_load_obj
from pathtracerap_tpu.scene.grid import build_uniform_grid as jax_build_grid
from pathtracerap_tpu_torch import native
from pathtracerap_tpu_torch.io.bmp import read_bmp, write_bmp
from pathtracerap_tpu_torch.io.obj import load_obj
from pathtracerap_tpu_torch.scene.grid import build_uniform_grid

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = os.path.join(ROOT, "assets", "meshes")
_REF_OBJS = ["enclosing_box.obj", "ceiling_light.obj", "blender_monkey.obj"]
OBJ_FIELDS = ("triangles", "positions", "normals", "uvs", "bbox_min", "bbox_max")
GRID_FIELDS = ("voxel_width", "voxel_tri_start", "voxel_tri_count", "tri_indices")


@pytest.fixture(scope="module", autouse=True)
def _library():
    assert native.available(), native.build_error  # g++ is on this machine


def _obj_equal(a, b):
    for f in OBJ_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def _grid_equal(a, b):
    for f in GRID_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert tuple(a.dims) == tuple(b.dims)


@pytest.mark.parametrize("name", _REF_OBJS)
def test_obj_native_matches_python(name):
    path = os.path.join(MESHES, name)
    nat = load_obj(path, backend="native")
    _obj_equal(nat, load_obj(path, backend="python"))
    _obj_equal(nat, jax_load_obj(path, backend="python"))
    _obj_equal(nat, load_obj(path))  # "auto": the native parser
    assert nat.num_triangles > 0


def test_obj_native_rejects_quads(tmp_path):
    p = tmp_path / "quad.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\n")
    with pytest.raises(ValueError):
        load_obj(str(p), backend="native")
    with pytest.raises(ValueError):
        load_obj(str(p), backend="python")
    with pytest.raises(ValueError, match="cannot open"):
        load_obj(str(tmp_path / "missing.obj"), backend="native")


def test_obj_native_negative_indices_and_vt(tmp_path):
    p = tmp_path / "neg.obj"
    p.write_text(
        "v 0 0 0\nv 1 0 0\nv 0 1 0\n"
        "vt 0.25 0.5\nvt 0.75 0.5\nvt 0.5 1.0\n"
        "vn 0 0 1\n"
        "f -3/-3/-1 -2/-2/-1 -1/-1/-1\n"
    )
    nat = load_obj(str(p), backend="native")
    _obj_equal(nat, load_obj(str(p), backend="python"))
    _obj_equal(nat, jax_load_obj(str(p), backend="python"))


@pytest.mark.parametrize("seed,dims", [(0, (25, 25, 25)), (1, (7, 5, 3)), (2, (25, 25, 25))])
def test_grid_native_matches_python(seed, dims):
    rng = np.random.default_rng(seed)
    t = int(rng.integers(50, 400))
    centers = rng.uniform(-10, 10, (t, 1, 3)).astype(np.float32)
    offsets = rng.uniform(-1.5, 1.5, (t, 3, 3)).astype(np.float32)
    tv = centers + offsets
    bbmin = tv.reshape(-1, 3).min(axis=0)
    bbmax = tv.reshape(-1, 3).max(axis=0)
    nat = build_uniform_grid(tv, bbmin, bbmax, dims, tri_index_base=17, backend="native")
    _grid_equal(nat, build_uniform_grid(tv, bbmin, bbmax, dims, tri_index_base=17,
                                        backend="python"))
    _grid_equal(nat, jax_build_grid(tv, bbmin, bbmax, dims, tri_index_base=17, backend="python"))


def test_grid_native_empty_and_degenerate():
    tv = np.zeros((0, 3, 3), np.float32)
    nat = build_uniform_grid(tv, np.zeros(3), np.ones(3), (4, 4, 4), backend="native")
    _grid_equal(nat, build_uniform_grid(tv, np.zeros(3), np.ones(3), (4, 4, 4),
                                        backend="python"))
    _grid_equal(nat, jax_build_grid(tv, np.zeros(3), np.ones(3), (4, 4, 4), backend="python"))
    assert nat.tri_indices.size == 0
    # planar mesh: zero-extent axis must not divide by zero
    tvp = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32)
    lo, hi = tvp.reshape(-1, 3).min(0), tvp.reshape(-1, 3).max(0)
    natp = build_uniform_grid(tvp, lo, hi, (4, 4, 4), backend="native")
    _grid_equal(natp, build_uniform_grid(tvp, lo, hi, (4, 4, 4), backend="python"))
    _grid_equal(natp, jax_build_grid(tvp, lo, hi, (4, 4, 4), backend="python"))


def test_grid_native_on_a_committed_mesh():
    """The highpoly blob's grid (the parity engine's global-memory case)
    through both backends."""
    mesh = load_obj(os.path.join(MESHES, "highpoly_blob.obj"), backend="python")
    tv = mesh.positions[mesh.triangles]
    nat = build_uniform_grid(tv, mesh.bbox_min, mesh.bbox_max, backend="native")
    _grid_equal(nat, build_uniform_grid(tv, mesh.bbox_min, mesh.bbox_max, backend="python"))
    assert nat.tri_indices.size >= mesh.num_triangles


@pytest.mark.parametrize("parity,w,h", [(True, 10, 7), (False, 10, 7), (True, 4, 4), (False, 5, 3)])
def test_bmp_native_byte_identical(tmp_path, parity, w, h):
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    paths = {k: tmp_path / f"{k}.bmp" for k in ("py", "nat", "jax")}
    write_bmp(str(paths["py"]), img, parity=parity, backend="python")
    write_bmp(str(paths["nat"]), img, parity=parity, backend="native")
    jax_write_bmp(str(paths["jax"]), img, parity=parity, backend="python")
    assert paths["py"].read_bytes() == paths["nat"].read_bytes() == paths["jax"].read_bytes()
    np.testing.assert_array_equal(read_bmp(str(paths["nat"]), parity=parity), img)


def test_native_backend_raises_when_disabled(monkeypatch, tmp_path):
    """``PTAP_NATIVE=0``: ``backend="native"`` raises RuntimeError in all
    three functions and ``"auto"`` falls back to Python."""
    monkeypatch.setenv("PTAP_NATIVE", "0")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_attempted", False)
    assert not native.available() and "PTAP_NATIVE=0" in native.build_error
    path = os.path.join(MESHES, "ceiling_light.obj")
    with pytest.raises(RuntimeError, match="native OBJ backend"):
        load_obj(path, backend="native")
    tv = np.zeros((1, 3, 3), np.float32)
    with pytest.raises(RuntimeError, match="native grid backend"):
        build_uniform_grid(tv, np.zeros(3), np.ones(3), backend="native")
    img = np.zeros((2, 3, 3), np.uint8)
    with pytest.raises(RuntimeError, match="native BMP backend"):
        write_bmp(str(tmp_path / "x.bmp"), img, backend="native")
    _obj_equal(load_obj(path), load_obj(path, backend="python"))
    write_bmp(str(tmp_path / "auto.bmp"), img)
    write_bmp(str(tmp_path / "py.bmp"), img, backend="python")
    assert (tmp_path / "auto.bmp").read_bytes() == (tmp_path / "py.bmp").read_bytes()


def test_backend_strings_and_missing_file(tmp_path):
    """A backend outside auto/native/python raises ValueError in all three
    functions; a missing OBJ file raises FileNotFoundError under "auto"
    and "python", as before the native library, and ValueError under
    "native", as JAX's parser does."""
    tv = np.zeros((1, 3, 3), np.float32)
    img = np.zeros((2, 3, 3), np.uint8)
    path = os.path.join(MESHES, "ceiling_light.obj")
    with pytest.raises(ValueError, match="unknown OBJ backend"):
        load_obj(path, backend="nativ")
    with pytest.raises(ValueError, match="unknown grid backend"):
        build_uniform_grid(tv, np.zeros(3), np.ones(3), backend="Python")
    with pytest.raises(ValueError, match="unknown BMP backend"):
        write_bmp(str(tmp_path / "x.bmp"), img, backend="")
    assert not (tmp_path / "x.bmp").exists()
    missing = str(tmp_path / "missing.obj")
    for backend in ("auto", "python"):
        with pytest.raises(FileNotFoundError):
            load_obj(missing, backend=backend)
    with pytest.raises(ValueError, match="cannot open"):
        load_obj(missing, backend="native")


def test_native_library_is_built_from_the_port_source():
    """Built with g++ into build/pathtracerap_tpu_torch/, keyed by a hash of
    the port's own copy of the source."""
    so = native.library_path()
    assert so.parent == native.BUILD_DIR and so.name.startswith("libptap_native_") and so.exists()
    assert native.SOURCE.parent.name == "host" and native.SOURCE.parent.parent.name == \
        "pathtracerap_tpu_torch"
    assert native.get_lib()._name == str(so)
