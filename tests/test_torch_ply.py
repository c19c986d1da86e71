"""The port's PLY loader (``pathtracerap_tpu_torch/io/ply.py``) against the
JAX package's, on the same files.

Mirrors tests/test_ply.py:16-108: round trips, format variants, fan
triangulation, the errors, and the builder's dispatch on ``.ply`` (and so
scene files' MESH entries).  Every file that loads is also loaded by JAX's
``load_ply``, and the arrays must be equal.
"""

import dataclasses

import numpy as np
import pytest

from pathtracerap_tpu.io import ply as jply
from pathtracerap_tpu.io.obj import save_obj
from pathtracerap_tpu.scene.build import make_box_mesh as jax_box
from pathtracerap_tpu_torch.io import load_obj
from pathtracerap_tpu_torch.io.ply import PlyParseError, load_ply, save_ply
from pathtracerap_tpu_torch.scene.build import SceneBuilder, make_box_mesh
from pathtracerap_tpu_torch.scene.types import Material, MaterialType

QUAD = (b"ply\nformat ascii 1.0\n"
        b"element vertex 4\n"
        b"property float x\nproperty float y\nproperty float z\n"
        b"element face 1\n"
        b"property list uchar int vertex_indices\n"
        b"end_header\n"
        b"0 0 0\n1 0 0\n1 1 0\n0 1 0\n"
        b"4 0 1 2 3\n")
DOUBLES = (b"ply\nformat ascii 1.0\ncomment scanned\n"
           b"element vertex 3\n"
           b"property double x\nproperty double y\nproperty double z\n"
           b"property uchar red\n"
           b"element face 1\n"
           b"property list uchar int vertex_indices\n"
           b"end_header\n"
           b"0 0 0 255\n1.5 0 0 0\n0 2.5 0 7\n"
           b"3 0 1 2\n")
BAD_INDEX = (b"ply\nformat ascii 1.0\n"
             b"element vertex 3\n"
             b"property float x\nproperty float y\nproperty float z\n"
             b"element face 1\nproperty list uchar int vertex_indices\n"
             b"end_header\n0 0 0\n1 0 0\n0 1 0\n3 0 1 5\n")


@pytest.fixture()
def box():
    return make_box_mesh(size=(2.0, 3.0, 4.0))


def _load_both(path, **kw):
    """The port's mesh, after holding every array equal to JAX's."""
    port, ref = load_ply(path, **kw), jply.load_ply(path, **kw)
    for f in dataclasses.fields(ref):
        np.testing.assert_array_equal(getattr(port, f.name), getattr(ref, f.name),
                                      err_msg=f.name)
    return port


@pytest.mark.parametrize("binary", [True, False])
def test_roundtrip_and_bytes_equal_jax(tmp_path, box, binary):
    """tests/test_ply.py:16, :25: both encodings round-trip, and the port
    writes JAX's bytes."""
    p, q = str(tmp_path / "port.ply"), str(tmp_path / "jax.ply")
    save_ply(p, box, binary=binary)
    jply.save_ply(q, jax_box(size=(2.0, 3.0, 4.0)), binary=binary)
    assert open(p, "rb").read() == open(q, "rb").read()
    m = _load_both(p, scale=1.0)
    np.testing.assert_allclose(m.positions, box.positions, rtol=1e-5)
    np.testing.assert_allclose(m.normals, box.normals, rtol=1e-5)
    np.testing.assert_array_equal(m.triangles, box.triangles)


def test_scale_matches_obj_loader_semantics(tmp_path, box):
    """tests/test_ply.py:33: positions and normals scale by the import
    scale, as the OBJ loader scales them."""
    pp, po = str(tmp_path / "m.ply"), str(tmp_path / "m.obj")
    save_ply(pp, box)
    save_obj(po, jax_box(size=(2.0, 3.0, 4.0)))
    mp = _load_both(pp, scale=250.0)
    mo = load_obj(po, scale=250.0)
    np.testing.assert_allclose(mp.positions, mo.positions, rtol=1e-5)
    np.testing.assert_allclose(mp.normals, mo.normals, rtol=1e-4, atol=1e-3)


def test_quad_fan_triangulation(tmp_path):
    p = tmp_path / "quad.ply"
    p.write_bytes(QUAD)
    m = _load_both(str(p), scale=1.0)
    assert m.num_triangles == 2
    np.testing.assert_array_equal(m.triangles, [[0, 1, 2], [0, 2, 3]])


def test_double_precision_and_extra_props(tmp_path):
    p = tmp_path / "d.ply"
    p.write_bytes(DOUBLES)
    m = _load_both(str(p), scale=2.0)
    np.testing.assert_allclose(m.positions, [[0, 0, 0], [3.0, 0, 0], [0, 5.0, 0]], rtol=1e-6)


@pytest.mark.parametrize("content", [b"not a ply\n", BAD_INDEX], ids=["not_ply", "bad_index"])
def test_rejects_what_jax_rejects(tmp_path, content):
    """tests/test_ply.py:80, :88."""
    p = tmp_path / "x.ply"
    p.write_bytes(content)
    with pytest.raises(PlyParseError):
        load_ply(str(p))
    with pytest.raises(jply.PlyParseError):
        jply.load_ply(str(p))


def test_builder_dispatches_ply(tmp_path, box):
    """tests/test_ply.py:101: ``add_mesh_file`` loads ``.ply`` like ``.obj``."""
    pp, po = str(tmp_path / "m.ply"), str(tmp_path / "m.obj")
    save_ply(pp, box)
    save_obj(po, jax_box(size=(2.0, 3.0, 4.0)))

    def build(path):
        b = SceneBuilder()
        mid = b.add_mesh_file(path, scale=10.0)
        b.add_instance(mid, Material(MaterialType.DIFFUSE, (0.5, 0.5, 0.5)))
        return b.build()

    sp, so = build(pp), build(po)
    np.testing.assert_allclose(sp.vertex_pos, so.vertex_pos, rtol=1e-5)
    np.testing.assert_array_equal(sp.tri_vidx, so.tri_vidx)
