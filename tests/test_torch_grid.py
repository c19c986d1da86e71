"""The port's uniform-grid build and scene files against the JAX package's.

Mirrors tests/test_scene_build.py:53, :66, :93 (grid stamping, the CSR
buckets against the reference's scalar loop, the ELL round trip), with
every array equal to the JAX builder's (its numpy path), the grid fields
of whole scenes, and tests/test_dsl_cli.py:59, :71, :82, :270 (the scene
DSL; the CLI is not ported) and tests/test_reference_golden.py:93 (the
diffuse golden through the port's ``load_scene_file``).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from pathtracerap_tpu.scene import dsl as JD
from pathtracerap_tpu.scene.build import build_cornell_box_scene as jax_cornell
from pathtracerap_tpu.scene.grid import build_uniform_grid as jax_grid
from pathtracerap_tpu.scene.grid import grids_to_ell as jax_ell
from pathtracerap_tpu_torch import (
    Renderer, build_cornell_box_scene, build_reference_scene, read_bmp,
)
from pathtracerap_tpu_torch.scene.dsl import (
    SceneParseError,
    _parse_value,
    load_scene_file,
    parse_scene,
    render_config_from_parsed,
)
from pathtracerap_tpu_torch.scene.grid import build_uniform_grid, grids_to_ell

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIFFUSE_SCN = os.path.join(ROOT, "scenes", "diffuse_reference.scn")
DIFFUSE_GOLDEN = os.path.join(ROOT, "assets", "golden", "diffuse_reference.bmp")


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """The renders here issue thousands of small tensor ops; under a parallel
    test run every worker's intra-op thread pool competes for the same
    cores and each op's fork/join waits on the others (minutes, where one
    thread takes seconds)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# tests/test_dsl_cli.py's scene
SCENE_TEXT = """
# materials
DIFFUSE white
color: [0.9, 0.9, 0.9]

EMISSIVE lamp
color: [0.99, 0.99, 0.99]

METAL chrome
color: [0.8, 0.8, 0.9]

BOX room
min: [-100, -100, -100]
max: [100, 100, 100]
material: white

SPHERE ball
radius: 20
subdiv: 8
translate: [0, -40, 0]
material: chrome

BOX panel
min: [-30, -2, -30]
max: [30, 2, 30]
translate: [0, 95, 0]
material: lamp

CAMERA
position: [0, 0, 90]
plane_x: [-40, 40]
plane_y: [-40, 40]
plane_z: 60

RENDER
resolution: [24, 24]
spp: 4
bounces: 3
engine: mxu
"""


def _grid_equal(port, ref):
    for f in ("voxel_width", "voxel_tri_start", "voxel_tri_count", "tri_indices"):
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f), err_msg=f)
    assert tuple(port.dims) == tuple(ref.dims)


def _hosts_equal(port, ref):
    for f in dataclasses.fields(port):
        np.testing.assert_array_equal(getattr(port, f.name), getattr(ref, f.name), err_msg=f.name)


def test_grid_single_triangle_stamps_expected_voxels():
    tri = np.array([[[0.0, 0.0, 0.0], [0.5, 0.0, 0.0], [0.0, 0.5, 0.0]]], np.float32)
    g = build_uniform_grid(tri, np.zeros(3), np.ones(3), dims=(4, 4, 4))
    # the triangle's box [0, .5] x [0, .5] x [0, 0] stamps x, y in 0..2, z 0
    occupied = np.nonzero(g.voxel_tri_count)[0]
    assert sorted(occupied.tolist()) == sorted(x + y * 4 for x in range(3) for y in range(3))
    assert g.tri_indices.shape[0] == 9
    _grid_equal(g, jax_grid(tri, np.zeros(3), np.ones(3), dims=(4, 4, 4), backend="python"))


@pytest.mark.parametrize("dims, base", [((5, 5, 5), 0), ((7, 3, 4), 100)])
def test_grid_csr_matches_bucket_semantics(dims, base):
    rng = np.random.default_rng(0)
    verts = rng.uniform(-1, 1, size=(50, 3, 3)).astype(np.float32)
    bb_min = verts.reshape(-1, 3).min(axis=0)
    bb_max = verts.reshape(-1, 3).max(axis=0)
    g = build_uniform_grid(verts, bb_min, bb_max, dims=dims, tri_index_base=base)
    _grid_equal(g, jax_grid(verts, bb_min, bb_max, dims=dims, tri_index_base=base,
                            backend="python"))

    # the reference's scalar bucket loop (Scene.cpp:349-375)
    d = np.array(dims)
    width = (bb_max - bb_min) / d
    buckets = [[] for _ in range(int(d.prod()))]
    for t in range(50):
        lo = np.clip(np.floor(np.abs(bb_min - verts[t].min(axis=0)) / width).astype(int), 0, d - 1)
        hi = np.clip(np.floor(np.abs(bb_min - verts[t].max(axis=0)) / width).astype(int), 0, d - 1)
        for z in range(lo[2], hi[2] + 1):
            for y in range(lo[1], hi[1] + 1):
                for x in range(lo[0], hi[0] + 1):
                    buckets[x + y * dims[0] + z * dims[0] * dims[1]].append(t + base)
    for v in range(len(buckets)):
        s, c = g.voxel_tri_start[v], g.voxel_tri_count[v]
        assert g.tri_indices[s:s + c].tolist() == buckets[v]


def test_grid_of_an_empty_or_flat_mesh():
    empty = build_uniform_grid(np.zeros((0, 3, 3), np.float32), np.zeros(3), np.ones(3))
    _grid_equal(empty, jax_grid(np.zeros((0, 3, 3), np.float32), np.zeros(3), np.ones(3),
                                backend="python"))
    flat = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32)  # zero z extent
    _grid_equal(build_uniform_grid(flat, flat[0].min(0), flat[0].max(0), dims=(3, 3, 3)),
                jax_grid(flat, flat[0].min(0), flat[0].max(0), dims=(3, 3, 3), backend="python"))


def test_ell_round_trip():
    starts = np.array([0, 2, 2, 5], np.int32)
    counts = np.array([2, 0, 3, 1], np.int32)
    pool = np.array([7, 8, 1, 2, 3, 9], np.int32)
    ell = grids_to_ell(starts, counts, pool, pad_multiple=4)
    assert ell.shape == (4, 4)
    assert ell.tolist() == [[7, 8, -1, -1], [-1, -1, -1, -1], [1, 2, 3, -1], [9, -1, -1, -1]]
    np.testing.assert_array_equal(ell, jax_ell(starts, counts, pool, pad_multiple=4))
    np.testing.assert_array_equal(grids_to_ell(starts, counts, pool), jax_ell(starts, counts, pool))


def test_cornell_grids_equal_jax_and_reach_the_device():
    port, ref = build_cornell_box_scene(), jax_cornell()
    _hosts_equal(port, ref)
    assert port.grid_mesh.shape[0] == 3 and port.voxel_tri_start.shape[0] == 3 * 25 ** 3
    # the two blocks share one grid (Scene.cpp:320-333)
    assert port.model_grid[1] == port.model_grid[2]
    dev = port.to_device("cpu")
    assert dev.grid_dims == (25, 25, 25)
    np.testing.assert_array_equal(dev.voxel_tris_ell.numpy(), ref.voxel_tris_ell)
    np.testing.assert_array_equal(dev.per_voxel_tris.numpy(), ref.per_voxel_tris)


@pytest.mark.parametrize("build", [build_cornell_box_scene, build_reference_scene],
                         ids=["cornell", "reference"])
def test_grid_trace_tables_equal_the_scene(build):
    """Kernel G1's tables (kernels/dda.py::_scene_args) hold the scene's
    values bit for bit: the triangle table is vertex_pos[tri_vidx] as
    (v0, v1 - v0, v2 - v0), the same IEEE subtractions the plain version's
    Moeller-Trumbore makes, padded with zeros to a multiple of 4 floats; the
    voxels' (start, count); each model's row (transform rows, normal
    matrix, its mesh's box, its grid's voxel width and first voxel, its
    material); the triangles' averaged vertex normals; and the shared
    form's bit a voxel for a non-empty bucket, each set bit's rank and
    cell (its bucket's start and count), and the entries as 16-bit
    indices, two a word."""
    from pathtracerap_tpu_torch.kernels.dda import MODEL_WORDS, SHARED_TABLES, _scene_args
    from pathtracerap_tpu_torch.ops.intersect import averaged_normal, normal_matrix

    host = build()
    dev = host.to_device("cpu")
    t = _scene_args(dev, torch.device("cpu"))
    n_tri = host.tri_vidx.shape[0]
    v = host.vertex_pos[host.tri_vidx]  # (T, 3, 3)
    flat = t["tris"].numpy()
    assert flat.size % 4 == 0 and flat.size - 9 * n_tri < 4 and not flat[9 * n_tri:].any()
    tab = flat[:9 * n_tri].reshape(n_tri, 9)
    for cols, want in ((slice(0, 3), v[:, 0]), (slice(3, 6), v[:, 1] - v[:, 0]),
                       (slice(6, 9), v[:, 2] - v[:, 0])):
        np.testing.assert_array_equal(tab[:, cols].view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(t["voxel"].numpy(),
                                  np.stack([host.voxel_tri_start, host.voxel_tri_count], axis=1))
    np.testing.assert_array_equal(t["vt_tris"].numpy(), host.per_voxel_tris)
    m = t["models"].numpy()
    assert m.shape == (host.num_models, MODEL_WORDS)
    mesh, grid = host.model_mesh, host.model_grid
    np.testing.assert_array_equal(m[:, 0:12], host.world_to_model[:, :3, :].reshape(-1, 12))
    np.testing.assert_array_equal(m[:, 12:24], host.model_to_world[:, :3, :].reshape(-1, 12))
    np.testing.assert_array_equal(m[:, 24:33],
                                  normal_matrix(dev.model_to_world).reshape(-1, 9).numpy())
    np.testing.assert_array_equal(m[:, 33:36], host.mesh_bbox_min[mesh])
    np.testing.assert_array_equal(m[:, 36:39], host.mesh_bbox_max[mesh])
    np.testing.assert_array_equal(m[:, 39:42], host.grid_voxel_width[grid])
    np.testing.assert_array_equal(m[:, 42].view(np.int32), host.grid_voxel_start[grid])
    np.testing.assert_array_equal(m[:, 43].view(np.int32), host.mat_type)
    np.testing.assert_array_equal(m[:, 44:47], host.mat_color)
    np.testing.assert_array_equal(m[:, 47], host.mat_refractive_index)
    np.testing.assert_array_equal(
        t["tri_nrm"].numpy(), averaged_normal(dev.vertex_nrm, dev.tri_vidx.long()).numpy())
    nv = host.voxel_tri_count.shape[0]
    bits = np.unpackbits(t["occupied"].numpy().view(np.uint8), bitorder="little")
    np.testing.assert_array_equal(bits[:nv], host.voxel_tri_count > 0)
    assert not bits[nv:].any() and t["occupied"].numel() % 4 == 0
    n_entries = host.per_voxel_tris.shape[0]
    entries = t["entries"].numpy().view(np.uint16)
    np.testing.assert_array_equal(entries[:n_entries], host.per_voxel_tris)
    assert not entries[n_entries:].any() and t["entries"].numel() % 4 == 0
    # a set bit's cell: its rank among the set bits (the set bits before its
    # word, then those below it in the word) holds its bucket
    full = np.flatnonzero(host.voxel_tri_count > 0)
    rank = t["word_rank"].numpy().view(np.uint16)[full // 32].astype(np.int64)
    words = t["occupied"].numpy().view(np.uint32)[full // 32].astype(np.int64)
    below = np.array([bin(w & ((1 << (f % 32)) - 1)).count("1") for w, f in zip(words, full)])
    np.testing.assert_array_equal(rank + below, np.arange(full.size))
    cells = t["cells"].numpy().view(np.uint32)[:full.size]
    np.testing.assert_array_equal(cells & 0xFFFF, host.voxel_tri_start[full])
    np.testing.assert_array_equal(cells >> 16, host.voxel_tri_count[full])
    staged = sum(t[k].numel() for k in SHARED_TABLES)
    assert all(t[k].numel() % 4 == 0 for k in SHARED_TABLES)
    assert t["shared"] and t["smem_bytes"] == 4 * staged


def test_dsl_parses_and_builds():
    p = parse_scene(SCENE_TEXT)
    assert p.scene.num_models == 3
    assert p.scene.num_triangles > 100
    cfg = render_config_from_parsed(p)
    assert cfg.resolution == (24, 24)
    assert cfg.samples_per_pixel == 4
    assert cfg.max_bounces == 3
    assert cfg.camera.position == (0, 0, 90)
    ref = JD.parse_scene(SCENE_TEXT)
    _hosts_equal(p.scene, ref.scene)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(JD.render_config_from_parsed(ref))


def test_dsl_grid_dims_reach_the_grids():
    p = parse_scene(SCENE_TEXT, grid_dims=(8, 6, 4))
    assert p.scene.grid_dims == (8, 6, 4) and p.scene.voxel_tri_start.shape[0] == 3 * 8 * 6 * 4
    _hosts_equal(p.scene, JD.parse_scene(SCENE_TEXT, grid_dims=(8, 6, 4)).scene)


def test_dsl_renders():
    p = parse_scene(SCENE_TEXT)
    cfg = render_config_from_parsed(p)
    img = Renderer(p.scene.to_device("cpu"), cfg, device="cpu").render().numpy()
    assert img.shape == (24, 24, 3)
    assert np.isfinite(img).all()
    assert img.max() > 0.05


def test_dsl_errors():
    with pytest.raises(SceneParseError, match="unknown material"):
        parse_scene("BOX b\nmaterial: nope\n")
    with pytest.raises(SceneParseError, match="no entity"):
        parse_scene("DIFFUSE d\ncolor: [1,1,1]\n")
    with pytest.raises(SceneParseError, match="outside any block"):
        parse_scene("color: [1,1,1]\n")
    with pytest.raises(SceneParseError, match="needs material"):
        parse_scene("BOX b\nmin: [0, 0, 0]\n")
    with pytest.raises(SceneParseError, match="expected 'key: value'"):
        parse_scene("BOX b\nmaterial white\n")


def test_dsl_lowercase_booleans():
    assert _parse_value("true") is True
    assert _parse_value("false") is False
    assert _parse_value("True") is True
    assert _parse_value("no") is False
    assert _parse_value("0.5") == 0.5
    assert _parse_value("some_name") == "some_name"
    assert render_config_from_parsed(parse_scene(SCENE_TEXT + "\nRENDER\nquality: false\n")).parity
    assert not render_config_from_parsed(
        parse_scene(SCENE_TEXT + "\nRENDER\nquality: true\n")).parity


def _down(x, f):
    h, w, _ = x.shape
    return x.reshape(h // f, f, w // f, f, 3).mean(axis=(1, 3))


def test_scene_file_matches_jax_and_the_diffuse_golden():
    """tests/test_reference_golden.py:93 on the port: the diffuse scene
    file (host arrays equal to JAX's), rendered at 100x80 x 4 spp, against
    the committed golden after downsampling."""
    p = load_scene_file(DIFFUSE_SCN)
    _hosts_equal(p.scene, JD.load_scene_file(DIFFUSE_SCN).scene)
    cfg = render_config_from_parsed(p, resolution=(100, 80), samples_per_pixel=4, engine="mxu")
    img = Renderer(p.scene.to_device("cpu"), cfg, device="cpu").render(seed=5).numpy()
    golden = read_bmp(DIFFUSE_GOLDEN).astype(np.float32) / 255.0
    a, b = _down(img, 4), _down(_down(golden, 10), 4)
    mad = float(np.abs(a - b).mean())
    corr = float(np.corrcoef(a.ravel(), b.ravel())[0, 1])
    assert mad < 0.08, f"mean|diff| vs diffuse golden = {mad:.4f}"
    assert corr > 0.9, f"correlation vs diffuse golden = {corr:.4f}"
    assert torch.is_tensor(p.scene.to_device("cpu").voxel_tris_ell)
