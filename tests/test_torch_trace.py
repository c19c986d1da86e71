"""The port's worklist trace (plain kernel 1) against the JAX package's
Pallas trace, run in interpret mode on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracerap_tpu.config import RenderConfig
from pathtracerap_tpu.ops.plucker import bake_world_triangles as jax_bake
from pathtracerap_tpu.ops.plucker import trace_mxu as jax_trace_mxu
from pathtracerap_tpu.pallas import trace as JT
from pathtracerap_tpu.render.camera import generate_rays as jax_generate_rays
from pathtracerap_tpu.scene.build import build_cornell_box_scene
from pathtracerap_tpu.scene.build import build_reference_scene as jax_reference_scene
from pathtracerap_tpu_torch import convert
from pathtracerap_tpu_torch.kernels import trace as TT
from pathtracerap_tpu_torch.ops.plucker import bake_world_triangles, trace_mxu
from pathtracerap_tpu_torch.scene import build_reference_scene

F_MAX = 9999999.0


def _fields(obj) -> dict:
    return {f.name: (np.asarray(v) if v is not None and not isinstance(v, (int, tuple)) else v)
            for f in dataclasses.fields(obj) for v in [getattr(obj, f.name)]}


@pytest.fixture(scope="module")
def reference():
    """(port world, JAX world, rays, JAX trace of the 32x16 camera rays)."""
    jw = jax.jit(jax_bake)(jax_reference_scene().to_device())
    ro, rd = jax_generate_rays(RenderConfig().camera, (32, 16))
    jh, jidx = JT.trace_pallas(jw, ro, rd, return_idx=True)
    world = bake_world_triangles(build_reference_scene().to_device("cpu"))
    rays = (torch.from_numpy(np.array(ro)), torch.from_numpy(np.array(rd)))
    return world, jw, rays, jh, np.asarray(jidx)


def test_trace_pallas_matches_jax(reference):
    world, _, (ro, rd), jh, jidx = reference
    h = TT.trace_pallas(world, ro, rd)
    w16, lists = TT.primary_inputs(world, ro, rd)
    _, idx = TT.nearest_hit_fused(w16, world, lists, TT.RAY_TILE)
    np.testing.assert_array_equal(np.maximum(idx[: ro.shape[0]].numpy(), 0), jidx)
    np.testing.assert_allclose(h.t.numpy(), np.asarray(jh.t), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(h.mat_type.numpy(), np.asarray(jh.mat_type))
    np.testing.assert_allclose(h.normal.numpy(), np.asarray(jh.normal), atol=1e-6)
    np.testing.assert_allclose(h.geom_normal.numpy(), np.asarray(jh.geom_normal), atol=1e-6)
    assert (h.t.numpy() < F_MAX).all()  # every camera ray hits the enclosing box


def test_trace_pallas_matches_brute_force(reference):
    world, _, (ro, rd), _, _ = reference
    h, ref = TT.trace_pallas(world, ro, rd), trace_mxu(world, ro, rd)
    np.testing.assert_allclose(h.t.numpy(), ref.t.numpy(), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(h.mat_type.numpy(), ref.mat_type.numpy())


def test_trace_mxu_matches_jax(reference):
    world, jw, (ro, rd), _, _ = reference
    h, ref = trace_mxu(world, ro, rd), jax_trace_mxu(jw, ro.numpy(), rd.numpy())
    np.testing.assert_allclose(h.t.numpy(), np.asarray(ref.t), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(h.mat_type.numpy(), np.asarray(ref.mat_type))


def test_trace_pallas_alive_mask(reference):
    """Dead lanes leave the worklists; live lanes' hits do not change."""
    world, _, (ro, rd), _, _ = reference
    alive = torch.arange(ro.shape[0]) % 3 != 0
    full, part = TT.trace_pallas(world, ro, rd), TT.trace_pallas(world, ro, rd, alive=alive)
    assert torch.equal(full.t[alive], part.t[alive])


def test_trace_pallas_needs_fused_pack(reference):
    """The worklist trace needs the fused pack; a world without one takes
    the dense sweep (kernel 5's plain version here) and finds the same
    hits as JAX's worklist trace."""
    world = dataclasses.replace(reference[0], fused_ops=None)
    calls = TT.nearest_hit_plain.calls, TT.nearest_hit_fused_plain.calls
    h, idx = TT.trace_pallas(world, *reference[2], return_idx=True)
    assert (TT.nearest_hit_plain.calls, TT.nearest_hit_fused_plain.calls) == (calls[0] + 1, calls[1])
    np.testing.assert_array_equal(idx.numpy(), reference[4])
    np.testing.assert_allclose(h.t.numpy(), np.asarray(reference[3].t), rtol=1e-6, atol=0)


@pytest.mark.parametrize("scale", [1e-3, 1e3])
def test_worklist_culling_safe_at_extreme_scene_scales(scale):
    """Scale-relative culling margins (tests/test_pallas_trace.py:55): at
    millimetre and kilometre scene scales the worklist trace agrees with
    the JAX dense sweep."""
    jscene = build_cornell_box_scene(size=400.0 * scale).to_device()
    jw = jax_bake(jscene)
    world = bake_world_triangles(convert.scene_from_numpy(_fields(jscene), "cpu"))
    g = np.random.default_rng(1234)
    ro = (g.uniform(-150, 150, size=(640, 3)) * scale).astype(np.float32)
    rd = ((g.uniform(-180, 180, size=(640, 3)) * scale).astype(np.float32) - ro).astype(np.float32)
    h = TT.trace_pallas(world, torch.from_numpy(ro), torch.from_numpy(rd))
    h_mxu = jax_trace_mxu(jw, ro, rd)
    t, t_mxu = h.t.numpy(), np.asarray(h_mxu.t)
    np.testing.assert_array_equal(t < F_MAX, t_mxu < F_MAX)
    hit = t < F_MAX
    np.testing.assert_allclose(t[hit], t_mxu[hit], rtol=1e-5, atol=1e-4 * scale)
    np.testing.assert_array_equal(h.mat_type.numpy(), np.asarray(h_mxu.mat_type))


def _boxes(nb, n_nan, seed=0):
    g = np.random.default_rng(seed)
    lo = g.uniform(-50.0, 40.0, size=(nb, 3)).astype(np.float32)
    aabb = np.concatenate([lo, lo + 10.0, np.zeros((nb, 2), np.float32)], axis=1)
    aabb[nb - n_nan:] = np.nan
    return aabb


def _lists_both(aabb, ro, rd, alive, ray_tile):
    port = TT._tile_block_lists(torch.from_numpy(aabb), torch.from_numpy(ro),
                                torch.from_numpy(rd), torch.from_numpy(alive), ray_tile)
    ref = JT._tile_block_lists(jnp.asarray(aabb), ro, rd, alive, ray_tile)
    return port.numpy(), np.asarray(ref)


@pytest.mark.parametrize("nb", [24, JT.FRUSTUM_LIST_THRESHOLD + 16])
def test_tile_block_lists_match_jax(nb):
    """Both branches: exact per-ray slab tests (nb <= 48) and the per-tile
    frustum test above, with dead lanes and NaN padding rows."""
    assert TT.FRUSTUM_LIST_THRESHOLD == JT.FRUSTUM_LIST_THRESHOLD
    g = np.random.default_rng(nb)
    aabb = _boxes(nb, 4, seed=nb)
    n = 512
    ro = np.zeros((n, 3), np.float32)
    ro[:, 2] = 150.0
    kd = g.normal(size=(n, 3)).astype(np.float32)
    rd = (kd / np.linalg.norm(kd, axis=1, keepdims=True)).astype(np.float32)
    alive = (g.uniform(size=(n, 1)) > 0.2).astype(np.float32)
    port, ref = _lists_both(aabb, ro, rd, alive, 128)
    np.testing.assert_array_equal(port, ref)
    assert (port < nb - 4).all()  # no NaN padding box is ever listed


def test_frustum_worklists_reject_nan_padding_blocks():
    """tests/test_pallas_trace.py:83: in the frustum branch NaN padding
    boxes never appear and -1 entries are a strict suffix of every row."""
    nb = JT.FRUSTUM_LIST_THRESHOLD + 16
    n_real = nb - 24
    aabb = _boxes(nb, 24)
    g = np.random.default_rng(1)
    n = 256
    ro = np.zeros((n, 3), np.float32)
    ro[:, 2] = 150.0
    kd = g.normal(size=(n, 3)).astype(np.float32)
    rd = (kd / np.linalg.norm(kd, axis=1, keepdims=True)).astype(np.float32)
    lists, _ = _lists_both(aabb, ro, rd, np.ones((n, 1), np.float32), 128)
    assert lists.shape[1] == nb
    assert (lists < n_real).all()
    for row in lists:
        neg = np.where(row < 0)[0]
        if neg.size:
            assert (row[neg[0]:] == -1).all()
        assert row[0] >= 0


def test_group_sub_lists_contract():
    """tests/test_megakernel.py:272: live groups are a prefix, hold valid
    ascending ids, and short groups repeat their first id."""
    lists = torch.tensor([
        [3, 9, 1, 7, 2, -1, -1, -1],
        [-1, -1, -1, -1, -1, -1, -1, -1],
        [5, -1, -1, -1, -1, -1, -1, -1],
    ], dtype=torch.int32)
    g = TT._group_sub_lists(lists, 4).numpy()
    assert g.shape == (3, 8)
    assert list(g[0, :4]) == [1, 3, 7, 9]
    assert list(g[0, 4:]) == [2, 2, 2, 2]
    assert (g[1] == -1).all()
    assert list(g[2, :4]) == [5, 5, 5, 5]
    assert (g[2, 4:] == -1).all()
    np.testing.assert_array_equal(g, np.asarray(JT._group_sub_lists(jnp.asarray(lists.numpy()), 4)))


def test_group_sub_lists_random_rows_match_jax():
    g = np.random.default_rng(5)
    rows = []
    for _ in range(16):
        k = int(g.integers(0, 31))
        row = np.full(30, -1, np.int32)
        row[:k] = g.permutation(40)[:k]
        rows.append(row)
    lists = np.stack(rows)
    port = TT._group_sub_lists(torch.from_numpy(lists), 4).numpy()
    np.testing.assert_array_equal(port, np.asarray(JT._group_sub_lists(jnp.asarray(lists), 4)))


def test_slab_margin_matches_jax(reference):
    world, jw, _, _, _ = reference
    np.testing.assert_array_equal(
        TT._slab_margin(world.block_aabb).numpy(), np.asarray(JT._slab_margin(jw.block_aabb))
    )


def test_wrapper_checks_devices(reference):
    """The wrapper runs the plain version only for CPU tensors; any other
    device gets the kernel or an error, never a silent fallback."""
    world = reference[0]
    w = torch.zeros((512, 16), device="meta")
    lists = torch.zeros((1, 6), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        TT.nearest_hit_fused(w, world, lists, 512)
    with pytest.raises(ValueError, match="tiles"):
        TT.nearest_hit_fused(torch.zeros((100, 16)), world, torch.zeros((1, 6), dtype=torch.int32), 512)
