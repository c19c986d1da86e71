"""The port's dense trace (kernel 5's plain version, the dense branch of
``trace_pallas``) and its no-pack bake against the JAX package: the dense
Pallas kernel ``nearest_hit`` runs in interpret mode on the CPU, on the
operands of JAX's own no-pack bake carried across by ``convert``."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracerap_tpu.ops.plucker import bake_world_triangles as jax_bake
from pathtracerap_tpu.pallas import trace as JT
from pathtracerap_tpu.scene.build import build_cornell_box_scene as jax_cornell
from pathtracerap_tpu.scene.build import build_reference_scene as jax_reference
from pathtracerap_tpu_torch import convert
from pathtracerap_tpu_torch.kernels import trace as TT
from pathtracerap_tpu_torch.ops import plucker as TP

F_MAX = 9999999.0
SCENES = {"cornell": jax_cornell, "reference": jax_reference}


def _fields(obj) -> dict:
    return {f.name: (np.asarray(v) if v is not None and not isinstance(v, (int, tuple)) else v)
            for f in dataclasses.fields(obj) for v in [getattr(obj, f.name)]}


def _rays(n=640, seed=1234, scale=1.0):
    """tests/test_pallas_trace.py:19's rays: origins in a box, directions
    toward random targets, unnormalized."""
    g = np.random.default_rng(seed)
    ro = (g.uniform(-150, 150, size=(n, 3)) * scale).astype(np.float32)
    target = (g.uniform(-180, 180, size=(n, 3)) * scale).astype(np.float32)
    return ro, (target - ro).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _nopack(name: str, scale: float = 1.0):
    """(JAX scene, JAX no-pack world, the port's world converted from it)."""
    js = (jax_cornell(size=400.0 * scale) if scale != 1.0 else SCENES[name]()).to_device()
    jw = jax.jit(functools.partial(jax_bake, fused_tile=None))(js)
    return js, jw, convert.world_from_numpy(_fields(jw), "cpu")


def _assert_same_hits(t, idx, t_ref, idx_ref, lanes):
    """t within rtol 1e-6; equal indices except where two triangles tie on
    exactly the same t (XLA's CPU rsqrt, ROADMAP queue C)."""
    t, idx, t_ref, idx_ref = t[lanes], idx[lanes], t_ref[lanes], idx_ref[lanes]
    np.testing.assert_allclose(t, t_ref, rtol=1e-6, atol=0)
    differ = idx != idx_ref
    np.testing.assert_array_equal(t[differ], t_ref[differ])
    assert differ.mean() < 0.01


@pytest.mark.parametrize("cull", [True, False])
@pytest.mark.parametrize("name", ["cornell", "reference"])
def test_nearest_hit_plain_matches_jax(name, cull):
    """Kernel 5's plain version against ``_nearest_hit_kernel`` on the same
    operands; a third of the lanes dead.  With ``cull`` a dead lane's
    result is unspecified, so the live ones are compared."""
    _, jw, world = _nopack(name)
    ro, rd = _rays()
    alive = torch.arange(ro.shape[0]) % 3 != 0
    w, wo = TT.dense_inputs(torch.from_numpy(ro), torch.from_numpy(rd), alive)
    before = TT.nearest_hit_plain.calls
    t, idx = TT.nearest_hit(w, wo, world.edge_mat, world.plane_mat, world.cluster_aabb,
                            cull=cull, n_valid=world.n_valid, group_aabb=world.group_aabb)
    assert TT.nearest_hit_plain.calls == before + 1
    t_j, idx_j = JT.nearest_hit(jnp.asarray(w.numpy()), jnp.asarray(wo.numpy()), jw.edge_mat,
                                jw.plane_mat, jw.cluster_aabb, cull=cull, n_valid=jw.n_valid)
    live = wo[:, 4].numpy() > 0 if cull else np.ones(w.shape[0], bool)
    t, idx, t_j, idx_j = t.numpy(), idx.numpy(), np.asarray(t_j), np.asarray(idx_j)
    _assert_same_hits(t, idx, t_j, idx_j, live)
    assert (idx[live] >= 0).mean() > 0.3 and (t[idx < 0] == F_MAX).all()


def test_nearest_hit_plain_chunks_keep_the_lowest_index(monkeypatch):
    """Sweeping the triangles in chunks of 128 changes no bit: a later
    chunk replaces the best only on a strictly smaller t."""
    _, _, world = _nopack("reference")
    ro, rd = _rays(seed=7)
    w, wo = TT.dense_inputs(torch.from_numpy(ro), torch.from_numpy(rd))
    args = (w, wo, world.edge_mat, world.plane_mat, world.n_valid)
    t, idx = TT.nearest_hit_plain(*args)
    monkeypatch.setattr(TT, "DENSE_TRI_CHUNK", 128)
    t_c, idx_c = TT.nearest_hit_plain(*args)
    assert torch.equal(t, t_c) and torch.equal(idx, idx_c)


@pytest.mark.parametrize("scale", [1e-3, 1e3])
def test_dense_trace_pallas_matches_jax_at_extreme_scales(scale):
    """tests/test_pallas_trace.py:55 on the dense branch: the cull margin
    is scale-relative, so at millimetre and kilometre scales the port's
    dense ``trace_pallas`` agrees with JAX's, hit for hit."""
    _, jw, world = _nopack("cornell", scale)
    ro, rd = _rays(scale=scale)
    h, idx = TT.trace_pallas(world, torch.from_numpy(ro), torch.from_numpy(rd), return_idx=True)
    h_j, idx_j = JT.trace_pallas(jw, ro, rd, return_idx=True)
    t, t_j = h.t.numpy(), np.asarray(h_j.t)
    np.testing.assert_array_equal(t < F_MAX, t_j < F_MAX)
    _assert_same_hits(t, idx.numpy(), t_j, np.asarray(idx_j), np.ones(t.shape, bool))
    np.testing.assert_array_equal(h.mat_type.numpy(), np.asarray(h_j.mat_type))
    np.testing.assert_allclose(h.normal.numpy(), np.asarray(h_j.normal), atol=1e-6)


@pytest.mark.parametrize("name", ["cornell", "reference"])
def test_no_pack_bake_matches_jax(name):
    """The port's ``bake_world_triangles(fused_tile=None)``: no pack,
    ``tri_block`` 0, the triangle axis padded to 128, and the dense
    operands and cluster boxes of JAX's bake."""
    js, jw, _ = _nopack(name)
    world = TP.bake_world_triangles(convert.scene_from_numpy(_fields(js), "cpu"), fused_tile=None)
    assert world.fused_ops is None and world.block_aabb is None and world.attr_rows is None
    assert world.sub_aabb is None and world.tri_block == jw.tri_block == 0
    assert world.n_valid == jw.n_valid
    t = world.plane_mat.shape[1]
    assert t == jw.plane_mat.shape[1] and t % 128 == 0
    assert world.cluster_aabb.shape == (8, t // 128)
    for field in ("edge_mat", "plane_mat", "cluster_aabb", "edge_pluecker", "valid", "mat_type"):
        a, b = getattr(world, field).numpy(), np.asarray(getattr(jw, field))
        assert a.shape == b.shape, field
        scale = max(1.0, float(np.abs(b[np.abs(b) < F_MAX]).max()))
        np.testing.assert_allclose(a, b, atol=1e-5 * scale, rtol=0, err_msg=field)
    # padding clusters are inverted boxes; the zero rows stay zero
    n_real = -(-world.n_valid // 128)
    assert (world.cluster_aabb[0:3, n_real:] == F_MAX).all()
    assert (world.edge_mat[:, 6:8] == 0).all() and (world.plane_mat[4:8] == 0).all()
    assert world.edge_pluecker.data_ptr() == world.edge_mat.data_ptr()


def test_pack_cap_predicate():
    """The bake keeps the fused pack up to 2,097,152 world triangles, as
    JAX's does (``ops/plucker.py:194``), and drops it above."""
    assert TP.PACK_MAX_TRIANGLES == 2_097_152
    assert TP.keeps_pack(2_097_152)
    assert not TP.keeps_pack(2_097_153)


def test_bake_drops_the_pack_above_the_cap(monkeypatch):
    """Above the cap the bake pads to 128 and emits no pack, whatever
    ``fused_tile`` asks for (the cap lowered to the reference scene)."""
    js, jw, _ = _nopack("reference")
    scene = convert.scene_from_numpy(_fields(js), "cpu")
    monkeypatch.setattr(TP, "PACK_MAX_TRIANGLES", 1024)
    world = TP.bake_world_triangles(scene)
    assert world.fused_ops is None and world.tri_block == 0
    assert world.plane_mat.shape == jw.plane_mat.shape


def test_trace_pallas_cull_false_takes_the_dense_sweep():
    """A packed world traced with ``cull=False`` goes through kernel 5, as
    JAX's trace_pallas does, and finds the worklist trace's hits."""
    js, _, _ = _nopack("reference")
    world = TP.bake_world_triangles(convert.scene_from_numpy(_fields(js), "cpu"))
    ro, rd = (torch.from_numpy(x) for x in _rays(seed=3))
    calls = TT.nearest_hit_plain.calls, TT.nearest_hit_fused_plain.calls
    dense, i_d = TT.trace_pallas(world, ro, rd, cull=False, return_idx=True)
    assert (TT.nearest_hit_plain.calls, TT.nearest_hit_fused_plain.calls) == (calls[0] + 1, calls[1])
    listed, i_l = TT.trace_pallas(world, ro, rd, return_idx=True)
    _assert_same_hits(dense.t.numpy(), i_d.numpy(), listed.t.numpy(), i_l.numpy(),
                      np.ones(ro.shape[0], bool))


def test_nearest_hit_wrapper_checks_devices():
    """The plain version runs only for CPU tensors; any other device gets
    the kernel or an error, and the ray count must fill whole tiles."""
    _, _, world = _nopack("cornell")
    ops = (world.edge_mat, world.plane_mat, world.cluster_aabb)
    with pytest.raises(ValueError, match="no kernel"):
        TT.nearest_hit(torch.zeros((256, 8), device="meta"), torch.zeros((256, 8), device="meta"),
                       *(x.to("meta") for x in ops), group_aabb=world.group_aabb.to("meta"))
    with pytest.raises(ValueError, match="tiles"):
        TT.nearest_hit(torch.zeros((100, 8)), torch.zeros((100, 8)), *ops,
                       group_aabb=world.group_aabb)
