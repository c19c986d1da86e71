"""The port's scene build, device data and world bake against the JAX package."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from pathtracerap_tpu.ops.plucker import bake_world_triangles as jax_bake
from pathtracerap_tpu.scene.build import build_cornell_box_scene
from pathtracerap_tpu.scene.build import build_reference_scene as jax_reference_scene
from pathtracerap_tpu_torch import convert
from pathtracerap_tpu_torch.ops.plucker import bake_world_triangles, cluster_group_aabb, tri_major_ops
from pathtracerap_tpu_torch.scene import build_reference_scene
from pathtracerap_tpu_torch.scene.types import SceneDevice, WorldTriangles


def _fields(obj) -> dict:
    return {f.name: (np.asarray(v) if v is not None and not isinstance(v, (int, tuple)) else v)
            for f in dataclasses.fields(obj) for v in [getattr(obj, f.name)]}


@pytest.fixture(scope="module")
def hosts():
    return build_reference_scene(), jax_reference_scene()


@pytest.fixture(scope="module")
def worlds(hosts):
    port_host, jax_host = hosts
    jw = jax.jit(jax_bake)(jax_host.to_device())
    return bake_world_triangles(port_host.to_device("cpu")), jw


def test_scene_host_arrays_equal(hosts):
    port, ref = hosts
    for f in dataclasses.fields(port):
        np.testing.assert_array_equal(getattr(port, f.name), getattr(ref, f.name), err_msg=f.name)
    assert port.num_models == 11 and port.num_triangles == ref.num_triangles


def test_world_instance_maps_and_device(hosts):
    port, ref = hosts
    for a, b in zip(port.world_instance_maps(), ref.world_instance_maps()):
        np.testing.assert_array_equal(a, b)
    dev = port.to_device("cpu")
    jdev = ref.to_device()
    assert dev.n_world_valid == jdev.n_world_valid == 3045
    for f in dataclasses.fields(SceneDevice):
        v = getattr(dev, f.name)
        if isinstance(v, torch.Tensor):
            np.testing.assert_array_equal(v.numpy(), np.asarray(getattr(jdev, f.name)), err_msg=f.name)


def test_bake_order_equal(worlds):
    """The (fat | Morton | padding) triangle order is identical: every
    per-triangle attribute row lines up column for column."""
    port, ref = worlds
    np.testing.assert_array_equal(port.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(port.mat_type.numpy(), np.asarray(ref.mat_type))
    np.testing.assert_array_equal(port.attr_rows[3:7].numpy(), np.asarray(ref.attr_rows)[3:7])
    np.testing.assert_array_equal(port.attr_rows[10:12].numpy(), np.asarray(ref.attr_rows)[10:12])
    assert port.tri_block == ref.tri_block == 512
    assert port.n_valid == ref.n_valid == 3045


@pytest.mark.parametrize(
    "field", ["fused_ops", "block_aabb", "sub_aabb", "attr_rows", "edge_pluecker",
              "plane_n", "plane_d", "shade_normal", "mat_color", "mat_ri"],
)
def test_bake_fields_agree(worlds, field):
    port, ref = worlds
    a, b = getattr(port, field).numpy(), np.asarray(getattr(ref, field))
    assert a.shape == b.shape
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    scale = max(1.0, float(np.nanmax(np.abs(b))))
    np.testing.assert_allclose(a, b, atol=1e-5 * scale, rtol=0, equal_nan=True)


def test_fused_pack_bit_equal(worlds):
    """The operand pack the kernels read is bit-equal to the JAX bake's."""
    port, ref = worlds
    np.testing.assert_array_equal(port.fused_ops.numpy(), np.asarray(ref.fused_ops))


def test_block_and_sub_aabb_padding(worlds):
    """block_aabb keeps only the 6 real blocks; sub-block padding rows are
    NaN (a min/max-swapped slab test would always hit an inverted box)."""
    port, _ = worlds
    assert port.block_aabb.shape == (6, 8)
    assert port.sub_aabb.shape == (32, 8)
    nsb_real = -(-port.n_valid // 128)
    assert torch.isfinite(port.sub_aabb[:nsb_real]).all()
    assert torch.isnan(port.sub_aabb[nsb_real:]).all()
    assert port.fused_ops.shape == (16, 16384) and port.attr_rows.shape == (16, 4096)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
def test_bake_of_converted_scene(scale):
    """A JAX scene carried across by convert.scene_from_numpy bakes to the
    JAX bake's pack (the Cornell box at extreme scales)."""
    jscene = build_cornell_box_scene(size=400.0 * scale).to_device()
    scene = convert.scene_from_numpy(_fields(jscene), "cpu")
    port, ref = bake_world_triangles(scene), jax.jit(jax_bake)(jscene)
    for field in ("fused_ops", "block_aabb", "sub_aabb", "attr_rows"):
        a, b = getattr(port, field).numpy(), np.asarray(getattr(ref, field))
        np.testing.assert_allclose(a, b, atol=1e-5 * scale * 400, rtol=0, equal_nan=True)


def test_convert_round_trip(worlds, hosts):
    _, jw = worlds
    w = convert.world_from_numpy(_fields(jw), "cpu")
    assert isinstance(w, WorldTriangles)
    for f in dataclasses.fields(WorldTriangles):
        v = getattr(w, f.name)
        if f.name == "ops_tri":  # the port's own triangle-major copy of fused_ops
            np.testing.assert_array_equal(v.numpy(), tri_major_ops(w.fused_ops, w.tri_block).numpy())
            continue
        if f.name == "group_aabb":  # the port's own union boxes of cluster_aabb (kernel 5's gate)
            np.testing.assert_array_equal(v.numpy(), cluster_group_aabb(w.cluster_aabb, w.n_valid).numpy())
            continue
        ref = getattr(jw, f.name)
        if isinstance(v, torch.Tensor):
            np.testing.assert_array_equal(v.numpy(), np.asarray(ref), err_msg=f.name)
        else:
            assert v == ref, f.name
    s = convert.scene_from_numpy(_fields(hosts[1].to_device()), "cpu")
    assert isinstance(s, SceneDevice) and s.n_world_valid == 3045
    np.testing.assert_array_equal(s.vertex_pos.numpy(), hosts[1].vertex_pos)
