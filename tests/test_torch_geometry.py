"""The port's geometry ring (``parallel/geometry.py``) and the bake's
``ring_shards`` against the JAX package's, on the CPU.

Mirrors tests/test_geometry_sharded.py:22, :55, :97 and :146 on the Cornell
box at JAX's sizes.  JAX runs its ring once per case on the 8-device CPU
mesh (module fixture ``jax_refs``); the port runs its ring for any D in
one process through the pure functions (``ring_world`` without a mesh
gives a rank every shard in ring order), and over two gloo ranks through
the transport (``tests/_torch_distributed_worker.py``'s ``ring`` job).
Ring images equal JAX's within atol 1e-5 and the port's one-process
``pallas`` render exactly; ring steps equal JAX's within rtol 1e-5 (loss)
and rtol 1e-4 / atol 1e-6 (parameters); the two-rank job equals the
one-process ring bit for bit.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import _torch_distributed_worker as W
from pathtracerap_tpu.config import CameraConfig as JCamera
from pathtracerap_tpu.config import RenderConfig as JRenderConfig
from pathtracerap_tpu.diff.grad import extract_params as jax_extract_params
from pathtracerap_tpu.ops.plucker import bake_world_triangles as jax_bake
from pathtracerap_tpu.parallel import geometry as JG
from pathtracerap_tpu.scene.build import build_cornell_box_scene as jax_cornell
from pathtracerap_tpu_torch import CameraConfig, RenderConfig, build_cornell_box_scene
from pathtracerap_tpu_torch import parallel as P
from pathtracerap_tpu_torch.diff import extract_params, loss_and_grad
from pathtracerap_tpu_torch.kernels import trace as TT
from pathtracerap_tpu_torch.ops.plucker import (
    PACK_MAX_TRIANGLES, bake_world_triangles, keeps_pack, tri_major_ops,
)
from pathtracerap_tpu_torch.ops.rng import prng_key
from pathtracerap_tpu_torch.parallel import geometry as G
from pathtracerap_tpu_torch.parallel.dryrun import geometry_half
from pathtracerap_tpu_torch.parallel.sharding import Mesh
from pathtracerap_tpu_torch.render.camera import generate_rays
from pathtracerap_tpu_torch.render.wavefront import render_accumulate

RES = W.RES
N = RES[0] * RES[1]
SPP, BOUNCES, TILE = 4, 3, 64  # test_geometry_sharded.py:24-29
STEP_KW = W.RING_STEP_KW
# the ring steps of test_geometry_sharded.py:55, :97, :146: name ->
# (resolution, tile, params, parity, target, seed)
STEPS = {
    "mat_color": (RES, N // 8, ("mat_color",), True, 0.0, 0),
    "padding_rays": ((32, 17), 32, ("mat_color",), True, 0.25, 5),
    "vertex_pos": (RES, N // 8, ("mat_color", "vertex_pos"), False, 0.3, 2),
}


def _cfg(engine="pallas", res=RES, spp=SPP, bounces=BOUNCES):
    return RenderConfig(resolution=res, samples_per_pixel=spp, max_bounces=bounces,
                        camera=CameraConfig(**W.CAMERA), engine=engine)


@pytest.fixture(scope="module")
def scenes():
    return jax_cornell().to_device(), build_cornell_box_scene().to_device("cpu")


@pytest.fixture(scope="module")
def jax_refs(scenes):
    """JAX's ring on the 8-device mesh, once per case: the fused and dense
    images, and each of STEPS (loss, new parameters)."""
    js, _ = scenes
    mesh = JMesh(np.asarray(jax.devices()), ("shard",))
    jcam = JCamera(**W.CAMERA)
    cfg = JRenderConfig(resolution=RES, samples_per_pixel=SPP, max_bounces=BOUNCES, camera=jcam,
                        engine="pallas")
    out = {f"image_{e}": np.asarray(JG.render_image_geometry_sharded(js, cfg, mesh=mesh,
                                                                    tile_size=TILE, engine=e))
           for e in ("fused", "dense")}
    for name, (res, tile, names, parity, target, seed) in STEPS.items():
        step = JG.make_geometry_sharded_train_step(
            js, jcam, res, STEP_KW["n_samples"], STEP_KW["max_bounces"], mesh, tile_size=tile,
            parity=parity, param_names=names)
        loss, new = step(jax_extract_params(js, names),
                         jnp.full((res[0] * res[1], 3), target, jnp.float32),
                         jax.random.PRNGKey(seed))
        out[f"step_{name}"] = (float(loss), {k: np.asarray(v) for k, v in new.items()})
    return out


@pytest.fixture(scope="module")
def ring_job(tmp_path_factory):
    """The worker's ring job over two gloo ranks: (arrays, meta)."""
    prefix = str(tmp_path_factory.mktemp("ring") / "run")
    results = W.run_job(prefix, n=2, timeout=120, job="ring")
    assert all(rc == 0 for rc, _ in results), "\n".join(t[-3000:] for _, t in results)
    with open(prefix + ".json") as f:
        meta = json.load(f)
    return dict(np.load(prefix + ".npz")), meta


def _ring_image(ps, world_size, engine, res=RES, spp=SPP, bounces=BOUNCES, tile=TILE, seed=0):
    """The ring render for ``world_size`` ranks in this process: every rank's
    part through the pure functions, gathered and trimmed."""
    world = G.ring_bake(ps, world_size, engine)
    key = prng_key(seed, "cpu")
    cam = CameraConfig(**W.CAMERA)
    parts = [G.render_rank_ring(ps, key, cam, res, spp, bounces, r, world_size,
                                G.ring_world(world, r, world_size, engine), tile_size=tile)
             for r in range(world_size)]
    n = res[0] * res[1]
    return (torch.cat(parts)[:n] / spp).reshape(res[1], res[0], 3).numpy()


def _pallas_image(ps, engine, res=RES, spp=SPP, bounces=BOUNCES, tile=TILE, seed=0):
    """One process's per-bounce pallas render: on the fused bake (kernel 1's
    plain version) for the fused ring, on the bake without a pack (kernel
    5's) for the dense one."""
    world = bake_world_triangles(ps, fused_tile=512 if engine == "fused" else None)
    acc = render_accumulate(ps, prng_key(seed, "cpu"), CameraConfig(**W.CAMERA), res, spp, bounces,
                            engine="pallas", tile_size=tile, world=world)
    return (acc / spp).reshape(res[1], res[0], 3).numpy()


# --------------------------------------------------------------------------
# the bake's ring_shards
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ring_bakes(scenes):
    js, ps = scenes
    return {d: (bake_world_triangles(ps, ring_shards=d),
                jax.jit(functools.partial(jax_bake, ring_shards=d))(js)) for d in (8, 3)}


@pytest.mark.parametrize("field", ["length", "fused_ops", "ops_tri", "block_aabb", "sub_aabb",
                                   "attr_rows", "edge_mat", "cluster_aabb"])
@pytest.mark.parametrize("d", [8, 3])
def test_ring_bake_equals_jax(ring_bakes, d, field):
    """plucker.py:66-98, :194-199, :304-312: the triangle axis padded to D
    blocks of 512, every block row kept (padding blocks NaN), ``ops_tri``
    the padded pack's triangle-major copy; bit for bit JAX's."""
    world, jw = ring_bakes[d]
    if field == "length":
        assert world.num_triangles == jw.valid.shape[0] == d * 512
        assert world.tri_block == 512 and world.n_valid == jw.n_valid == 48
        assert world.block_aabb.shape == (d, 8)
        return
    if field == "ops_tri":
        np.testing.assert_array_equal(world.ops_tri.numpy(),
                                      tri_major_ops(torch.from_numpy(np.array(jw.fused_ops)),
                                                    512).numpy())
        return
    a, b = getattr(world, field).numpy(), np.asarray(getattr(jw, field))
    np.testing.assert_array_equal(a, b)  # NaN rows included, at the same places
    if field == "block_aabb":
        assert np.isnan(a[1:]).all() and np.isfinite(a[0]).all()


def test_plain_bake_unchanged_by_the_ring_bake(scenes):
    """The ring bake's real triangles are the plain bake's, in its order;
    the plain bake keeps only its real blocks."""
    _, ps = scenes
    plain = bake_world_triangles(ps)
    ring = bake_world_triangles(ps, ring_shards=8)
    t = plain.num_triangles
    assert plain.block_aabb.shape[0] == 1 and t == 512
    np.testing.assert_array_equal(ring.ops_tri[:t].numpy(), plain.ops_tri.numpy())
    np.testing.assert_array_equal(ring.block_aabb[:1].numpy(), plain.block_aabb.numpy())
    for f in ("v0", "e1", "e2", "shade_normal", "mat_type", "tri_model", "plane_n"):
        np.testing.assert_array_equal(getattr(ring, f)[:t].numpy(), getattr(plain, f).numpy())
    dense = bake_world_triangles(ps, fused_tile=None, ring_shards=3)
    assert dense.fused_ops is None and dense.num_triangles == 3 * 128 * 2  # 512 -> 768
    np.testing.assert_array_equal(dense.edge_mat[..., :t].numpy(),
                                  bake_world_triangles(ps, fused_tile=None).edge_mat.numpy())


def test_ring_keeps_the_pack_above_the_budget():
    """plucker.py:194: the budget drops the pack only without ring_shards."""
    assert not keeps_pack(PACK_MAX_TRIANGLES + 128)
    assert keeps_pack(PACK_MAX_TRIANGLES + 128, ring_shards=2)
    assert keeps_pack(PACK_MAX_TRIANGLES)


# --------------------------------------------------------------------------
# shards
# --------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["fused", "dense"])
def test_ring_world_specs(scenes, engine):
    """ring_world_specs: the heavy pack's sharded fields, the tables every
    rank keeps, and the rest dropped."""
    _, ps = scenes
    world = G.ring_bake(ps, 2, engine)
    specs = P.ring_world_specs(world, engine)
    if engine == "fused":  # fused_ops only where the plain version reads it (the CPU)
        assert specs["sharded"] == {"ops_tri": 0, "block_aabb": 0, "fused_ops": 1}
    else:
        assert specs["sharded"] == {"edge_mat": 2, "plane_mat": 1, "cluster_aabb": 1}
    kept = {"shade_normal", "mat_type", "mat_color", "mat_ri", "plane_n", "v0", "e1", "e2",
            "tri_model", "mat_table"}
    assert kept <= set(specs["replicated"])
    assert not set(specs["replicated"]) & set(G.HEAVY_FIELDS)
    assert set(specs["dropped"]) | set(specs["sharded"]) == set(G.HEAVY_FIELDS)
    tables = G.ring_tables(world)
    assert all(getattr(tables, f) is None for f in G.HEAVY_FIELDS)


@pytest.mark.parametrize("engine", ["fused", "dense"])
@pytest.mark.parametrize("d", [8, 3])
def test_ring_shards_cut_the_world(scenes, engine, d):
    """ring_shard: the D shards of each sharded field concatenate to the
    world's, each in storage of its own, with its offset and real count
    clamp(n_valid - offset, 0, T / D)."""
    _, ps = scenes
    world = G.ring_bake(ps, d, engine)
    shards = [G.ring_shard(world, r, d, engine) for r in range(d)]
    ts = world.num_triangles // d
    for name, axis in P.ring_world_specs(world, engine)["sharded"].items():
        whole = torch.cat([s.tensors[name] for s in shards], dim=axis)
        np.testing.assert_array_equal(whole.numpy(), getattr(world, name).numpy())
    for r, s in enumerate(shards):
        assert (s.offset, s.tris, s.index) == (r * ts, ts, r)
        assert s.n_valid == max(0, min(world.n_valid - r * ts, ts))
        for x in s.tensors.values():
            assert x.is_contiguous() and x.untyped_storage().nbytes() == x.numel() * 4
    stats = G.ring_stats(world, G.ring_world(world, 0, d, engine))
    assert sum(s.nbytes for s in shards) == stats["world_sharded_bytes"]
    # the tables a rank keeps: every tensor of the world outside the heavy pack
    kept = P.ring_world_specs(world, engine)["replicated"]
    assert stats["tables_bytes"] == sum(getattr(world, k).numel() * getattr(world, k).element_size()
                                        for k in kept)
    # a payload round trip keeps every tensor
    again = shards[0].received(shards[1].flat(), 1)
    for name, x in shards[1].tensors.items():
        np.testing.assert_array_equal(again.tensors[name].numpy(), x.numpy())  # NaN rows too
    assert (again.offset, again.n_valid) == (shards[1].offset, shards[1].n_valid)


def test_ring_shard_needs_the_ring_bake(scenes):
    _, ps = scenes
    with pytest.raises(ValueError, match="ring_shards"):
        G.ring_shard(bake_world_triangles(ps), 0, 2)  # 512 triangles, 1 block
    with pytest.raises(ValueError, match="fused pack"):
        G.ring_shard(bake_world_triangles(ps, fused_tile=None, ring_shards=2), 0, 2)
    with pytest.raises(ValueError, match="unknown ring engine"):
        G.ring_bake(ps, 2, "mxu")


def test_padding_only_shard(scenes):
    """Cornell on 8 ranks: shards 1 to 7 hold padding only.  Their block
    boxes are NaN: the worklists reject them in both branches and the slab
    margin stays finite.  Such a shard makes no launch (no plain call on
    the CPU) and gives misses; the ring still visits it."""
    _, ps = scenes
    world = G.ring_bake(ps, 8)
    empty = G.ring_shard(world, 5, 8)
    assert empty.n_valid == 0 and torch.isnan(empty.tensors["block_aabb"]).all()
    ro, rd = generate_rays(CameraConfig(**W.CAMERA), RES, device="cpu")
    box = empty.tensors["block_aabb"]
    margin = TT._slab_margin(box)
    assert torch.isfinite(margin) and margin.item() == pytest.approx(TT.EPS)
    alive = torch.ones((N, 1))
    assert (TT._tile_block_lists(box, ro, rd, alive, 512, margin) == -1).all()
    many = box.repeat(TT.FRUSTUM_LIST_THRESHOLD + 1, 1)  # the frustum branch
    assert (TT._tile_block_lists(many, ro, rd, alive, 512) == -1).all()
    calls = TT.nearest_hit_fused_plain.calls
    rec, idx = G.trace_shards(G.ring_tables(world), [empty], ro, rd, return_idx=True)
    assert TT.nearest_hit_fused_plain.calls == calls
    assert (rec.t == G.F_MAX).all() and (idx == 0).all()
    # a rank with every shard but the real one sees misses; with it, hits
    own = G.ring_shard(world, 0, 8)
    rec_all = G.trace_shards(G.ring_tables(world), [empty, own], ro, rd)
    ref = TT.trace_pallas(bake_world_triangles(ps), ro, rd)
    assert torch.equal(rec_all.t, ref.t) and torch.equal(rec_all.normal, ref.normal)


@pytest.mark.parametrize("engine", ["fused", "dense"])
def test_merge_breaks_ties_by_global_index(scenes, engine):
    """geometry.py:102-107: the same triangles in two shards hit at the same
    t; the merge keeps the lower global index in either visiting order."""
    _, ps = scenes
    world = G.ring_bake(ps, 2, engine)
    a = G.ring_shard(world, 0, 2, engine)
    twin = a.received(a.flat(), 1)  # shard 0's triangles at shard 1's offset
    twin = dataclasses.replace(twin, n_valid=a.n_valid)
    ro, rd = generate_rays(CameraConfig(**W.CAMERA), RES, device="cpu")
    tables = G.ring_tables(world)
    rec0, i0 = G.trace_shards(tables, [a], ro, rd, return_idx=True)
    for order in ([a, twin], [twin, a]):
        rec, idx = G.trace_shards(tables, order, ro, rd, return_idx=True)
        assert torch.equal(rec.t, rec0.t) and torch.equal(idx, i0)
    _, it = G.trace_shards(tables, [twin], ro, rd, return_idx=True)
    hit = rec0.t < G.F_MAX
    assert hit.any() and torch.equal(it[hit], i0[hit] + a.tris)


# --------------------------------------------------------------------------
# the ring render
# --------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["fused", "dense"])
def test_ring_render_matches_jax(jax_refs, scenes, engine):
    """test_geometry_sharded.py:22: the ring on 8 ranks (each rank's shard
    and RNG tiles JAX's device's) within atol 1e-5 of JAX's ring."""
    _, ps = scenes
    img = _ring_image(ps, 8, engine)
    assert img.shape == (RES[1], RES[0], 3) and np.isfinite(img).all() and img.max() > 0.05
    np.testing.assert_allclose(img, jax_refs[f"image_{engine}"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("engine", ["fused", "dense"])
@pytest.mark.parametrize("d", [8, 2, 3, 1])
def test_ring_render_equals_one_process(jax_refs, scenes, engine, d):
    """The lexicographic merge makes the ring's image the one-process
    ``pallas`` render's, bit for bit, for any D (the dense ring against the
    render on a world without a pack), and so JAX's 8-device ring's within
    atol 1e-5."""
    _, ps = scenes
    img = _ring_image(ps, d, engine)
    np.testing.assert_array_equal(img, _pallas_image(ps, engine))
    np.testing.assert_allclose(img, jax_refs[f"image_{engine}"], rtol=0, atol=1e-5)


def test_ring_render_facade_one_rank(scenes):
    """render_image_geometry_sharded without a group: one rank that holds
    every shard, and its stats."""
    _, ps = scenes
    stats = {}
    img = P.render_image_geometry_sharded(ps, _cfg(), mesh=Mesh(0, 1, torch.device("cpu")),
                                          tile_size=TILE, stats=stats).numpy()
    np.testing.assert_array_equal(img, _pallas_image(ps, "fused"))
    assert stats["transfers"] == 0 and stats["shard_bytes"] == stats["world_sharded_bytes"]


def test_ring_tracers_check_their_engine(scenes):
    _, ps = scenes
    world_l = G.ring_world(G.ring_bake(ps, 2, "dense"), 0, 2, "dense")
    ro, rd = generate_rays(CameraConfig(**W.CAMERA), RES, device="cpu")
    with pytest.raises(ValueError, match="dense ring world"):
        P.make_geometry_sharded_tracer_fused()(world_l, ro, rd)
    rec = P.make_geometry_sharded_tracer()(world_l, ro, rd)
    assert torch.equal(rec.t, TT.trace_pallas(bake_world_triangles(ps, fused_tile=None), ro, rd).t)


# --------------------------------------------------------------------------
# the ring train steps
# --------------------------------------------------------------------------


def _ring_step_here(ps, name, d=8):
    """STEPS[name] over D ranks in this process: each rank's loss and
    gradients (the pure rank function), summed, and the SGD update."""
    res, tile, names, parity, target, seed = STEPS[name]
    cam = CameraConfig(**W.CAMERA)
    params = extract_params(ps, names)
    target = torch.full((res[0] * res[1], 3), target)
    frozen = None
    if names == ("mat_color",):
        frozen_world = G.ring_bake(ps, d)
    loss, grads = 0.0, {k: 0.0 for k in names}
    for r in range(d):
        if names == ("mat_color",):
            frozen = G.ring_world(frozen_world, r, d).detached()
        l_r, g_r = G.rank_ring_loss_and_grad(
            params, ps, target, prng_key(seed, "cpu"), cam, res, STEP_KW["n_samples"],
            STEP_KW["max_bounces"], r, d, frozen=frozen, tile_size=tile, parity=parity)
        loss = loss + l_r
        grads = {k: grads[k] + g_r[k] for k in names}
    return float(loss), {k: (params[k] - 0.05 * grads[k]).numpy() for k in names}


@pytest.mark.parametrize("name", list(STEPS))
def test_ring_step_matches_jax(jax_refs, scenes, name):
    """test_geometry_sharded.py:55, :97 (the padding rays of 32x17 masked
    out of the loss) and :146 (the re-baking vertex_pos step, quality
    mode): the port's ring step on 8 ranks against JAX's."""
    _, ps = scenes
    loss, new = _ring_step_here(ps, name)
    jloss, jnew = jax_refs[f"step_{name}"]
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    for k, v in new.items():
        np.testing.assert_allclose(v, jnew[k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert np.abs(new["mat_color"] - ps.mat_color.numpy()).max() > 0
    if name == "vertex_pos":
        assert np.abs(new["vertex_pos"] - ps.vertex_pos.numpy()).max() > 0


@pytest.mark.parametrize("name", list(STEPS))
def test_ring_step_equals_one_process_gradient(scenes, name):
    """The ring step against the one-process ``pallas`` sum loss and its
    gradient (the same tiles): equal up to the order of the sums."""
    _, ps = scenes
    res, tile, names, parity, target, seed = STEPS[name]
    loss, new = _ring_step_here(ps, name, d=2)
    n = res[0] * res[1]
    params = extract_params(ps, names)
    cam = CameraConfig(**W.CAMERA)
    # the padded rays of the 2-rank split, padding rows weighted 0
    per = -(-(-(-n // 2)) // tile) * tile
    ro, rd = generate_rays(cam, res, device="cpu")
    pad = 2 * per - n
    ro = torch.cat([ro, ro.new_zeros(pad, 3)])
    rd = torch.cat([rd, rd.new_ones(pad, 3)])
    weight = (torch.arange(2 * per) < n).to(torch.float32)
    tgt = torch.cat([torch.full((n, 3), target), torch.zeros(pad, 3)])
    loss1, g1 = loss_and_grad(params, ps, tgt, prng_key(seed, "cpu"), cam, res,
                              STEP_KW["n_samples"], STEP_KW["max_bounces"], tile_size=tile, ro=ro,
                              rd=rd, reduce="sum", parity=parity, weight=weight)
    np.testing.assert_allclose(loss, float(loss1), rtol=1e-6)
    for k in names:
        np.testing.assert_allclose(new[k], (params[k] - 0.05 * g1[k]).numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


# --------------------------------------------------------------------------
# the transport: two gloo ranks
# --------------------------------------------------------------------------


@pytest.mark.parametrize("engine", list(W.RING_RENDERS))
def test_two_rank_ring_render_equals_one_process(ring_job, scenes, engine):
    """The worker's ring over two gloo ranks equals the pure ring for D = 2
    bit for bit; each rank held half the sharded fields and made D - 1 = 1
    transfer a trace call (1 + 4 x 2 calls)."""
    arrays, meta = ring_job
    _, ps = scenes
    _, spp, bounces, tile = W.RING_RENDERS[engine]
    np.testing.assert_array_equal(arrays[f"ring_{engine}"],
                                  _ring_image(ps, 2, engine, spp=spp, bounces=bounces, tile=tile))
    assert meta["backend"] == "gloo" and meta["info"]["process_count"] == 2
    for r in range(2):
        s = meta[f"stats_{engine}_rank{r}"]
        assert 2 * s["shard_bytes"] == s["world_sharded_bytes"] < s["world_heavy_bytes"]
        assert s["transfers"] == 1 + spp * (bounces - 1)
        assert s["bytes_sent"] == s["transfers"] * s["shard_bytes"]


@pytest.mark.parametrize("name", list(W.RING_STEPS))
def test_two_rank_ring_step_equals_one_process(ring_job, scenes, name):
    """The worker's ring step (one all_reduce of both ranks' loss and
    gradients) equals the two ranks' pure losses and gradients summed
    here, bit for bit."""
    arrays, meta = ring_job
    _, ps = scenes
    names, parity, target, seed = W.RING_STEPS[name]
    params = extract_params(ps, names)
    cam = CameraConfig(**W.CAMERA)
    frozen_world = G.ring_bake(ps, 2) if names == ("mat_color",) else None
    parts = []
    for r in range(2):
        frozen = G.ring_world(frozen_world, r, 2).detached() if frozen_world is not None else None
        parts.append(G.rank_ring_loss_and_grad(
            params, ps, torch.full((N, 3), target), prng_key(seed, "cpu"), cam, RES,
            STEP_KW["n_samples"], STEP_KW["max_bounces"], r, 2, frozen=frozen,
            tile_size=STEP_KW["tile_size"], parity=parity))
    assert meta[f"loss_{name}"] == (parts[0][0] + parts[1][0]).item()
    for k in names:
        new = params[k] - 0.05 * (parts[0][1][k] + parts[1][1][k])
        np.testing.assert_array_equal(arrays[f"step_{name}_{k}"], new.numpy(), err_msg=k)


# --------------------------------------------------------------------------
# exports and the dry run's geometry half
# --------------------------------------------------------------------------


def test_parallel_exports_the_ring():
    for name in ("make_geometry_sharded_tracer", "make_geometry_sharded_tracer_fused",
                 "make_ring_diff_tracer", "render_image_geometry_sharded",
                 "make_geometry_sharded_train_step", "ring_world_specs"):
        assert name in P.__all__ and callable(getattr(P, name))


def test_dryrun_geometry_half_one_rank(scenes):
    """__graft_entry__.py:124-187 as the dry run runs it, here on one rank:
    the ring image equal to the replicated pallas render, a ring mat_color
    step that moves, and the re-baking vertex_pos step against
    loss_and_grad."""
    _, ps = scenes
    res = geometry_half(ps, CameraConfig(**W.CAMERA), Mesh(0, 1, torch.device("cpu")))
    assert res["ring_image_equal"] and res["ring_step_delta"] > 0
    assert res["ring_vertex_max_grad"] > 0
