"""The port's differentiable path against the JAX package's, on the CPU.

The JAX side runs as its own tests run it: Pallas in interpret mode.  Its
``make_idxs_multi`` and ``replay`` are closures inside
``render_samples_fused_diff`` (``diff/fast.py:329-391``); the tests below
rebuild them step for step from the JAX package's module functions.

One difference between the two CPU backends is not the port's: XLA's CPU
``rsqrt`` (the in-kernel ray normalization of the JAX trace kernels) is
within one ulp of the correctly rounded value but not equal to it on about
15 % of inputs, while ``torch.rsqrt`` is correctly rounded.  A ray that
crosses the shared edge of two triangles at an exact-t tie can then pick
the other triangle: about one live ray in a thousand per bounce here.  The
index-stream tests therefore allow a winner to differ only where both
winners' t agree (a tie), and the gradient tests whose value moves with
such a flip (vertex gradients) run where the streams agree exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracerap_tpu.config import CameraConfig
from pathtracerap_tpu.diff import fast as JF
from pathtracerap_tpu.diff import grad as JG
from pathtracerap_tpu.ops.math import normalize as jax_normalize
from pathtracerap_tpu.ops.plucker import bake_world_triangles as jax_bake
from pathtracerap_tpu.pallas import megakernel as JM
from pathtracerap_tpu.pallas.trace import _slab_margin as jax_slab_margin
from pathtracerap_tpu.pallas.trace import trace_pallas as jax_trace_pallas
from pathtracerap_tpu.render.camera import generate_rays as jax_generate_rays
from pathtracerap_tpu.render.shade import RayState as JRayState
from pathtracerap_tpu.render.shade import gather_contribution as jax_gather_contribution
from pathtracerap_tpu.render.shade import shade as jax_shade
from pathtracerap_tpu.scene.build import build_cornell_box_scene
from pathtracerap_tpu.scene.build import build_reference_scene as jax_reference_scene
from pathtracerap_tpu_torch import convert
from pathtracerap_tpu_torch.diff import fast as TF
from pathtracerap_tpu_torch.diff import grad as TG
from pathtracerap_tpu_torch.kernels import megakernel as TM
from pathtracerap_tpu_torch.kernels.trace import _slab_margin, trace_pallas
from pathtracerap_tpu_torch.ops.math import normalize
from pathtracerap_tpu_torch.ops.plucker import bake_world_triangles
from pathtracerap_tpu_torch.ops.rng import prng_key
from pathtracerap_tpu_torch.render.camera import generate_rays
from pathtracerap_tpu_torch.scene import build_reference_scene

F_MAX = 9999999.0
CAM = CameraConfig()
RES, SMALL = (32, 16), (16, 8)
SPP, BOUNCES = 2, 4
GRAD_TOL = dict(rtol=1e-4, atol=1e-7)  # tests/test_grad.py:205-212
REPLAY_FIELDS = ("v0", "e1", "e2", "shade_normal", "mat_table")


def _fields(obj) -> dict:
    return {f.name: (np.asarray(v) if v is not None and not isinstance(v, (int, tuple)) else v)
            for f in dataclasses.fields(obj) for v in [getattr(obj, f.name)]}


def _np(x) -> np.ndarray:
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def scenes():
    return build_reference_scene().to_device("cpu"), jax_reference_scene().to_device()


@pytest.fixture(scope="module")
def worlds(scenes):
    scene, jscene = scenes
    return bake_world_triangles(scene), jax.jit(jax_bake)(jscene)


def _target(n: int) -> np.ndarray:
    return np.random.default_rng(11).uniform(0.0, 0.5, size=(n, 3)).astype(np.float32)


# --------------------------------------------------------------------------
# the bake's replay fields
# --------------------------------------------------------------------------


@pytest.mark.parametrize("field", ["v0", "e1", "e2", "tri_model", "mat_table"])
def test_bake_replay_fields_bit_equal(worlds, field):
    world, jw = worlds
    ref = torch.from_numpy(np.array(getattr(jw, field)))
    got = getattr(world, field)
    assert got.dtype == ref.dtype and torch.equal(got, ref)


@pytest.fixture(scope="module")
def bake_grads(scenes):
    """Gradients of a fixed random linear functional of the replay fields
    w.r.t. the scene parameters, JAX and port."""
    scene, jscene = scenes
    names = ("vertex_pos", "model_to_world", "mat_color", "vertex_nrm")
    jw = jax_bake(jscene)
    g = np.random.default_rng(5)
    weights = {f: g.normal(size=np.asarray(getattr(jw, f)).shape).astype(np.float32)
               for f in ("v0", "e1", "e2", "shade_normal", "mat_table")}

    def jax_fn(p):
        w = jax_bake(jscene.replace(**p))
        return sum(jnp.sum(getattr(w, f) * weights[f]) for f in weights)

    jg = jax.jit(jax.grad(jax_fn))({k: getattr(jscene, k) for k in names})
    p = {k: getattr(scene, k).detach().clone().requires_grad_(True) for k in names}
    w = bake_world_triangles(scene.replace(**p))
    loss = sum((getattr(w, f) * torch.from_numpy(weights[f])).sum() for f in weights)
    tg = dict(zip(names, torch.autograd.grad(loss, list(p.values()))))
    return tg, {k: np.asarray(v) for k, v in jg.items()}


@pytest.mark.parametrize("param", ["vertex_pos", "model_to_world", "mat_color", "vertex_nrm"])
def test_bake_gradients_match_jax(bake_grads, param):
    tg, jg = bake_grads
    assert np.abs(jg[param]).max() > 0.0
    np.testing.assert_allclose(_np(tg[param]), jg[param], rtol=1e-5, atol=1e-7)


# --------------------------------------------------------------------------
# kernel 3's plain version and the deferred shading
# --------------------------------------------------------------------------


def _jax_primary(jw, res, key, ns, parity):
    """The JAX diff forward's padded rays, primary hits and bounce-0
    wavefront of samples 0 .. ns (``diff/fast.py:279-373``)."""
    jro, jrd = jax_generate_rays(CAM, res)
    n = jro.shape[0]
    pad = (-n) % JM.RAY_TILE
    ro_p = jnp.pad(jro, ((0, pad), (0, 0)))
    rd_p = jnp.pad(jax_normalize(jrd), ((0, pad), (0, 0)), constant_values=1.0)
    n_pad = ro_p.shape[0]
    hits0, idx0 = jax_trace_pallas(jw, ro_p, rd_p, return_idx=True)
    col0 = jnp.where(hits0.t < F_MAX, idx0 + 1, 0)
    u = jax.vmap(lambda s: JM.chunk_uniforms(key, s, BOUNCES, n, n_pad, 0))(jnp.arange(ns))
    u_flat = u.reshape(ns * n_pad, 4 * BOUNCES)

    def big(x):
        return jnp.broadcast_to(x[None], (ns,) + x.shape).reshape((ns * x.shape[0],) + x.shape[1:])

    state = jax_shade(JRayState.primary(big(ro_p), big(rd_p), BOUNCES),
                      jax.tree.map(big, hits0), u_flat[:, 0:4], parity=parity)
    pack = jnp.concatenate(
        [state.orig, state.dir, state.color, state.remaining.astype(jnp.float32)[:, None]], axis=1)
    return dict(ro_p=ro_p, rd_p=rd_p, n=n, n_pad=n_pad, col0=big(col0), u=u, u_flat=u_flat,
                pack=pack)


def _jax_streams(jw, res, key, ns, parity):
    """JAX ``make_idxs_multi`` (``diff/fast.py:355-391``): the (ns, n_pad,
    BOUNCES) streams, the live mask of each entry, and the inputs."""
    p = _jax_primary(jw, res, key, ns, parity)
    pack, u_flat = p["pack"], p["u_flat"]
    lo, hi = JM.scene_morton_bounds(jw.block_aabb)
    margin = jax_slab_margin(jw.block_aabb)
    pix = jnp.arange(pack.shape[0])
    cols, live = [p["col0"]], [np.ones(pack.shape[0], bool)]
    for b in range(1, BOUNCES):
        perm = jnp.argsort(JM._sort_keys(pack, lo, hi), stable=True)
        pack, pix = pack[perm], pix[perm]
        tg = JM._bounce_trace_call(jw, margin, pack, JM._binned_ray_tile(jw))
        inv = jnp.argsort(pix)
        cols.append(tg[:, 1][inv].astype(jnp.int32))
        live.append(np.asarray(pack[:, 9] > 0.0)[np.asarray(inv)])
        pack = JM._defer_shade_apply(jw, pack, tg, u_flat[:, 4 * b:4 * b + 4][pix], parity)
    shape = (ns, p["n_pad"], BOUNCES)
    p["idxs"] = np.stack([np.asarray(c) for c in cols], axis=1).reshape(shape)
    p["live"] = np.stack(live, axis=1).reshape(shape)
    return p


def _port_streams(world, res, key, ns, parity):
    ro, rd = generate_rays(CAM, res, device="cpu")
    n = ro.shape[0]
    pad = (-n) % 512
    ro_p = torch.cat([ro, ro.new_zeros(pad, 3)])
    rd_p = torch.cat([normalize(rd), rd.new_ones(pad, 3)])
    with torch.no_grad():
        hits0, idx0 = trace_pallas(world, ro_p, rd_p, return_idx=True)
        col0 = torch.where(hits0.t < F_MAX, idx0 + 1, 0)
        return TF.make_idxs_multi(world, ro_p, rd_p, hits0, col0, prng_key(key, "cpu"), 0, ns, n,
                                  BOUNCES, parity, 0)


@pytest.fixture(scope="module")
def wavefront1(worlds):
    """Bounce 1 of the JAX diff forward's 2-sample wavefront, sorted, with
    its last tile killed: the JAX (pack (N, 10), uniforms (N, 4)); the same
    rows go to both sides."""
    _, jw = worlds
    out = {}
    for parity in (True, False):
        p = _jax_primary(jw, RES, jax.random.PRNGKey(3), 2, parity)
        lo, hi = JM.scene_morton_bounds(jw.block_aabb)
        perm = jnp.argsort(JM._sort_keys(p["pack"], lo, hi), stable=True)
        pack = np.array(p["pack"][perm])
        pack[-256:, 9] = 0.0  # a dead tail of one whole tile, as later bounces have
        out[parity] = (pack, np.asarray(p["u_flat"][:, 4:8][perm]))
    return out


@pytest.mark.parametrize("parity", [True, False])
def test_bounce_trace_plain_matches_jax(worlds, wavefront1, parity):
    world, jw = worlds
    pack_np, _ = wavefront1[parity]
    pack = torch.from_numpy(pack_np.copy())
    ray_tile = TM.binned_ray_tile(world)
    lists, unit = TM.bounce_lists(world, _slab_margin(world.block_aabb), pack, ray_tile)
    TM.bounce_trace_plain.calls = 0
    t, col1 = TM.bounce_trace(pack, lists, unit, world, ray_tile)
    assert TM.bounce_trace_plain.calls == 1 and col1.dtype == torch.int32
    ref = np.asarray(JM._bounce_trace_call(jw, jax_slab_margin(jw.block_aabb), pack_np, ray_tile))
    live = pack_np[:, 9] > 0
    t, col1 = t.numpy(), col1.numpy()
    same = col1 == ref[:, 1].astype(np.int32)
    assert same[live].mean() >= 0.995
    # where the winner differs it is a tie: both t agree
    np.testing.assert_allclose(t[live], ref[live, 0], rtol=1e-5, atol=0)
    assert (col1[live] > 0).any()
    # a tile with no live ray gives a miss, as the kernel's does
    dead_tile = ~live.reshape(-1, ray_tile).any(axis=1).repeat(ray_tile)
    assert dead_tile.any()
    assert (col1[dead_tile] == 0).all() and (ref[dead_tile, 1] == 0).all()
    assert (t[dead_tile] == F_MAX).all()


@pytest.mark.parametrize("parity", [True, False])
def test_defer_shade_apply_matches_jax(worlds, wavefront1, parity):
    world, jw = worlds
    pack_np, u_np = wavefront1[parity]
    ray_tile = TM.binned_ray_tile(world)
    tg = np.asarray(JM._bounce_trace_call(jw, jax_slab_margin(jw.block_aabb), pack_np, ray_tile))
    ref = np.asarray(JM._defer_shade_apply(jw, pack_np, tg, u_np, parity))
    out = TM.defer_shade_apply(
        world, torch.from_numpy(pack_np.copy()),
        (torch.from_numpy(tg[:, 0].copy()), torch.from_numpy(tg[:, 1].astype(np.int32))),
        torch.from_numpy(u_np.copy()), parity,
    )
    # positions at scene scale (~1000 units): 1e-6 relative
    np.testing.assert_allclose(out[:, 0:3].numpy(), ref[:, 0:3], atol=1e-3, rtol=0)
    np.testing.assert_allclose(out[:, 3:9].numpy(), ref[:, 3:9], atol=1e-6, rtol=0)
    np.testing.assert_array_equal(out[:, 9].numpy(), ref[:, 9])


def test_bounce_trace_checks_its_inputs(worlds, wavefront1):
    world, _ = worlds
    pack = torch.from_numpy(wavefront1[True][0].copy())
    lists, unit = TM.bounce_lists(world, _slab_margin(world.block_aabb), pack, 256)
    with pytest.raises(ValueError, match="do not fill"):
        TM.bounce_trace(pack[:-256], lists, unit, world, 256)
    with pytest.raises(ValueError, match="sub-block"):
        TM.bounce_trace(pack, lists, world.tri_block, world, 256)
    with pytest.raises(ValueError, match="no kernel"):
        TM.bounce_trace(pack.to("meta"), lists.to("meta"), unit, world, 256)


# --------------------------------------------------------------------------
# the index-stream forward
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_streams(worlds):
    _, jw = worlds
    return {parity: _jax_streams(jw, RES, jax.random.PRNGKey(1), 2, parity)
            for parity in (True, False)}


def _assert_streams_agree(idxs, ref, t_of):
    """Equal on live rays but for ties: where the winner differs, the
    port's winner is hit at the same t as the reference's."""
    live = ref["live"]
    diff = (idxs != ref["idxs"]) & live
    assert diff.sum() <= max(2, 0.002 * live.sum()), np.argwhere(diff)
    for s, r, b in np.argwhere(diff):
        ta, tb = t_of(s, r, b, idxs[s, r, b]), t_of(s, r, b, ref["idxs"][s, r, b])
        assert ta < F_MAX and abs(ta - tb) <= 1e-5 * abs(tb), (s, r, b, ta, tb)


@pytest.mark.parametrize("bake", ["jax", "port"])
@pytest.mark.parametrize("parity", [True, False])
def test_index_stream_matches_jax(worlds, jax_streams, bake, parity):
    """The per-bounce streams of make_idxs_multi, on the JAX bake carried
    across by convert.world_from_numpy and on the port's own bake."""
    world, jw = worlds
    if bake == "jax":
        world = convert.world_from_numpy(_fields(jw), "cpu")
    ref = jax_streams[parity]
    idxs, u = _port_streams(world, RES, 1, 2, parity)
    np.testing.assert_array_equal(u.numpy(), np.asarray(ref["u"]))
    idxs = idxs.numpy()
    assert idxs.dtype == np.int32 and idxs.shape == ref["idxs"].shape
    assert (idxs[..., 0] == ref["idxs"][..., 0]).all()  # kernel 1's primary hits

    # the hit t of a winner: replay the reference's path to that bounce
    def t_of(s, r, b, col1):
        state = _jax_replay_path(jw, ref, s, r, b, parity)
        hit = JF.hit_from_index(jw, state.orig, jax_normalize(state.dir),
                                jnp.asarray([max(col1 - 1, 0)]), jnp.asarray([col1 > 0]))
        return float(hit.t[0])

    _assert_streams_agree(idxs, ref, t_of)


def _jax_replay_path(jw, ref, s, r, b, parity):
    """The replayed state of ray r of sample s before bounce b."""
    state = JRayState.primary(ref["ro_p"][r:r + 1], ref["rd_p"][r:r + 1], BOUNCES)
    u = ref["u"][s, r:r + 1]
    for k in range(b):
        ib = jnp.asarray(ref["idxs"][s, r:r + 1, k])
        rec = JF.hit_from_index(jw, state.orig, jax_normalize(state.dir),
                                jnp.maximum(ib - 1, 0), ib > 0)
        state = jax_shade(state, rec, u[:, 4 * k:4 * k + 4], parity=parity)
    return state


# --------------------------------------------------------------------------
# the replays, on the JAX streams
# --------------------------------------------------------------------------


def _jax_replay(jw, ro_p, rd_p, idxs, u, parity):
    """The JAX ``replay`` closure (``diff/fast.py:329-339``)."""
    state = JRayState.primary(ro_p, rd_p, BOUNCES)
    for b in range(BOUNCES):
        ib = idxs[:, b].astype(jnp.int32)
        rec = JF.hit_from_index(jw, state.orig, jax_normalize(state.dir),
                                jnp.maximum(ib - 1, 0), ib > 0)
        state = jax_shade(state, rec, u[:, 4 * b:4 * b + 4], parity=parity)
    return jax_gather_contribution(state)


def _replay_case(worlds, jax_streams, parity, color_only):
    world, jw = worlds
    ref = jax_streams[parity]
    idxs, u = ref["idxs"][1], np.asarray(ref["u"][1])
    weight = np.random.default_rng(2).normal(size=(idxs.shape[0], 3)).astype(np.float32)
    fields = REPLAY_FIELDS

    def jax_fn(geo):
        w = jw.replace(**geo)
        if color_only:
            c = JF.replay_color_only(w, jnp.asarray(idxs), BOUNCES)
        else:
            c = _jax_replay(w, ref["ro_p"], ref["rd_p"], jnp.asarray(idxs), jnp.asarray(u), parity)
        return jnp.sum(c * weight), c

    (_, jc), jg = jax.value_and_grad(jax_fn, has_aux=True)({f: getattr(jw, f) for f in fields})
    geo = {f: getattr(world, f).detach().clone().requires_grad_(True) for f in fields}
    w = dataclasses.replace(world, **geo)
    ti, tu = torch.from_numpy(idxs.copy()), torch.from_numpy(u.copy())
    if color_only:
        c = TF.replay_color_only(w, ti, BOUNCES)
    else:
        ro_p = torch.from_numpy(np.array(ref["ro_p"]))
        rd_p = torch.from_numpy(np.array(ref["rd_p"]))
        c = torch.utils.checkpoint.checkpoint(
            TF.replay, w, ro_p, rd_p, ti, tu, BOUNCES, parity, use_reentrant=False)
    g = torch.autograd.grad((c * torch.from_numpy(weight)).sum(), list(geo.values()),
                            allow_unused=True)
    np.testing.assert_allclose(c.detach().numpy(), np.asarray(jc), atol=1e-6, rtol=1e-5)
    checked = 0
    for f, gf in zip(fields, g):
        ref_g = np.asarray(jg[f])
        got = np.zeros_like(ref_g) if gf is None else gf.numpy()
        scale = max(1e-30, float(np.abs(ref_g).max()))
        np.testing.assert_allclose(got, ref_g, rtol=1e-5, atol=1e-6 * scale, err_msg=f)
        checked += scale > 1e-30
    return checked


def test_replay_color_only_matches_jax(worlds, jax_streams):
    assert _replay_case(worlds, jax_streams, True, color_only=True) >= 1


@pytest.mark.parametrize("parity", [True, False])
def test_checkpointed_replay_matches_jax(worlds, jax_streams, parity):
    # parity color reads only mat_table; quality mode reaches the geometry
    assert _replay_case(worlds, jax_streams, parity, color_only=False) >= (1 if parity else 2)


def test_color_only_replay_equals_full_replay(worlds, jax_streams):
    world, _ = worlds
    ref = jax_streams[True]
    idxs = torch.from_numpy(ref["idxs"][0].copy())
    full = TF.replay(world, torch.from_numpy(np.array(ref["ro_p"])),
                     torch.from_numpy(np.array(ref["rd_p"])), idxs,
                     torch.from_numpy(np.array(ref["u"][0])), BOUNCES, True)
    assert torch.equal(TF.replay_color_only(world, idxs, BOUNCES), full)


# --------------------------------------------------------------------------
# the facade: image, loss, gradients, train step
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mat_color_case(scenes):
    """JAX image, image_loss and its mat_color gradient (parity) at 32x16."""
    _, jscene = scenes
    key = jax.random.PRNGKey(1)
    target = _target(RES[0] * RES[1])
    params = JG.extract_params(jscene, ("mat_color",))
    img = jax.jit(lambda p: JG.render_for_params(p, jscene, key, CAM, RES, SPP, BOUNCES,
                                                 engine="fused"))(params)
    loss, g = jax.jit(jax.value_and_grad(lambda p: JG.image_loss(
        p, jscene, target, key, CAM, RES, SPP, BOUNCES, engine="fused")))(params)
    return dict(img=np.asarray(img), loss=float(loss), grad=np.asarray(g["mat_color"]),
                target=target, params=params)


def test_render_for_params_image_matches_jax(scenes, mat_color_case):
    scene, _ = scenes
    p = convert.params_from_numpy({"mat_color": np.asarray(mat_color_case["params"]["mat_color"])}, "cpu")
    img = TG.render_for_params(p, scene, prng_key(1, "cpu"), CAM, RES, SPP, BOUNCES, engine="fused")
    assert img.shape == (RES[0] * RES[1], 3) and img.requires_grad
    np.testing.assert_allclose(_np(img), mat_color_case["img"], atol=1e-5, rtol=0)


def test_image_loss_and_mat_color_gradient_match_jax(scenes, mat_color_case):
    scene, _ = scenes
    p = TG.extract_params(scene, ("mat_color",))
    p = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
    loss = TG.image_loss(p, scene, torch.from_numpy(mat_color_case["target"]), prng_key(1, "cpu"), CAM,
                         RES, SPP, BOUNCES, engine="fused")
    np.testing.assert_allclose(loss.item(), mat_color_case["loss"], rtol=1e-5)
    (g,) = torch.autograd.grad(loss, [p["mat_color"]])
    assert np.abs(mat_color_case["grad"]).max() > 0.0
    np.testing.assert_allclose(g.numpy(), mat_color_case["grad"], **GRAD_TOL)


def test_train_step_matches_jax(scenes, mat_color_case):
    scene, jscene = scenes
    lr = 0.05
    jstep = JG.make_train_step(jscene, CAM, RES, SPP, BOUNCES, lr=lr, tile_size=8192,
                               engine="fused")
    jl, jp = jstep(mat_color_case["params"], jnp.asarray(mat_color_case["target"]),
                   jax.random.PRNGKey(1))
    step = TG.make_train_step(scene, CAM, RES, SPP, BOUNCES, lr=lr, tile_size=8192,
                              engine="fused")
    params = convert.params_from_numpy({"mat_color": np.asarray(mat_color_case["params"]["mat_color"])}, "cpu")
    loss, new = step(params, torch.from_numpy(mat_color_case["target"]), prng_key(1, "cpu"))
    assert not loss.requires_grad and not new["mat_color"].requires_grad
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(new["mat_color"].numpy(), np.asarray(jp["mat_color"]), **GRAD_TOL)
    assert not torch.equal(new["mat_color"], params["mat_color"].detach())


def test_vertex_pos_gradient_matches_jax_in_quality_mode(scenes, worlds):
    """Quality mode (the parity color carries no vertex gradient,
    tests/test_grad.py:76), at 16x8 where the port's and the JAX index
    streams agree on every live ray (checked first: a tie broken the other
    way moves a ray's gradient to the neighbouring triangle)."""
    scene, jscene = scenes
    _, jw = worlds
    key = 4
    ref = _jax_streams(jw, SMALL, jax.random.PRNGKey(key), SPP, False)
    idxs, _ = _port_streams(worlds[0], SMALL, key, SPP, False)
    assert ((idxs.numpy() == ref["idxs"]) | ~ref["live"]).all()

    target = _target(SMALL[0] * SMALL[1])
    params = JG.extract_params(jscene, ("vertex_pos",))
    jl, jg = jax.jit(jax.value_and_grad(lambda p: JG.image_loss(
        p, jscene, target, jax.random.PRNGKey(key), CAM, SMALL, SPP, BOUNCES, engine="fused",
        parity=False)))(params)
    p = convert.params_from_numpy({"vertex_pos": np.asarray(params["vertex_pos"])}, "cpu")
    loss = TG.image_loss(p, scene, torch.from_numpy(target), prng_key(key, "cpu"), CAM, SMALL, SPP,
                         BOUNCES, engine="fused", parity=False)
    (g,) = torch.autograd.grad(loss, [p["vertex_pos"]])
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    jg = np.asarray(jg["vertex_pos"])
    # the JAX forward replays its padding rays too, and a padding ray whose
    # color is exactly 0 gives NaN through sqrt's backward; the port replays
    # the real rays only (ROADMAP queue C)
    finite = np.isfinite(jg).all(axis=1)
    assert torch.isfinite(g).all() and (jg[finite] != 0).sum() > 10
    np.testing.assert_allclose(g.numpy()[finite], jg[finite], **GRAD_TOL)


def test_sample_batching_changes_nothing(scenes, monkeypatch):
    """tests/test_grad.py:215 on the port: groups of 1 and of 2 samples
    (3 samples: one group of 2, then 1) give the same image bit for bit
    and the same mat_color gradient."""
    scene, _ = scenes

    def run():
        p = {"mat_color": scene.mat_color.detach().clone().requires_grad_(True)}
        img = TG.render_for_params(p, scene, prng_key(5, "cpu"), CAM, SMALL, 3, 3, engine="fused")
        (g,) = torch.autograd.grad((img ** 2).sum(), [p["mat_color"]])
        return img.detach(), g

    monkeypatch.setattr(TM, "BINNED_SAMPLE_BATCH", 1)
    img1, g1 = run()
    monkeypatch.setattr(TM, "BINNED_SAMPLE_BATCH", 2)
    assert TM.sample_groups(3) == [2, 1]
    img2, g2 = run()
    assert torch.equal(img1, img2)
    np.testing.assert_allclose(g2.numpy(), g1.numpy(), rtol=1e-6, atol=1e-8)


def test_geometry_loss_vertex_gradients_match_jax():
    """tests/test_grad.py:94 on the port: the Cornell box's depth + normal
    AOV loss against the AOVs of a shrunken box.  The vertex gradient sums
    hit-distance derivatives that cancel at the box's coordinates, so
    entries that are zero up to rounding carry noise of about 1e-6 of the
    largest entry in both frameworks: the absolute tolerance scales with it."""
    cam = CameraConfig(position=(0.0, 0.0, 150.0), plane_x=(-40.0, 40.0),
                       plane_y=(-30.0, 30.0), plane_z=100.0)
    jscene = build_cornell_box_scene().to_device()
    scene = convert.scene_from_numpy(_fields(jscene), "cpu")
    params = JG.extract_params(jscene, ("vertex_pos",))
    shrunk = {"vertex_pos": params["vertex_pos"] * 0.97}
    td, tn, th = jax.jit(lambda p: JG.render_aovs(p, jscene, cam, SMALL))(shrunk)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: JG.geometry_loss(p, jscene, td, tn, cam, SMALL)))(params)
    depth, normal, hit = TG.render_aovs(
        {"vertex_pos": torch.from_numpy(np.array(shrunk["vertex_pos"]))}, scene, cam, SMALL)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(th))
    np.testing.assert_allclose(depth.numpy(), np.asarray(td), rtol=1e-6)
    np.testing.assert_allclose(normal.numpy(), np.asarray(tn), atol=1e-6)
    p = convert.params_from_numpy({"vertex_pos": np.asarray(params["vertex_pos"])}, "cpu")
    loss = TG.geometry_loss(p, scene, torch.from_numpy(np.array(td)),
                            torch.from_numpy(np.array(tn)), cam, SMALL)
    (g,) = torch.autograd.grad(loss, [p["vertex_pos"]])
    jg = np.asarray(jg["vertex_pos"])
    assert float(jl) > 0.0 and np.abs(jg).max() > 0.0
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), jg, rtol=1e-4, atol=1e-5 * np.abs(jg).max())


# --------------------------------------------------------------------------
# the other engines
# --------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["pallas", "mxu"])
def test_other_diff_engines_name_their_item(scenes, engine):
    """The per-bounce diff engines (A8b) are ported: a loss, and a step with
    make_train_step's default engine, on the reference scene; the parity
    engine (A10, with its backward) renders too, and an engine
    the package lacks raises."""
    scene, _ = scenes
    p = TG.extract_params(scene)
    img = TG.render_for_params(p, scene, prng_key(0, "cpu"), CAM, SMALL, 1, 2, engine=engine)
    assert img.shape == (SMALL[0] * SMALL[1], 3) and torch.isfinite(img).all() and img.max() > 0
    loss, new = TG.make_train_step(scene, CAM, SMALL, 1, 2)(
        p, torch.zeros(SMALL[0] * SMALL[1], 3), prng_key(0, "cpu"))
    assert torch.isfinite(loss) and not torch.equal(new["mat_color"], p["mat_color"])
    img = TG.render_for_params(p, scene, prng_key(0, "cpu"), CAM, SMALL, 1, 2, engine="parity")
    assert img.shape == (SMALL[0] * SMALL[1], 3) and torch.isfinite(img).all() and img.max() > 0
    with pytest.raises(ValueError, match="unknown engine"):
        TG.render_for_params(p, scene, prng_key(0, "cpu"), CAM, SMALL, 1, 2, engine="dense")


def test_single_block_world_names_its_item(worlds):
    """A one-block world has no binned forward: its index streams come from
    kernel 4's emit_idx pass (plain version here), one call per sample,
    with no deferred-trace bounce."""
    world, _ = worlds
    one_block = dataclasses.replace(world, block_aabb=world.block_aabb[:1])
    assert not TF.binned_forward_active(one_block)
    ro, rd = generate_rays(CAM, SMALL, device="cpu")
    TM.sample_fused_plain.calls = TM.bounce_trace_plain.calls = 0
    out = TF.render_samples_fused_diff(one_block, ro, rd, prng_key(0, "cpu"), 2, 2)
    assert TM.sample_fused_plain.calls == 2 and TM.bounce_trace_plain.calls == 0
    assert out.shape == (SMALL[0] * SMALL[1], 3) and torch.isfinite(out).all() and out.max() > 0
