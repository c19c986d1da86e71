"""The port's whole-sample fused engine (plain kernel 4) against the JAX
package's, run in interpret mode on the CPU: the Cornell box builder and
its bake, the camera jitter uniforms, ``_sample_pallas_call`` in every
mode, ``render_samples_fused`` and the jittered ``Renderer``, the gated
sweep of scenes above 8 blocks, and the ``emit_idx`` diff forward of
single-block scenes.

XLA's CPU ``rsqrt`` (the JAX kernels' in-kernel normalization) is within
one ulp of torch's correctly rounded one, so directions differ in the last
bits: images are compared at atol 1e-5 (ROADMAP queue C), index streams on
live rays except at exact-t ties.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracerap_tpu.config import CameraConfig as JCameraConfig
from pathtracerap_tpu.config import RenderConfig as JRenderConfig
from pathtracerap_tpu.diff import grad as JG
from pathtracerap_tpu.ops.plucker import bake_world_triangles as jax_bake
from pathtracerap_tpu.ops.rng import camera_jitter_uniforms as jax_jitter_uniforms
from pathtracerap_tpu.pallas import megakernel as JM
from pathtracerap_tpu.pallas.trace import _slab_margin as jax_slab_margin
from pathtracerap_tpu.render.camera import generate_rays as jax_generate_rays
from pathtracerap_tpu.render.wavefront import Renderer as JRenderer
from pathtracerap_tpu.scene import build as JB
from pathtracerap_tpu_torch import CameraConfig, RenderConfig, Renderer, build_cornell_box_scene
from pathtracerap_tpu_torch import convert
from pathtracerap_tpu_torch.diff import fast as TF
from pathtracerap_tpu_torch.diff import grad as TG
from pathtracerap_tpu_torch.kernels import megakernel as TM
from pathtracerap_tpu_torch.kernels.trace import ray_vectors, trace_pallas
from pathtracerap_tpu_torch.ops import rng
from pathtracerap_tpu_torch.ops.math import normalize
from pathtracerap_tpu_torch.ops.plucker import bake_world_triangles
from pathtracerap_tpu_torch.render.camera import generate_rays
from pathtracerap_tpu_torch.scene import build as TB
from pathtracerap_tpu_torch.scene import build_reference_scene

F_MAX = 9999999.0
ATOL = 1e-5  # images: tests/test_megakernel.py:40
GRAD_TOL = dict(rtol=1e-4, atol=1e-7)  # tests/test_grad.py:205-212
CORNELL_CAM = dict(position=(0.0, 0.0, 150.0), plane_x=(-40.0, 40.0), plane_y=(-30.0, 30.0),
                   plane_z=100.0)  # tests/test_megakernel.py:21


def _key(seed):
    return rng.prng_key(seed, "cpu")


@pytest.fixture(scope="module")
def cornell():
    """(port host, JAX host, port world, JAX world) of the Cornell box."""
    host, jhost = build_cornell_box_scene(), JB.build_cornell_box_scene()
    return (host, jhost, bake_world_triangles(host.to_device("cpu")),
            jax.jit(jax_bake)(jhost.to_device()))


@pytest.fixture(scope="module")
def reference():
    """(port world, JAX world) of the reference scene."""
    return (bake_world_triangles(build_reference_scene().to_device("cpu")),
            jax.jit(jax_bake)(JB.build_reference_scene().to_device()))


# --------------------------------------------------------------------------
# the Cornell box and its bake
# --------------------------------------------------------------------------


def test_cornell_scene_host_arrays_equal(cornell):
    host, jhost, _, _ = cornell
    for f in dataclasses.fields(host):
        np.testing.assert_array_equal(getattr(host, f.name), getattr(jhost, f.name), err_msg=f.name)
    assert host.num_triangles == 36 and host.num_models == 4


@pytest.mark.parametrize("field", ["order", "fused_ops", "attr_rows", "block_aabb", "sub_aabb"])
def test_cornell_bake_equal(cornell, field):
    _, _, world, jw = cornell
    assert world.block_aabb.shape[0] == 1 and world.tri_block == 512
    if field == "order":
        np.testing.assert_array_equal(world.valid.numpy(), np.asarray(jw.valid))
        np.testing.assert_array_equal(world.tri_model.numpy(), np.asarray(jw.tri_model))
        return
    a, b = getattr(world, field).numpy(), np.asarray(getattr(jw, field))
    np.testing.assert_array_equal(a, b)


def test_sphere_mesh_matches_jax():
    a, b = TB.make_sphere_mesh(3.0, 5), JB.make_sphere_mesh(3.0, 5)
    for f in dataclasses.fields(a):
        np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name), err_msg=f.name)
    c, d = TB.make_box_mesh((1.0, 2.0, 3.0), inward=True), JB.make_box_mesh((1.0, 2.0, 3.0), True)
    for f in dataclasses.fields(c):
        np.testing.assert_array_equal(getattr(c, f.name), getattr(d, f.name), err_msg=f.name)


# --------------------------------------------------------------------------
# the camera jitter
# --------------------------------------------------------------------------


@pytest.mark.parametrize("sample, tile_base, n", [(0, 0, 512), (3, 2, 8192), (7, 5, 20000)])
def test_camera_jitter_uniforms_bit_equal(sample, tile_base, n):
    """Single tiles, every tile of a chunk in one pass, and the chunk's
    padded rows (JAX ``render_samples_fused``, ``megakernel.py:1627-1631``)."""
    key, jkey = _key(9), jax.random.PRNGKey(9)
    for tile in (tile_base, tile_base + 1):
        ref = jax_jitter_uniforms(jkey, sample, tile, min(n, 8192))
        out = rng.camera_jitter_uniforms(key, sample, tile, min(n, 8192))
        np.testing.assert_array_equal(out.numpy().view(np.int32), np.asarray(ref).view(np.int32))
    n_pad = -(-n // 512) * 512
    tile_n, nt = JM._rng_tiling(n, n_pad)
    ref = jax.vmap(lambda k: jax_jitter_uniforms(jkey, sample, k, tile_n))(
        tile_base + jnp.arange(nt)).reshape(-1, 2)
    ref = np.asarray(JM._pad_rows(ref, n_pad))
    out = rng.chunk_jitter_uniforms(key, sample, n, n_pad, tile_base)
    assert out.shape == (n_pad, 2)
    np.testing.assert_array_equal(out.numpy().view(np.int32), ref.view(np.int32))


def test_generate_rays_with_key_matches_jax():
    ro_j, rd_j = jax_generate_rays(JCameraConfig(jitter=True), (19, 7), jax.random.PRNGKey(4))
    ro, rd = generate_rays(CameraConfig(jitter=True), (19, 7), _key(4))
    np.testing.assert_array_equal(ro.numpy(), np.asarray(ro_j))
    np.testing.assert_array_equal(rd.numpy(), np.asarray(rd_j))
    plain, _ = generate_rays(CameraConfig(jitter=True), (19, 7), device="cpu")
    assert torch.equal(plain, ro)


# --------------------------------------------------------------------------
# kernel 4's plain version against _sample_pallas_call
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def wavefront(reference):
    """A reference-scene wavefront at 32x16 padded to 512 rays: ray vectors,
    primary rows (with index + 1) and 4-bounce uniforms of 3 samples."""
    world, _ = reference
    ro, rd = generate_rays(CameraConfig(), (32, 16), device="cpu")
    rd_n = normalize(rd)
    hits, idx = trace_pallas(world, ro, rd_n, return_idx=True)
    prim = TM.primary_pack(hits, torch.where(hits.t < F_MAX, idx + 1, 0))
    u = rng.chunk_uniforms(_key(2), range(3), 4, 512, 512).reshape(3, 512, 16)
    return ray_vectors(ro, rd_n), prim, u


def _jax_call(jw, w16, prim, u, parity, use_primary, emit_idx=False):
    args = (jw, w16.numpy(), prim.numpy())
    margin = jax_slab_margin(jw.block_aabb)
    if u.dim() == 3:
        return JM._sample_pallas_call_batched(*args, u.numpy(), margin, 4, parity)
    return JM._sample_pallas_call(*args, u.numpy(), margin, 4, parity, use_primary,
                                  emit_idx=emit_idx)


@pytest.mark.parametrize("use_primary", [True, False])
@pytest.mark.parametrize("parity", [True, False])
def test_sample_fused_plain_matches_jax(reference, wavefront, use_primary, parity):
    world, jw = reference
    w16, prim, u = wavefront
    TM.sample_fused_plain.calls = 0
    out = TM.sample_fused(w16, prim, u[0], world, 4, parity, use_primary)
    assert TM.sample_fused_plain.calls == 1 and out.shape == (512, 3)
    ref = np.asarray(_jax_call(jw, w16, prim, u[0], parity, use_primary))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)
    assert out.min() >= 0.0 and out.max() > 0.0


def _assert_streams_agree(idx, ref, world):
    """Equal except where the two winners tie: where they differ both are
    coplanar triangles (the two halves of one quad), hit at the same t on
    their shared edge.  The Cornell box's walls are single quads, so its
    diagonals take about one live hit in 400 at 32x16."""
    diff = idx != ref
    assert diff.sum() <= max(2, 0.005 * (ref > 0).sum()), np.argwhere(diff)
    n = world.attr_rows[7:10].T
    offset = world.plane_d / world.plane_n.norm(dim=1).clamp_min(1e-30)
    for r, b in np.argwhere(diff):
        a, c = int(idx[r, b]) - 1, int(ref[r, b]) - 1
        assert a >= 0 and c >= 0, (r, b, a, c)
        np.testing.assert_allclose(n[a].numpy(), n[c].numpy(), atol=1e-6)
        np.testing.assert_allclose(offset[a].item(), offset[c].item(), rtol=1e-6)


def test_sample_fused_plain_emit_idx_matches_jax(reference, wavefront):
    world, jw = reference
    w16, prim, u = wavefront
    out, idx = TM.sample_fused(w16, prim, u[0], world, 4, True, True, emit_idx=True)
    ref, ref_idx = _jax_call(jw, w16, prim, u[0], True, True, emit_idx=True)
    assert idx.dtype == torch.int32 and idx.shape == (512, 4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    ref_idx = np.asarray(ref_idx)[:, :4].astype(np.int32)
    assert (idx[:, 0].numpy() == ref_idx[:, 0]).all()  # the primary rows' own indices
    _assert_streams_agree(idx.numpy(), ref_idx, world)
    assert (idx[:, 1:] > 0).any() and (idx[:, 3] == 0).any()  # hits, and dead or missed rays
    assert torch.equal(out, TM.sample_fused(w16, prim, u[0], world, 4, True, True))


def test_sample_fused_plain_batched_matches_jax(reference, wavefront):
    """Three samples in one launch against ``_sample_pallas_call_batched``,
    and against the per-sample calls summed in sample order."""
    world, jw = reference
    w16, prim, u = wavefront
    out = TM.sample_fused(w16, prim, u, world, 4, True, True)
    ref = np.asarray(_jax_call(jw, w16, prim, u, True, True))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)
    singles = [TM.sample_fused(w16, prim, u[s], world, 4, True, True) for s in range(3)]
    assert torch.equal(out, singles[0] + singles[1] + singles[2])


def test_sample_fused_checks_its_inputs(reference, wavefront):
    world, _ = reference
    w16, prim, u = wavefront
    with pytest.raises(ValueError, match="multiple of the 512-ray tile"):
        TM.sample_fused(w16[:256], prim[:256], u[0, :256], world, 4, True, True)
    with pytest.raises(ValueError, match="one sample"):
        TM.sample_fused(w16, prim, u, world, 4, True, True, emit_idx=True)
    with pytest.raises(ValueError, match="no kernel"):
        TM.sample_fused(w16.to("meta"), prim.to("meta"), u[0].to("meta"), world, 4, True, True)


# --------------------------------------------------------------------------
# render_samples_fused and the Renderer (tests/test_megakernel.py:37-88)
# --------------------------------------------------------------------------


def _renders(cornell_pair, jitter=False, **over):
    (host, jhost), cfg = cornell_pair, dict(resolution=(16, 8), samples_per_pixel=4, max_bounces=3)
    cfg.update(over)
    cam, jcam = CameraConfig(jitter=jitter, **CORNELL_CAM), JCameraConfig(jitter=jitter, **CORNELL_CAM)
    r = Renderer(host.to_device("cpu"), RenderConfig(engine="fused", camera=cam, **cfg), device="cpu")
    jr = JRenderer(jhost.to_device(), JRenderConfig(engine="fused", camera=jcam, **cfg))
    assert r.engine == "fused"
    return r.render().numpy(), np.asarray(jr.render())


@pytest.mark.parametrize(
    "over",
    [
        {},  # test_megakernel.py:37
        dict(resolution=(19, 7), samples_per_pixel=2, max_bounces=5),  # :49, padding
        dict(jitter=True, parity=False),  # :58
        dict(resolution=(32, 32), samples_per_pixel=9, max_bounces=4),  # a batch of 8, then 1
    ],
    ids=["base", "padding", "jitter_quality", "batch_and_remainder"],
)
def test_fused_render_matches_jax(cornell, over):
    TM.sample_fused.launches = TM.sample_fused_plain.calls = 0
    img, ref = _renders(cornell[:2], **over)
    assert img.shape == ref.shape and np.isfinite(img).all() and img.mean() > 0.0
    np.testing.assert_allclose(img, ref, atol=ATOL, rtol=0)
    spp = over.get("samples_per_pixel", 4)
    # one launch per batch of 8 samples, or one per jittered sample
    assert TM.sample_fused_plain.calls == (spp if over.get("jitter") else -(-spp // 8))


def test_slabbed_fused_calls_compose_exactly(cornell):
    """tests/test_megakernel.py:88: two RNG tiles of rays through one call
    and through two with the global tile numbering."""
    _, _, world, _ = cornell
    ro, rd = generate_rays(CameraConfig(**CORNELL_CAM), (128, 128), device="cpu")
    assert ro.shape[0] == 2 * rng.RNG_TILE
    key = _key(11)
    full = TM.render_samples_fused(world, ro, rd, key, 2, 3)
    parts = [TM.render_samples_fused(world, ro[s:s + 8192], rd[s:s + 8192], key, 2, 3,
                                     tile_base=s // 8192) for s in (0, 8192)]
    np.testing.assert_allclose(full.numpy(), torch.cat(parts).numpy(), atol=1e-6, rtol=0)


def test_jittered_quality_renderer_matches_jax(reference):
    """The quality render of the reference scene: ``fused`` stays fused
    under jitter on a 6-block scene (wavefront.py:65-66 sends ``binned``
    there too)."""
    res, spp, bounces = (32, 16), 2, 4
    cam = dict(camera=CameraConfig(jitter=True))
    for engine in ("fused", "binned"):
        r = Renderer(build_reference_scene().to_device("cpu"),
                     RenderConfig(resolution=res, samples_per_pixel=spp, max_bounces=bounces,
                                  engine=engine, parity=False, **cam), device="cpu")
        assert r.engine == "fused"
    img = r.render(seed=3).numpy()
    jr = JRenderer(JB.build_reference_scene().to_device(),
                   JRenderConfig(resolution=res, samples_per_pixel=spp, max_bounces=bounces,
                                 engine="fused", parity=False, camera=JCameraConfig(jitter=True)))
    ref = np.asarray(jr.render(seed=3))
    np.testing.assert_allclose(img, ref, atol=ATOL, rtol=0)
    assert abs(float(img.mean()) - 0.42858) < 1e-4


# --------------------------------------------------------------------------
# the gated sweep (scenes above GATE_BLOCKS blocks)
# --------------------------------------------------------------------------


def _sphere_scenes():
    """Nine spheres in a room: 8,652 triangles, 17 blocks of 512."""
    scenes = []
    for mod in (TB, JB):
        b = mod.SceneBuilder()
        m = b.add_mesh(mod.make_sphere_mesh(30.0, 16))
        room = b.add_mesh(mod.make_box_mesh((600.0, 600.0, 600.0)))
        M = mod.MaterialType
        b.add_instance(room, mod.Material(M.DIFFUSE, (0.8, 0.8, 0.8)))
        for k in range(9):
            mat = mod.Material(M.EMISSIVE if k == 4 else (M.METAL, M.DIFFUSE)[k % 2],
                               (0.9, 0.3 + 0.05 * k, 0.2))
            b.add_instance(m, mat, translate=(-160.0 + 80.0 * (k % 5), -60.0 + 100.0 * (k // 5),
                                              -100.0 - 20.0 * k))
        scenes.append(b.build())
    return scenes


def test_gated_sweep_matches_jax():
    """Above 8 blocks the JAX kernel gates each block on its AABB; the
    port's plain version sweeps every block.  The two agree: the gate
    never changes a hit."""
    host, jhost = _sphere_scenes()
    scene = host.to_device("cpu")
    world = bake_world_triangles(scene)
    nb = world.block_aabb.shape[0]
    assert nb > TM.GATE_BLOCKS
    cam = dict(position=(0.0, 0.0, 280.0), plane_x=(-60.0, 60.0), plane_y=(-40.0, 40.0),
               plane_z=200.0)
    cfg = dict(resolution=(16, 16), samples_per_pixel=2, max_bounces=3, parity=False,
               engine="fused")
    r = Renderer(scene, RenderConfig(camera=CameraConfig(jitter=True, **cam), **cfg), device="cpu")
    jr = JRenderer(jhost.to_device(), JRenderConfig(camera=JCameraConfig(jitter=True, **cam), **cfg))
    img, ref = r.render(seed=1).numpy(), np.asarray(jr.render(seed=1))
    assert img.mean() > 0.0
    np.testing.assert_allclose(img, ref, atol=ATOL, rtol=0)


# --------------------------------------------------------------------------
# the emit_idx diff forward on the Cornell box (tests/test_grad.py:186)
# --------------------------------------------------------------------------

RES, SPP, BOUNCES = (32, 16), 2, 4
CAM = CameraConfig(**CORNELL_CAM)
JCAM = JCameraConfig(**CORNELL_CAM)


def _target(n: int) -> np.ndarray:
    return np.random.default_rng(11).uniform(0.0, 0.5, size=(n, 3)).astype(np.float32)


def test_single_block_diff_forward_streams_match_jax(cornell):
    """The frozen hit topology of the emit_idx forward: kernel 4's stream
    against JAX's ``_sample_pallas_call(emit_idx=True)`` with the
    primary indices in the primary rows (``diff/fast.py:294-313``)."""
    _, _, world, jw = cornell
    assert not TF.binned_forward_active(world)
    ro, rd = generate_rays(CAM, RES, device="cpu")
    rd_n = normalize(rd)
    hits, idx0 = trace_pallas(world, ro, rd_n, return_idx=True)
    prim = TM.primary_pack(hits, torch.where(hits.t < F_MAX, idx0 + 1, 0))
    w16 = ray_vectors(ro, rd_n)
    for s in range(SPP):
        u = rng.chunk_uniforms(_key(1), s, BOUNCES, 512, 512)
        _, idx = TM.sample_fused(w16, prim, u, world, BOUNCES, True, True, emit_idx=True)
        _, ref = JM._sample_pallas_call(jw, w16.numpy(), prim.numpy(), u.numpy(),
                                        jax_slab_margin(jw.block_aabb), BOUNCES, True, True,
                                        emit_idx=True)
        _assert_streams_agree(idx.numpy(), np.asarray(ref)[:, :BOUNCES].astype(np.int32), world)


@pytest.fixture(scope="module")
def mat_color_case(cornell):
    """JAX image_loss and its mat_color gradient on the Cornell box."""
    jscene = cornell[1].to_device()
    key = jax.random.PRNGKey(1)
    target = _target(RES[0] * RES[1])
    params = JG.extract_params(jscene, ("mat_color",))
    loss, g = jax.jit(jax.value_and_grad(lambda p: JG.image_loss(
        p, jscene, target, key, JCAM, RES, SPP, BOUNCES, engine="fused")))(params)
    return dict(loss=float(loss), grad=np.asarray(g["mat_color"]), target=target,
                params=np.asarray(params["mat_color"]))


def test_single_block_mat_color_loss_and_gradient_match_jax(cornell, mat_color_case):
    scene = cornell[0].to_device("cpu")
    p = convert.params_from_numpy({"mat_color": mat_color_case["params"]}, "cpu")
    TM.sample_fused_plain.calls = 0
    loss = TG.image_loss(p, scene, torch.from_numpy(mat_color_case["target"]), _key(1), CAM, RES,
                         SPP, BOUNCES, engine="fused")
    assert TM.sample_fused_plain.calls == SPP  # one emit_idx launch per sample
    (g,) = torch.autograd.grad(loss, [p["mat_color"]])
    np.testing.assert_allclose(loss.item(), mat_color_case["loss"], rtol=1e-5)
    assert (mat_color_case["grad"] != 0).sum() >= 6
    np.testing.assert_allclose(g.numpy(), mat_color_case["grad"], **GRAD_TOL)


def test_single_block_train_step_matches_jax(cornell, mat_color_case):
    """tests/test_grad.py:125 on the Cornell box: one SGD step."""
    scene = cornell[0].to_device("cpu")
    jscene = cornell[1].to_device()
    lr = 0.05
    jstep = JG.make_train_step(jscene, JCAM, RES, SPP, BOUNCES, lr=lr, engine="fused")
    jl, jp = jstep({"mat_color": jnp.asarray(mat_color_case["params"])},
                   jnp.asarray(mat_color_case["target"]), jax.random.PRNGKey(1))
    step = TG.make_train_step(scene, CAM, RES, SPP, BOUNCES, lr=lr, engine="fused")
    params = convert.params_from_numpy({"mat_color": mat_color_case["params"]}, "cpu")
    loss, new = step(params, torch.from_numpy(mat_color_case["target"]), _key(1))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(new["mat_color"].numpy(), np.asarray(jp["mat_color"]), **GRAD_TOL)
    assert not torch.equal(new["mat_color"], params["mat_color"].detach())


def test_single_block_quality_vertex_gradient_matches_jax(cornell):
    """tests/test_grad.py:253 on the port: the vertex_pos gradient in
    quality mode, through the checkpointed full replay.  The JAX forward
    replays its 384 padding rays too; their color is exactly 0 here, and
    sqrt's backward turns that into NaN in the room's vertex gradients.
    The port replays the real rays only: it agrees with JAX wherever JAX
    is finite, and is finite everywhere."""
    host, jhost, _, _ = cornell
    scene, jscene = host.to_device("cpu"), jhost.to_device()
    res = (16, 8)
    target = _target(res[0] * res[1])
    params = JG.extract_params(jscene, ("vertex_pos",))
    jl, jg = jax.jit(jax.value_and_grad(lambda p: JG.image_loss(
        p, jscene, target, jax.random.PRNGKey(4), JCAM, res, SPP, BOUNCES, engine="fused",
        parity=False)))(params)
    p = convert.params_from_numpy({"vertex_pos": np.asarray(params["vertex_pos"])}, "cpu")
    loss = TG.image_loss(p, scene, torch.from_numpy(target), _key(4), CAM, res, SPP, BOUNCES,
                         engine="fused", parity=False)
    (g,) = torch.autograd.grad(loss, [p["vertex_pos"]])
    jg = np.asarray(jg["vertex_pos"])
    finite = np.isfinite(jg).all(axis=1)
    assert torch.isfinite(g).all() and finite.sum() >= 12 and (jg[finite] != 0).sum() > 10
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(g.numpy()[finite], jg[finite], rtol=1e-4,
                               atol=1e-5 * np.abs(jg[finite]).max())
