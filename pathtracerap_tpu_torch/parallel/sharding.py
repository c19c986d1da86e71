"""Data-parallel rendering over ``torch.distributed`` ranks (port of
``pathtracerap_tpu/parallel/sharding.py``).

JAX renders one program over a device mesh with ``shard_map``; PyTorch's
idiom is one process per card.  So the port splits each collective render
in two:

* a pure function of ``(rank, world_size)`` that computes one rank's part
  on the scene's device (:func:`render_rank_slab`,
  :func:`render_rank_samples`), which a test can call for every rank in one
  process;
* the collective that merges the parts over the :class:`Mesh`'s process
  group (:func:`render_accumulate_dp`, :func:`render_image_dp`,
  :func:`render_accumulate_sample_parallel`).

Two modes, as in JAX:

* **ray data parallelism**: the image's rays are split evenly over the
  ranks, the geometry replicated; each rank renders its own rows with
  globally numbered RNG tiles, so the image equals one process's render bit
  for bit, and the only communication is the gather of the slabs;
* **sample parallelism**: every rank renders every pixel for a disjoint
  run of sample indices, merged by one ``all_reduce(SUM)``.

Under ``gloo`` (the CPU, or ranks that share one card) a collective's
payload moves to the host and back explicitly; rendering stays on the
rank's device.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..config import RenderConfig
from ..ops.plucker import bake_world_triangles
from ..ops.rng import RNG_TILE, prng_key
from ..render.camera import generate_rays, jitter_step
from ..render.wavefront import _make_tracer, _render_tile, effective_engine, render_accumulate
from ..scene.types import SceneDevice


def rank_device() -> torch.device:
    """This process's card: ``cuda:{LOCAL_RANK % device_count}``."""
    local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))
    return torch.device("cuda", local % max(torch.cuda.device_count(), 1))


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a data-parallel group (JAX's 1-D ``rays`` mesh):
    ``rank`` of ``world_size`` processes in ``group`` (None: the default
    group), the ``device`` this rank renders on and the group's
    ``backend`` (``""`` without a group)."""

    rank: int
    world_size: int
    device: torch.device
    group: object = None
    backend: str = ""

    @property
    def host_transport(self) -> bool:
        """``gloo`` moves collective payloads through the host."""
        return self.backend == "gloo"


def default_mesh(device=None, group=None) -> Mesh:
    """The mesh of the initialized default process group (or ``group``);
    world size 1 without one.  ``device`` defaults to :func:`rank_device`,
    the card; pass ``"cpu"`` to render on the CPU."""
    device = rank_device() if device is None else torch.device(device)
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(0, 1, device)
    return Mesh(dist.get_rank(group), dist.get_world_size(group), device, group,
                dist.get_backend(group))


def _payload(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return t.cpu() if mesh.host_transport else t.contiguous()


def all_reduce_sum(t: torch.Tensor, mesh: Mesh, async_op: bool = False):
    """``all_reduce(SUM)`` of ``t`` over the mesh.  Returns the sum on
    ``t``'s device, or with ``async_op`` a callable that waits for it."""
    if mesh.world_size == 1:
        return (lambda: t) if async_op else t
    buf = _payload(t, mesh)
    work = dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group, async_op=async_op)

    def wait():
        if work is not None:
            work.wait()
        return buf.to(t.device)

    return wait if async_op else wait()


def all_gather_rows(part: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``part`` (the same shape on every rank) concatenated in
    rank order, on every rank: one ``all_gather``."""
    if mesh.world_size == 1:
        return part
    buf = _payload(part, mesh)
    parts = [torch.empty_like(buf) for _ in range(mesh.world_size)]
    dist.all_gather(parts, buf, group=mesh.group)
    return torch.cat(parts).to(part.device)


def rank_share(n: int, world_size: int, align: int) -> int:
    """Rays a rank holds: an even split of ``n``, padded to whole
    ``align``-ray RNG tiles (``sharding.py:100-101``)."""
    per = -(-n // world_size)
    return -(-per // align) * align


def slab_align(engine: str, tile_size: int) -> int:
    """RNG tile of a resolved engine: 8192 rays for the megakernel engines,
    ``tile_size`` for the per-bounce ones."""
    return RNG_TILE if engine in ("fused", "binned") else tile_size


def rank_rows(n: int, per_rank: int, rank: int) -> int:
    """Real (not padding) rays of ``rank``'s share."""
    return max(0, min(per_rank, n - rank * per_rank))


def pad_share(ro: torch.Tensor, rd: torch.Tensor, lo: int, per_rank: int):
    """Rows ``lo .. lo + per_rank`` of the rays, padded past the image with
    origin 0 and direction 1.0, as JAX pads them."""
    ro_s, rd_s = ro[lo:lo + per_rank], rd[lo:lo + per_rank]
    pad = per_rank - ro_s.shape[0]
    if pad:
        ro_s = torch.cat([ro_s, ro.new_zeros(pad, 3)])
        rd_s = torch.cat([rd_s, rd.new_ones(pad, 3)])
    return ro_s, rd_s


def render_rank_slab(
    scene: SceneDevice,
    key: torch.Tensor,
    camera,
    resolution,
    n_samples: int,
    max_bounces: int,
    rank: int,
    world_size: int,
    engine: str = "mxu",
    parity: bool = True,
    sample_offset: int = 0,
    world=None,
    tile_size: int = 2048,
) -> torch.Tensor:
    """Rank ``rank``'s part of the ray-sharded accumulation: the
    contribution sums of its padded share of the rays, (per_rank, 3), on
    the scene's device.

    The engine is resolved once for the whole image (``effective_engine``,
    the same on every rank).  Each rank's share is padded to whole RNG
    tiles (8192 rays for ``binned`` and ``fused``, ``tile_size`` for the
    per-bounce engines) and its tiles are numbered from ``rank *
    tiles_per_rank``, so every ray keeps its global (tile, row) and its
    uniforms: the share is :func:`..render.wavefront.render_accumulate` of
    those rays.  Rows past the image are padding; a rank whose share is
    padding only renders nothing and returns zeros."""
    step = jitter_step(camera, resolution)
    if engine != "parity" and world is None:
        world = bake_world_triangles(scene)
    engine = effective_engine(engine, world, step is not None)
    align = slab_align(engine, tile_size)
    ro, rd = generate_rays(camera, resolution, device=scene.device)
    n = ro.shape[0]
    per = rank_share(n, world_size, align)
    if rank_rows(n, per, rank) == 0:
        return ro.new_zeros(per, 3)
    ro_l, rd_l = pad_share(ro, rd, rank * per, per)
    return render_accumulate(scene, key, camera, resolution, n_samples, max_bounces,
                             engine=engine, parity=parity, sample_offset=sample_offset,
                             world=world, tile_size=tile_size, ro=ro_l, rd=rd_l,
                             tile_base=rank * (per // align))


def render_accumulate_dp(
    scene: SceneDevice,
    key: torch.Tensor,
    camera,
    resolution,
    n_samples: int,
    max_bounces: int,
    mesh: Mesh,
    engine: str = "mxu",
    parity: bool = True,
    sample_offset: int = 0,
    world=None,
    tile_size: int = 2048,
) -> torch.Tensor:
    """Ray-sharded accumulation: this rank's slab
    (:func:`render_rank_slab`), gathered over the mesh and trimmed to the
    image; returns the (N, 3) contribution sums on every rank."""
    part = render_rank_slab(scene, key, camera, resolution, n_samples, max_bounces, mesh.rank,
                            mesh.world_size, engine=engine, parity=parity,
                            sample_offset=sample_offset, world=world, tile_size=tile_size)
    return all_gather_rows(part, mesh)[:resolution[0] * resolution[1]]


def render_image_dp(
    scene: SceneDevice,
    config: RenderConfig,
    mesh: Optional[Mesh] = None,
    world=None,
    tile_size: int = 2048,
    seed: Optional[int] = None,
) -> torch.Tensor:
    """Full data-parallel render; returns the (H, W, 3) float image on
    every rank, on the scene's device."""
    if mesh is None:
        mesh = default_mesh(scene.device)
    if world is None and config.engine != "parity":
        world = bake_world_triangles(scene)
    key = prng_key(config.seed if seed is None else seed, scene.device)
    acc = render_accumulate_dp(
        scene, key, config.camera, config.resolution, config.samples_per_pixel,
        config.max_bounces, mesh, engine=config.engine, parity=config.parity, world=world,
        tile_size=tile_size,
    )
    w, h = config.resolution
    return acc.reshape(h, w, 3) / config.samples_per_pixel


def render_rank_samples(
    scene: SceneDevice,
    key: torch.Tensor,
    camera,
    resolution,
    n_samples: int,
    max_bounces: int,
    rank: int,
    world_size: int,
    engine: str = "mxu",
    parity: bool = True,
    world=None,
    tile_size: int = 2048,
) -> torch.Tensor:
    """Rank ``rank``'s part of the sample-parallel accumulation: every
    pixel's sums over samples ``rank * per .. (rank + 1) * per``, (N, 3)."""
    if n_samples % world_size:
        raise ValueError(f"n_samples={n_samples} not divisible by {world_size} ranks")
    per = n_samples // world_size
    ro, rd = generate_rays(camera, resolution, device=scene.device)
    tracer = _make_tracer(scene, engine, world=world)
    return _render_tile(tracer, ro, rd, 0, key, per, max_bounces, parity, tile_size=tile_size,
                        sample_offset=rank * per)


def render_accumulate_sample_parallel(
    scene: SceneDevice,
    key: torch.Tensor,
    camera,
    resolution,
    n_samples: int,
    max_bounces: int,
    mesh: Mesh,
    engine: str = "mxu",
    parity: bool = True,
    world=None,
    tile_size: int = 2048,
) -> torch.Tensor:
    """Sample-sharded accumulation: :func:`render_rank_samples` on every
    rank, merged by one ``all_reduce(SUM)``; the (N, 3) sums on every rank."""
    part = render_rank_samples(scene, key, camera, resolution, n_samples, max_bounces, mesh.rank,
                               mesh.world_size, engine=engine, parity=parity, world=world,
                               tile_size=tile_size)
    return all_reduce_sum(part, mesh)
