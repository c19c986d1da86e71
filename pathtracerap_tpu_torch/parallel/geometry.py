"""Triangle-sharded rendering over ``torch.distributed`` ranks: the geometry
ring (port of ``pathtracerap_tpu/parallel/geometry.py``).

For scenes too large to copy onto every card, each rank keeps 1/D of the
world's heavy traversal pack, the ray wavefront stays where it is, and the
triangle shards rotate around the ring of ranks.  After D steps every ray
has met every shard; the nearest hit is reduced on the lexicographic key
(t, global triangle index), so the result does not depend on which shard a
triangle lives in nor on the order the shards arrive: it is the
single-process trace's, bit for bit.

As in :mod:`.sharding`, each collective is split in two:

* pure functions: :func:`ring_shard` cuts rank ``r``'s shard of ``D`` out
  of a world baked with ``ring_shards=D`` (with its global triangle
  offset), and :func:`trace_shards` traces rays against a list of shards
  and merges them.  :func:`ring_world` without a mesh gives a rank every
  shard, in the order the ring would bring them, so a test runs the ring
  for any D in one process;
* the transport, :class:`ShardRing`: at each step a rank sends the shard
  it holds to rank + 1 and receives one from rank - 1
  (``batch_isend_irecv``, so no rank blocks in a send), D - 1 transfers a
  trace call (a rank keeps its own shard).  Under ``gloo`` (the CPU, or
  ranks that share one card) the payload moves through the host.

Two tracers, as in JAX: the ``fused`` ring (the default) runs kernel 1
(:func:`..kernels.trace.nearest_hit_fused`) on each shard's worklists,
built against the shard's block boxes, and the ``dense`` ring kernel 5
(:func:`..kernels.trace.nearest_hit`) on each shard's dense packs, gated
by the shard's own group boxes.  A shard of padding only makes no launch
and gives misses; the ring still passes it on.  Every rank makes the same
trace calls, whatever its rays do: a ring step is a collective.

After the bake a rank keeps its own shard of the heavy pack and drops the
rest (:func:`ring_world_specs`); the per-triangle tables that shading and
the differentiable replay read stay whole on every rank.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterable, Iterator, Optional

import torch
import torch.distributed as dist

from .. import constants
from ..config import RenderConfig
from ..diff.fast import hit_from_index
from ..kernels.trace import (
    RAY_TILE, _slab_margin, _tile_block_lists, dense_inputs, nearest_hit, nearest_hit_fused,
    ray_vectors,
)
from ..ops.math import normalize
from ..ops.plucker import SUB_BLOCK, bake_world_triangles, cluster_group_aabb, hit_record
from ..ops.rng import prng_key
from ..render.camera import generate_rays, jitter_step
from ..render.wavefront import _render_tile
from ..scene.types import SceneDevice, WorldTriangles
from .sharding import Mesh, _payload, all_gather_rows, all_reduce_sum, default_mesh, pad_share, rank_share

F_MAX = constants.FLOAT_MAX
NO_INDEX = 2**31 - 1  # the merge's index where no shard hit
ENGINES = ("fused", "dense")
# The heavy traversal pack: what a rank cuts to its shard or drops.
HEAVY_FIELDS = ("fused_ops", "ops_tri", "block_aabb", "attr_rows", "sub_aabb", "edge_mat",
                "edge_pluecker", "plane_mat", "cluster_aabb", "group_aabb")


def ring_world_specs(world: WorldTriangles, engine: str = "fused") -> dict:
    """What each rank keeps of a ring-baked world (JAX's PartitionSpecs):
    ``"sharded"`` maps each field a rank cuts to its shard to the axis the
    shards split (``fused``: ``ops_tri`` and ``block_aabb`` rows, and on the
    CPU, where kernel 1's plain version reads it, ``fused_ops`` columns;
    ``dense``: ``edge_mat``, ``plane_mat`` and ``cluster_aabb`` columns);
    ``"replicated"`` lists the per-triangle tables every rank keeps whole;
    ``"dropped"`` the rest of the heavy pack, which no rank keeps."""
    if engine == "fused":
        sharded = {"ops_tri": 0, "block_aabb": 0}
        if world.device.type == "cpu":
            sharded["fused_ops"] = 1
    elif engine == "dense":
        sharded = {"edge_mat": 2, "plane_mat": 1, "cluster_aabb": 1}
    else:
        raise ValueError(f"unknown ring engine: {engine!r}")
    replicated = [f.name for f in dataclasses.fields(world)
                  if isinstance(getattr(world, f.name), torch.Tensor) and f.name not in HEAVY_FIELDS]
    dropped = [name for name in HEAVY_FIELDS if name not in sharded]
    return {"sharded": sharded, "replicated": replicated, "dropped": dropped}


def ring_bake(scene: SceneDevice, world_size: int, engine: str = "fused") -> WorldTriangles:
    """The bake the ring shards: ``ring_shards=world_size`` with the fused
    pack (``fused``) or without it (``dense``, padded to ``world_size *
    128``)."""
    if engine not in ENGINES:
        raise ValueError(f"unknown ring engine: {engine!r}")
    return bake_world_triangles(scene, fused_tile=512 if engine == "fused" else None,
                                ring_shards=world_size)


@dataclasses.dataclass
class RingShard:
    """One rank's shard of a ring-baked world: triangles ``offset ..
    offset + tris`` (``n_valid`` of them real, the rest padding) of the
    fields :func:`ring_world_specs` shards, in ``tensors``."""

    engine: str
    index: int
    offset: int
    tris: int
    n_valid: int
    world_valid: int  # the whole world's real triangles
    tri_block: int
    tensors: Dict[str, torch.Tensor]

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.tensors.values())

    def flat(self) -> torch.Tensor:
        """The shard's tensors in one f32 buffer: the ring's payload."""
        return torch.cat([t.reshape(-1) for t in self.tensors.values()])

    def received(self, flat: torch.Tensor, index: int) -> "RingShard":
        """Shard ``index`` of the same world from its payload ``flat``
        (views of it, in this shard's shapes)."""
        parts = torch.split(flat, [t.numel() for t in self.tensors.values()])
        tensors = {k: p.view(t.shape) for (k, t), p in zip(self.tensors.items(), parts)}
        offset = index * self.tris
        return dataclasses.replace(self, index=index, offset=offset, tensors=tensors,
                                   n_valid=max(0, min(self.world_valid - offset, self.tris)))


def ring_shard(world: WorldTriangles, rank: int, world_size: int,
               engine: str = "fused") -> RingShard:
    """Rank ``rank``'s shard of ``world`` (baked by :func:`ring_bake` for
    ``world_size`` ranks): its contiguous 1/world_size of the triangles in
    each sharded field, detached, in storage of its own (the world can be
    dropped), with its global offset and count of real triangles."""
    unit = world.tri_block if engine == "fused" else SUB_BLOCK
    t = world.num_triangles
    if engine == "fused" and world.fused_ops is None:
        raise ValueError("the fused ring needs a world baked with its fused pack")
    if not 0 <= rank < world_size or t % (unit * world_size):
        raise ValueError(f"{t} triangles do not split into {world_size} shards of whole "
                         f"{unit}-triangle blocks: bake with ring_shards={world_size}")
    if engine == "fused" and world.block_aabb.shape[0] != t // unit:
        raise ValueError("block_aabb lacks its padding blocks: bake with ring_shards")
    tensors = {}
    for name, axis in ring_world_specs(world, engine)["sharded"].items():
        x = getattr(world, name).detach()
        n = x.shape[axis] // world_size
        tensors[name] = x.narrow(axis, rank * n, n).clone(memory_format=torch.contiguous_format)
    tris = t // world_size
    offset = rank * tris
    return RingShard(engine, rank, offset, tris, max(0, min(world.n_valid - offset, tris)),
                     world.n_valid, world.tri_block, tensors)


def ring_tables(world: WorldTriangles) -> WorldTriangles:
    """The world with its heavy pack dropped: the per-triangle tables that
    every rank keeps (hit attributes, the replay's ``v0``, ``e1``, ``e2``,
    ``tri_model``, ``mat_table``)."""
    return dataclasses.replace(world, **{name: None for name in HEAVY_FIELDS})


class ShardRing:
    """The transport: a rank's shard rotating over the ranks of ``mesh``.
    :meth:`shards` yields, for one trace call, the rank's own shard and
    then the D - 1 it receives, each after one step of the ring (send the
    held shard to rank + 1, receive from rank - 1).  Counts the transfers,
    the bytes sent and the seconds spent in them."""

    def __init__(self, own: RingShard, mesh: Mesh):
        self.own, self.mesh = own, mesh
        self.transfers = 0
        self.bytes_sent = 0
        self.seconds = 0.0
        self._own_payload = None

    def _peer(self, rank: int) -> int:
        group = self.mesh.group
        return rank if group is None else dist.get_global_rank(group, rank)

    def rotate(self, payload: torch.Tensor) -> torch.Tensor:
        """One ring step: send ``payload`` on, return what rank - 1 sent."""
        d, r = self.mesh.world_size, self.mesh.rank
        recv = torch.empty_like(payload)
        t0 = time.perf_counter()
        ops = [dist.P2POp(dist.isend, payload, self._peer((r + 1) % d), self.mesh.group),
               dist.P2POp(dist.irecv, recv, self._peer((r - 1) % d), self.mesh.group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        self.seconds += time.perf_counter() - t0
        self.transfers += 1
        self.bytes_sent += payload.numel() * payload.element_size()
        return recv

    def shards(self) -> Iterator[RingShard]:
        yield self.own
        d = self.mesh.world_size
        if d == 1:
            return
        if self._own_payload is None:
            self._own_payload = _payload(self.own.flat(), self.mesh)
        payload = self._own_payload
        dev = next(iter(self.own.tensors.values())).device
        for s in range(1, d):
            payload = self.rotate(payload)
            yield self.own.received(payload.to(dev), (self.mesh.rank - s) % d)


@dataclasses.dataclass
class RingWorld:
    """One rank's view of a ring-baked world: the tables it keeps whole,
    and ``shards()``, the shards one trace call visits (the ring's, or in
    one process a list of them); ``ring`` is the transport, if any."""

    tables: WorldTriangles
    shards: Callable[[], Iterable[RingShard]]
    engine: str
    ring: Optional[ShardRing] = None

    def replace_tables(self, **fields) -> "RingWorld":
        return dataclasses.replace(self, tables=dataclasses.replace(self.tables, **fields))

    def detached(self) -> "RingWorld":
        return dataclasses.replace(self, tables=self.tables.detached())


def ring_world(world: WorldTriangles, rank: int, world_size: int, engine: str = "fused",
               mesh: Optional[Mesh] = None) -> RingWorld:
    """Rank ``rank``'s :class:`RingWorld` of a world baked by
    :func:`ring_bake`.  With ``mesh`` the rank keeps its own shard and the
    others come over :class:`ShardRing`; without one every shard is cut
    here, visited own first and then as the ring would bring them (the
    pure form, for one process)."""
    tables = ring_tables(world)
    if mesh is None:
        shards = [ring_shard(world, (rank - s) % world_size, world_size, engine)
                  for s in range(world_size)]
        return RingWorld(tables, lambda: iter(shards), engine)
    if (mesh.rank, mesh.world_size) != (rank, world_size):
        raise ValueError(f"rank {rank} of {world_size} on a mesh of rank {mesh.rank} of "
                         f"{mesh.world_size}")
    ring = ShardRing(ring_shard(world, rank, world_size, engine), mesh)
    return RingWorld(tables, ring.shards, engine, ring)


def _shard_world(tables: WorldTriangles, shard: RingShard) -> WorldTriangles:
    """What kernel 1's wrapper reads of a shard: a world of its triangles."""
    x = shard.tensors
    return dataclasses.replace(tables, ops_tri=x["ops_tri"], fused_ops=x.get("fused_ops"),
                               block_aabb=x["block_aabb"], n_valid=shard.n_valid,
                               tri_block=shard.tri_block)


def _shard_hits(tables: WorldTriangles, shard: RingShard, rays: dict):
    """(t, idx) of the padded rays against one shard, idx local (-1: miss)."""
    m = rays["m"]
    if shard.n_valid == 0:  # padding only: no triangle to accept
        return (torch.full((m,), F_MAX, device=rays["dev"]),
                torch.full((m,), -1, dtype=torch.int32, device=rays["dev"]))
    x = shard.tensors
    if shard.engine == "fused":
        box = x["block_aabb"]
        lists = _tile_block_lists(box, rays["ro"], rays["rd"], rays["alive"], RAY_TILE,
                                  _slab_margin(box))
        return nearest_hit_fused(rays["w16"], _shard_world(tables, shard), lists, RAY_TILE)
    group = cluster_group_aabb(x["cluster_aabb"], shard.n_valid)
    return nearest_hit(rays["w"], rays["wo"], x["edge_mat"], x["plane_mat"], x["cluster_aabb"],
                       n_valid=shard.n_valid, group_aabb=group)


def _ray_inputs(engine: str, ro, rd, alive) -> dict:
    """The rays padded to whole ``RAY_TILE`` tiles (padding lanes dead) in
    the form the engine's kernel takes, shared by every shard."""
    n, dev = ro.shape[0], ro.device
    if engine == "dense":
        w, wo = dense_inputs(ro, rd, alive)
        return {"w": w, "wo": wo, "m": w.shape[0], "dev": dev}
    rd_n = normalize(rd)
    alive_f = (torch.ones((n, 1), device=dev) if alive is None
               else alive.to(torch.float32)[:, None])
    pad = (-n) % RAY_TILE
    if pad:
        ro = torch.cat([ro, ro.new_zeros(pad, 3)])
        rd_n = torch.cat([rd_n, rd_n.new_ones(pad, 3)])
        alive_f = torch.cat([alive_f, alive_f.new_zeros(pad, 1)])
    return {"ro": ro, "rd": rd_n, "alive": alive_f, "w16": ray_vectors(ro, rd_n, alive_f),
            "m": ro.shape[0], "dev": dev}


def trace_shards(tables: WorldTriangles, shards: Iterable[RingShard], ro, rd, alive=None,
                 return_idx: bool = False):
    """Nearest hit of each ray over ``shards`` (one engine), merged on the
    lexicographic key (t, global index): a shard's hit replaces the best
    one on a smaller t, or on an equal finite t with a lower index.  Every
    shard is traced, whatever the rays do.  The result contract of
    :func:`..kernels.trace.trace_pallas`: a :class:`HitRecord` from
    ``tables`` (and with ``return_idx`` the (N,) int32 global index, 0 on a
    miss)."""
    n = ro.shape[0]
    rays = None
    best_t = best_idx = None
    for shard in shards:
        if rays is None:
            rays = _ray_inputs(shard.engine, ro, rd, alive)
            best_t = torch.full((rays["m"],), F_MAX, device=ro.device)
            best_idx = torch.full((rays["m"],), NO_INDEX, dtype=torch.int64, device=ro.device)
        t, idx = _shard_hits(tables, shard, rays)
        g_idx = torch.where(idx >= 0, idx.long() + shard.offset, NO_INDEX)
        improve = (t < best_t) | ((t == best_t) & (t < F_MAX) & (g_idx < best_idx))
        best_t = torch.where(improve, t, best_t)
        best_idx = torch.where(improve, g_idx, best_idx)
    if rays is None:
        raise ValueError("no shard to trace")
    t = best_t[:n]
    idx = torch.where(t < F_MAX, best_idx[:n], 0)
    rec = hit_record(tables, t, idx)
    return (rec, idx.to(torch.int32)) if return_idx else rec


def _make_tracer(engine: str):
    def tracer(world_l: RingWorld, ro, rd, alive=None, return_idx: bool = False):
        if world_l.engine != engine:
            raise ValueError(f"a {engine} ring tracer got a {world_l.engine} ring world")
        return trace_shards(world_l.tables, world_l.shards(), ro, rd, alive, return_idx)

    return tracer


def make_geometry_sharded_tracer_fused():
    """The ``fused`` ring tracer: ``tracer(world_l, ro, rd, alive=None,
    return_idx=False) -> HitRecord`` over a ``fused`` :class:`RingWorld`,
    kernel 1 on each shard's worklists."""
    return _make_tracer("fused")


def make_geometry_sharded_tracer():
    """The ``dense`` ring tracer: ``tracer(world_l, ro, rd, alive=None)``
    over a ``dense`` :class:`RingWorld`, kernel 5 on each shard's packs."""
    return _make_tracer("dense")


def make_ring_diff_tracer():
    """The differentiable ring tracer: the ``fused`` ring picks each ray's
    triangle on detached inputs, and :func:`..diff.fast.hit_from_index`
    recomputes the hit there from the rank's whole tables, so gradients
    reach ``mat_table`` (and, when the tables come from a bake inside the
    loss, the geometry)."""
    ring = make_geometry_sharded_tracer_fused()

    def tracer(world_l: RingWorld, ro, rd, alive=None):
        rd_n = normalize(rd)
        with torch.no_grad():
            rec, idx = ring(world_l.detached(), ro.detach(), rd_n.detach(), alive=alive,
                            return_idx=True)
        return hit_from_index(world_l.tables, ro, rd_n, idx.long(), rec.t < F_MAX)

    return tracer


def _rank_rays(camera, resolution, rank: int, world_size: int, tile_size: int, device):
    """Rank ``rank``'s padded share of the camera's rays, as the
    data-parallel render splits them: (n, per, lo, ro, rd, tile_base)."""
    ro, rd = generate_rays(camera, resolution, device=device)
    n = ro.shape[0]
    per = rank_share(n, world_size, tile_size)
    lo = rank * per
    ro_l, rd_l = pad_share(ro, rd, lo, per)
    return n, per, lo, ro_l, rd_l, rank * (per // tile_size)


def render_rank_ring(
    scene: SceneDevice,
    key: torch.Tensor,
    camera,
    resolution,
    n_samples: int,
    max_bounces: int,
    rank: int,
    world_size: int,
    world_l: RingWorld,
    parity: bool = True,
    tile_size: int = 2048,
) -> torch.Tensor:
    """Rank ``rank``'s part of the ring render: the (per, 3) contribution
    sums of its padded share of the rays (globally numbered RNG tiles, as
    :func:`.sharding.render_rank_slab`), every trace a ring over
    ``world_l``.  A rank whose share is padding only renders it all the
    same: every rank makes the same trace calls."""
    _, _, _, ro_l, rd_l, tile_base = _rank_rays(camera, resolution, rank, world_size, tile_size,
                                                scene.device)
    return _render_tile(lambda o, d, alive=None: trace_shards(world_l.tables, world_l.shards(), o,
                                                               d, alive),
                        ro_l, rd_l, tile_base, key, n_samples, max_bounces, parity,
                        jitter_step=jitter_step(camera, resolution), tile_size=tile_size)


def ring_stats(world: WorldTriangles, world_l: RingWorld) -> dict:
    """Bytes of the heavy pack: the rank's own shard against the whole
    bake's sharded fields and its whole heavy pack; and the bytes of the
    tables every rank keeps."""
    def nbytes(w, names):
        return sum(x.numel() * x.element_size() for name in names
                   for x in [getattr(w, name)] if isinstance(x, torch.Tensor))

    own = world_l.ring.own if world_l.ring is not None else next(iter(world_l.shards()))
    tables = [f.name for f in dataclasses.fields(world_l.tables)
              if isinstance(getattr(world_l.tables, f.name), torch.Tensor)]
    return {"engine": world_l.engine, "shard_bytes": own.nbytes,
            "world_sharded_bytes": nbytes(world, own.tensors),
            "world_heavy_bytes": nbytes(world, HEAVY_FIELDS),
            "tables_bytes": nbytes(world_l.tables, tables),
            "shard_triangles": own.tris, "world_triangles": world.num_triangles}


def _card_bytes(device) -> tuple:
    """(requested, allocated) bytes of the process's tensors on the card."""
    m = torch.cuda.memory_stats(device)
    return m["requested_bytes.all.current"], m["allocated_bytes.all.current"]


def render_image_geometry_sharded(
    scene: SceneDevice,
    config: RenderConfig,
    mesh: Optional[Mesh] = None,
    tile_size: int = 2048,
    engine: str = "fused",
    seed: Optional[int] = None,
    stats: Optional[dict] = None,
) -> torch.Tensor:
    """Full render with the triangles sharded over the mesh's ranks and
    the rays split as the data-parallel render splits them; returns the
    (H, W, 3) image on every rank, equal to one process's per-bounce
    ``pallas`` render at the same ``tile_size`` (``engine="fused"``; the
    ``dense`` ring to the same render on a world without a pack).  Each
    rank bakes the world, keeps its shard and the tables and drops the
    rest.  ``stats`` (a dict) receives the bytes each rank holds and the
    ring's transfers, their bytes and seconds (:func:`ring_stats`); on the
    card also the growth of the process's card memory from before the bake
    to after the world is dropped: ``held_bytes``, what its tensors asked
    for, and ``held_allocated_bytes``, what the caching allocator gave
    them (rounded up, a large block by up to 1 MiB)."""
    if mesh is None:
        mesh = default_mesh(scene.device)
    measure = stats is not None and scene.device.type == "cuda"
    if measure:
        before = _card_bytes(scene.device)
    world = ring_bake(scene, mesh.world_size, engine)
    world_l = ring_world(world, mesh.rank, mesh.world_size, engine, mesh=mesh)
    if stats is not None:
        stats.update(ring_stats(world, world_l))
    del world
    if measure:
        after = _card_bytes(scene.device)
        stats.update(held_bytes=after[0] - before[0], held_allocated_bytes=after[1] - before[1])
    key = prng_key(config.seed if seed is None else seed, scene.device)
    part = render_rank_ring(scene, key, config.camera, config.resolution,
                            config.samples_per_pixel, config.max_bounces, mesh.rank,
                            mesh.world_size, world_l, parity=config.parity, tile_size=tile_size)
    if stats is not None:
        ring = world_l.ring
        stats.update(transfers=ring.transfers, bytes_sent=ring.bytes_sent, transfer_s=ring.seconds)
    w, h = config.resolution
    return all_gather_rows(part, mesh)[:w * h].reshape(h, w, 3) / config.samples_per_pixel


def rank_ring_loss(
    params: Dict,
    scene: SceneDevice,
    target_flat: torch.Tensor,
    key: torch.Tensor,
    camera,
    resolution,
    n_samples: int,
    max_bounces: int,
    rank: int,
    world_size: int,
    frozen: Optional[RingWorld] = None,
    mesh: Optional[Mesh] = None,
    tile_size: int = 2048,
    parity: bool = True,
) -> torch.Tensor:
    """Rank ``rank``'s share of the ring train step's loss: the sum of
    squared errors of its padded share of the rays against ``target_flat``
    (N, 3), padding rays weighted 0, rendered through the differentiable
    ring tracer.  ``frozen``: a ring world baked once (the ``mat_color``
    regime; ``params["mat_color"]`` becomes its ``mat_table``); None: the
    world is baked from ``params`` here, inside the loss, and the rank keeps
    its shard (over ``mesh``, or every shard when None) and the tables."""
    if frozen is None:
        world = ring_bake(scene.replace(**params), world_size)
        world_l = ring_world(world, rank, world_size, mesh=mesh)
        del world
    else:
        world_l = frozen.replace_tables(mat_table=params["mat_color"])
    n, per, lo, ro_l, rd_l, tile_base = _rank_rays(camera, resolution, rank, world_size,
                                                   tile_size, scene.device)
    target_l = target_flat[lo:lo + per]
    if target_l.shape[0] < per:
        target_l = torch.cat([target_l, target_l.new_zeros(per - target_l.shape[0], 3)])
    w_l = (torch.arange(lo, lo + per, device=scene.device) < n).to(torch.float32)[:, None]
    trace = make_ring_diff_tracer()
    acc = _render_tile(lambda o, d, alive=None: trace(world_l, o, d, alive=alive), ro_l, rd_l,
                       tile_base, key, n_samples, max_bounces, parity, tile_size=tile_size)
    return (w_l * (acc / n_samples - target_l) ** 2).sum()


def rank_ring_loss_and_grad(params: Dict, *args, **kwargs):
    """(loss, grads) of :func:`rank_ring_loss`, both detached; a parameter
    the loss does not reach gets a zero gradient."""
    from ..diff.grad import value_and_grad  # diff.grad imports .sharding, hence this package

    return value_and_grad(lambda p: rank_ring_loss(p, *args, **kwargs), params)


def make_geometry_sharded_train_step(
    scene: SceneDevice,
    camera,
    resolution,
    n_samples: int,
    max_bounces: int,
    mesh: Optional[Mesh] = None,
    lr: float = 0.05,
    tile_size: int = 2048,
    parity: bool = True,
    param_names=("mat_color",),
):
    """Differentiable train step over the geometry ring; returns
    ``step(params, target_flat, key) -> (loss, new_params)``.

    Two regimes by ``param_names``, as in JAX: ``("mat_color",)`` bakes the
    world once, frozen, and re-injects the material table each step; any
    geometry parameter (``vertex_pos``, ``model_to_world``) re-bakes the
    world from the parameters inside the loss every step
    (:func:`rank_ring_loss`).  Each rank's summed loss and gradients go
    out as one ``all_reduce(SUM)``, so every rank applies the same SGD
    update.  Use ``parity=False`` for pixel-loss vertex gradients."""
    if mesh is None:
        mesh = default_mesh(scene.device)
    rebake = any(name != "mat_color" for name in param_names)
    frozen = None
    if not rebake:
        world = ring_bake(scene, mesh.world_size)
        frozen = ring_world(world, mesh.rank, mesh.world_size, mesh=mesh).detached()
        del world

    def step(params, target_flat, key):
        loss, grads = rank_ring_loss_and_grad(
            params, scene, target_flat, key, camera, resolution, n_samples, max_bounces,
            mesh.rank, mesh.world_size, frozen=frozen, mesh=mesh, tile_size=tile_size,
            parity=parity)
        names = list(params)
        flat = all_reduce_sum(torch.cat([loss.reshape(1)] + [grads[k].reshape(-1) for k in names]),
                              mesh)
        parts = torch.split(flat[1:], [params[k].numel() for k in names])
        return flat[0], {k: params[k].detach() - lr * g.reshape(params[k].shape)
                         for k, g in zip(names, parts)}

    return step
