"""Stateless counter-based RNG (port of ``pathtracerap_tpu/ops/rng.py``).

The renderer's random stream is a pure function of (seed, sample, depth,
RNG tile, lane).  The reference draws it with ``jax.random`` threefry2x32;
this module reimplements that generator in torch so the port consumes the
SAME uniforms bit for bit (``jax_threefry_partitionable=True``, the
default of jax 0.9):

* ``PRNGKey(seed)`` is the pair ``(0, seed)`` for a 32-bit seed;
* ``fold_in(key, d)`` is ``threefry2x32(key, (0, d))``;
* ``uniform(key, shape)`` hashes the flat element index ``i`` as the count
  pair ``(i >> 32, i & 0xFFFFFFFF)``, XORs the two output words, keeps the
  top 23 bits as the mantissa of a float in [1, 2) and subtracts 1.

The engines draw through :func:`chunk_uniforms` and
:func:`chunk_jitter_uniforms`.  For a key on the card they launch kernel R1
(``kernels/rng.py``, ``csrc/rng.cu``): one launch a call, on uint32.  For a
CPU key they run their plain twins, :func:`chunk_uniforms_plain` and
:func:`chunk_jitter_uniforms_plain`, which hold the integers in int64
tensors masked to 32 bits; the two agree bit for bit.  The JAX package draws
these uniforms in XLA.
"""

from __future__ import annotations

import numbers

import torch

from ..kernels import rng as KR
from ..utils.profiling import annotate

# Uniform draws per (ray, bounce): METAL draws 4 (utility.h:150-157).
DRAWS_PER_BOUNCE = 4
RNG_TILE = 8192  # uniforms stream granularity, in rays

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(key, x0: torch.Tensor, x1: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) of count words ``(x0, x1)`` under
    ``key = (k0, k1)``; every value is an int64 tensor (or int) in
    [0, 2**32)."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def prng_key(seed: int, device="cuda") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` (32-bit seeds, as jax without x64) as
    a (2,) int64 tensor on ``device``: the card unless the caller asks for
    the CPU, as the port's scenes are."""
    if not 0 <= seed <= _MASK:
        raise ValueError(f"seed must be in [0, 2**32), got {seed}")
    return torch.tensor([0, seed], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``.  ``key`` is (..., 2); ``data`` an int or an
    int tensor broadcasting against ``key[..., 0]``.  Returns (..., 2)."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _MASK
    k = (key[..., 0], key[..., 1])
    o0, o1 = threefry2x32(k, torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(o0, o1), dim=-1)


def uniform(key: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """``jax.random.uniform(key, (n, m), float32)`` for a (2,) key, or a
    batch of them: ``key`` (..., 2) gives (..., n, m)."""
    idx = torch.arange(n * m, dtype=torch.int64, device=key.device)
    k0 = key[..., 0, None]
    k1 = key[..., 1, None]
    b0, b1 = threefry2x32((k0, k1), idx >> 32, idx & _MASK)
    bits = (b0 ^ b1) >> 9 | 0x3F800000
    f = bits.to(torch.int32).view(torch.float32) - 1.0
    return f.reshape(key.shape[:-1] + (n, m))


def bounce_key(key: torch.Tensor, sample_index, depth) -> torch.Tensor:
    """Key for one (sample iteration, depth) wavefront step."""
    return fold_in(fold_in(key, sample_index), depth)


def tile_uniforms(key, sample_index, depth, tile_index, tile_n: int) -> torch.Tensor:
    """(tile_n, 4) uniforms for one ray tile of one shading step."""
    k = fold_in(bounce_key(key, sample_index, depth), tile_index)
    return uniform(k, tile_n, DRAWS_PER_BOUNCE)


def camera_jitter_uniforms(key, sample_index, tile_index, tile_n: int) -> torch.Tensor:
    """(tile_n, 2) sub-pixel jitter offsets in [0, 1) for one RNG tile of
    one sample (the quality camera): depth 0 of the (sample, depth, tile)
    stream, which the shading steps (depths ``max_bounces .. 1``) never
    draw.  ``tile_index`` may be an int tensor of shape (nt,): then every
    tile is hashed in one pass and the result is (nt, tile_n, 2)."""
    k = fold_in(bounce_key(key, sample_index, 0), tile_index)
    return uniform(k, tile_n, 2)


def _rng_tiling(n: int, rng_tile: int = RNG_TILE):
    """Uniforms are drawn in tiles of ``min(n, rng_tile)`` rays.  Returns
    (tile_n, n_tiles)."""
    if n <= rng_tile:
        return n, 1
    return rng_tile, -(-n // rng_tile)


def _sample_run(sample_index):
    """``(s0, ns)`` for an int or a non-empty ``range`` of step 1, the
    samples kernel R1 takes; ValueError for any other sequence."""
    if isinstance(sample_index, numbers.Integral):
        return int(sample_index), 1
    if isinstance(sample_index, range) and sample_index.step == 1 and len(sample_index):
        return sample_index.start, len(sample_index)
    raise ValueError(f"kernel R1 takes an int or a range of step 1 as samples, got {sample_index!r}")


def chunk_uniforms(key, sample_index, max_bounces: int, n: int, n_pad: int, tile_base: int = 0,
                   rng_tile: int = RNG_TILE):
    """(n_pad, 4 * max_bounces) uniforms for one sample iteration, or for
    ``ns`` of them when ``sample_index`` is a sequence: then
    (ns * n_pad, 4 * max_bounces), rows in (sample, ray) order.

    Column block ``b`` holds the draws of depth ``max_bounces - b`` (the
    reference seeds with ``remaining_bounces``, Renderer.cpp:435); RNG tile
    ``k`` of the chunk (``rng_tile`` rays: 8192 for the megakernel engines,
    the caller's ``tile_size`` for the per-bounce ones) is global tile
    ``tile_base + k``; rows past the drawn tiles are zero, rows past
    ``n_pad`` are dropped.  A key on the card launches kernel R1 once, and
    takes an int or a ``range`` of step 1 (ValueError otherwise); a CPU
    key runs the plain twin."""
    with annotate("ptap.rng"):
        if key.device.type != "cuda":
            return chunk_uniforms_plain(key, sample_index, max_bounces, n, n_pad, tile_base,
                                        rng_tile)
        tile_n, nt = _rng_tiling(n, rng_tile)
        return KR.chunk_uniforms(key, *_sample_run(sample_index), max_bounces, DRAWS_PER_BOUNCE,
                                 n_pad, tile_n, nt, tile_base)


def chunk_jitter_uniforms(key, sample_index, n: int, n_pad: int, tile_base: int = 0,
                          rng_tile: int = RNG_TILE):
    """(n_pad, 2) jitter offsets of one sample over the ``rng_tile``-ray
    RNG tiles of an ``n``-ray chunk, as the JAX engines draw them
    (:func:`camera_jitter_uniforms` for tiles ``tile_base + k``): rows past
    the drawn tiles are zero, rows past ``n_pad`` are dropped.  A key on
    the card launches kernel R1 once, and takes an int sample (ValueError
    otherwise); a CPU key runs the plain twin."""
    with annotate("ptap.rng"):
        if key.device.type != "cuda":
            return chunk_jitter_uniforms_plain(key, sample_index, n, n_pad, tile_base, rng_tile)
        s0, ns = _sample_run(sample_index)
        if ns != 1:
            raise ValueError(f"the jitter stream draws one sample a call, got {sample_index!r}")
        tile_n, nt = _rng_tiling(n, rng_tile)
        return KR.chunk_uniforms(key, s0, 1, 1, 2, n_pad, tile_n, nt, tile_base)


def chunk_uniforms_plain(key, sample_index, max_bounces: int, n: int, n_pad: int,
                         tile_base: int = 0, rng_tile: int = RNG_TILE):
    """Plain twin of :func:`chunk_uniforms` (and of kernel R1), in torch
    on ``key``'s device.  Every key of every (sample, depth, tile) is
    hashed in one batched pass, so the launch count does not grow with
    samples or bounces."""
    chunk_uniforms_plain.calls += 1
    tile_n, nt = _rng_tiling(n, rng_tile)
    dev = key.device
    samples = torch.as_tensor(sample_index, dtype=torch.int64, device=dev).reshape(-1)
    depths = max_bounces - torch.arange(max_bounces, dtype=torch.int64, device=dev)
    tiles = tile_base + torch.arange(nt, dtype=torch.int64, device=dev)
    k_s = fold_in(key[None, :], samples)  # (ns, 2)
    k_d = fold_in(k_s[:, None, :], depths)  # (ns, B, 2): bounce_key
    k_t = fold_in(k_d[:, :, None, :], tiles)  # (ns, B, nt, 2)
    u = uniform(k_t, tile_n, DRAWS_PER_BOUNCE).reshape(samples.shape[0], max_bounces, -1, 4)
    if u.shape[2] < n_pad:
        u = torch.cat([u, u.new_zeros(u.shape[:2] + (n_pad - u.shape[2], 4))], dim=2)
    return u[:, :, :n_pad].permute(0, 2, 1, 3).reshape(-1, DRAWS_PER_BOUNCE * max_bounces)


chunk_uniforms_plain.calls = 0


def chunk_jitter_uniforms_plain(key, sample_index, n: int, n_pad: int, tile_base: int = 0,
                                rng_tile: int = RNG_TILE):
    """Plain twin of :func:`chunk_jitter_uniforms` (and of kernel R1's
    jitter form), in torch on ``key``'s device."""
    chunk_jitter_uniforms_plain.calls += 1
    tile_n, nt = _rng_tiling(n, rng_tile)
    tiles = tile_base + torch.arange(nt, dtype=torch.int64, device=key.device)
    u = camera_jitter_uniforms(key, sample_index, tiles, tile_n).reshape(-1, 2)
    if u.shape[0] < n_pad:
        u = torch.cat([u, u.new_zeros(n_pad - u.shape[0], 2)])
    return u[:n_pad]


chunk_jitter_uniforms_plain.calls = 0
