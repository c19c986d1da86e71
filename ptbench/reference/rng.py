"""A frozen copy of the renderer's uniform stream, in plain PyTorch.

The stream is a pure function of (seed, sample, depth, ray): Threefry-2x32
(20 rounds) as ``jax.random`` draws it with partitionable keys.

* the key of a seed is the word pair ``(0, seed)``;
* ``fold_in(key, d)`` hashes the count pair ``(0, d)`` under ``key``;
* the key of one shading step is ``fold_in(fold_in(key, sample), depth)``,
  then ``fold_in(., tile)`` for the ray's tile of ``TILE`` rays
  (``ray // TILE``);
* draw ``j`` of the ray is the hash of the count ``(0, (ray % TILE) * 4 + j)``
  under that key: the two output words XORed, the top 23 bits made the
  mantissa of a float in [1, 2), minus 1.

Depth counts down: the shading step of bounce ``b`` draws depth
``max_bounces - b``.  Integers are int64 tensors masked to 32 bits.
"""

from __future__ import annotations

import torch

TILE = 8192  # rays per tile of the stream
DRAWS = 4  # uniforms a ray draws per shading step
MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry(k0, k1, x0, x1):
    """Threefry-2x32 of the count words ``(x0, x1)`` under the key
    ``(k0, k1)``; ints or int64 tensors in [0, 2**32), broadcasting."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & MASK
    x1 = (x1 + k1) & MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def step_key(seed: int, sample: int, depth: int):
    """The (k0, k1) key of one shading step, as Python ints."""
    if not 0 <= seed <= MASK:
        raise ValueError(f"seed must be in [0, 2**32), got {seed}")
    k = (0, seed)
    k = threefry(k[0], k[1], 0, sample & MASK)
    return threefry(k[0], k[1], 0, depth & MASK)


def uniforms(seed: int, sample: int, depth: int, ray: torch.Tensor) -> torch.Tensor:
    """(len(ray), DRAWS) float32 uniforms of the rays with global indices
    ``ray`` (int64) at one (sample, depth)."""
    k0, k1 = step_key(seed, sample, depth)
    tile = ray // TILE
    n_tiles = int(tile.max()) + 1 if tile.numel() else 0
    tiles = torch.arange(n_tiles, dtype=torch.int64, device=ray.device)
    t0, t1 = threefry(k0, k1, torch.zeros_like(tiles), tiles & MASK)  # each tile's key once
    count = (ray % TILE)[:, None] * DRAWS + torch.arange(DRAWS, device=ray.device)
    b0, b1 = threefry(t0[tile][:, None], t1[tile][:, None], torch.zeros_like(count), count)
    bits = ((b0 ^ b1) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0
