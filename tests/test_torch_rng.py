"""The port's threefry RNG against ``jax.random``: bit-equal uniforms."""

import jax
import numpy as np
import pytest
import torch

from pathtracerap_tpu.ops.rng import tile_uniforms as jax_tile_uniforms
from pathtracerap_tpu.pallas.megakernel import chunk_uniforms as jax_chunk_uniforms
from pathtracerap_tpu_torch.ops import rng


def _bits(x) -> np.ndarray:
    return np.asarray(x).view(np.int32)


@pytest.mark.parametrize("seed", [0, 5, 123456789, 2**31 + 7, 2**32 - 1])
def test_prng_key_matches_jax(seed):
    np.testing.assert_array_equal(
        rng.prng_key(seed, "cpu").numpy(), np.asarray(jax.random.PRNGKey(seed)).astype(np.int64)
    )


@pytest.mark.parametrize("seed", [-1, 2**32])
def test_prng_key_rejects_seeds_outside_32_bits(seed):
    with pytest.raises(ValueError):
        rng.prng_key(seed, "cpu")


@pytest.mark.parametrize("data", [0, 1, 7, 8191, 2**31 + 5, 2**32 - 1])
def test_fold_in_bit_equal(data):
    for seed in (0, 42):
        ref = np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), data)).astype(np.int64)
        np.testing.assert_array_equal(rng.fold_in(rng.prng_key(seed, "cpu"), data).numpy(), ref)


def test_fold_in_batched_matches_scalar():
    key = rng.prng_key(3, "cpu")
    data = torch.arange(10)
    batched = rng.fold_in(key[None, :], data)
    for i in range(10):
        assert torch.equal(batched[i], rng.fold_in(key, i))


@pytest.mark.parametrize("shape", [(1, 4), (3, 4), (5, 2), (8192, 4)])
def test_uniform_bit_equal(shape):
    for seed in (0, 9):
        ref = jax.random.uniform(jax.random.PRNGKey(seed), shape)
        out = rng.uniform(rng.prng_key(seed, "cpu"), *shape)
        np.testing.assert_array_equal(_bits(out.numpy()), _bits(ref))
        assert out.min() >= 0.0 and out.max() < 1.0


def test_tile_uniforms_bit_equal():
    ref = jax_tile_uniforms(jax.random.PRNGKey(4), 3, 5, 2, 1000)
    out = rng.tile_uniforms(rng.prng_key(4, "cpu"), 3, 5, 2, 1000)
    np.testing.assert_array_equal(_bits(out.numpy()), _bits(ref))


@pytest.mark.parametrize(
    "n, n_pad, tile_base",
    [(1000, 1024, 0), (8192, 8192, 3), (20000, 20480, 5), (16384, 16640, 1)],
)
def test_chunk_uniforms_bit_equal(n, n_pad, tile_base):
    """RNG tiles of 8192 rays, global tile numbering from tile_base, zero
    rows past the drawn tiles, depth order max_bounces - b."""
    ref = jax_chunk_uniforms(jax.random.PRNGKey(3), 7, 5, n, n_pad, tile_base)
    out = rng.chunk_uniforms(rng.prng_key(3, "cpu"), 7, 5, n, n_pad, tile_base)
    assert out.shape == (n_pad, 20)
    np.testing.assert_array_equal(_bits(out.numpy()), _bits(ref))


@pytest.mark.parametrize("n, n_pad, tile_base", [(1000, 1024, 0), (9000, 16384, 2)])
def test_chunk_uniforms_sample_batch_bit_equal(n, n_pad, tile_base):
    """A batch of samples stacks each sample's chunk, rows in (sample, ray)
    order, bit-equal to the JAX draws of each sample."""
    ref = np.concatenate(
        [np.asarray(jax_chunk_uniforms(jax.random.PRNGKey(2), s, 3, n, n_pad, tile_base))
         for s in (4, 5, 6)]
    )
    out = rng.chunk_uniforms(rng.prng_key(2, "cpu"), range(4, 7), 3, n, n_pad, tile_base)
    assert out.shape == (3 * n_pad, 12)
    np.testing.assert_array_equal(_bits(out.numpy()), _bits(ref))


def test_chunk_uniforms_wrapping_indices_bit_equal():
    """Sample and tile indices at and past 2**31 and 2**32 wrap as JAX's
    uint32 fold-in data do: samples 2**32 - 1 and 2**32 (JAX's 0), tiles
    2**31 - 2 .. 2**31, the largest seed."""
    ref = np.concatenate(
        [np.asarray(jax_chunk_uniforms(jax.random.PRNGKey(2**32 - 1), s, 2, 20000, 20480,
                                       2**31 - 2))
         for s in (2**32 - 1, 0)]
    )
    out = rng.chunk_uniforms(rng.prng_key(2**32 - 1, "cpu"), range(2**32 - 1, 2**32 + 1), 2,
                             20000, 20480, 2**31 - 2)
    np.testing.assert_array_equal(_bits(out.numpy()), _bits(ref))
