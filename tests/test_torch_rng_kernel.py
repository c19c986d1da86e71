"""Kernel R1 (``csrc/rng.cu``, the uniform stream) and the dispatch of
``ops/rng.py`` to it.

On the CPU: which path a call takes (a CPU key runs the plain twins and
launches nothing; a key on the card, seen through a recorder in the
wrapper's place, launches R1 or raises) and the wrapper's argument checks.  On the GPU (``-m
cuda``; it has no JAX, so the JAX conftest is left out):

    python -m pytest --noconftest -m cuda tests/test_torch_rng_kernel.py

the kernel against the plain twin, bit for bit, and one launch a call.
The plain twins are held to ``jax.random`` in ``tests/test_torch_rng.py``.
This file imports no JAX.
"""

import types

import numpy as np
import pytest
import torch

from pathtracerap_tpu_torch.kernels import rng as KR
from pathtracerap_tpu_torch.ops import rng
from pathtracerap_tpu_torch.render.wavefront import DEFAULT_TILE

TOP = 2**32


@pytest.fixture(autouse=True)
def _counts():
    """Each test counts R1's launches from 0."""
    launches, KR.chunk_uniforms.launches = KR.chunk_uniforms.launches, 0
    yield
    KR.chunk_uniforms.launches = launches


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("sample_index, run", [
    (7, (7, 1)), (np.int64(TOP - 1), (TOP - 1, 1)), (range(3, 11), (3, 8)),
    (range(TOP - 2, TOP + 6), (TOP - 2, 8)), (range(0, 8, 2), None), (range(5, 5), None),
    ([4, 5, 6], None), ((4,), None), (torch.tensor(3), None),
])
def test_sample_run(sample_index, run):
    """An int or a range of step 1 gives (s0, ns); another sequence raises."""
    if run is None:
        with pytest.raises(ValueError, match="int or a range of step 1"):
            rng._sample_run(sample_index)
    else:
        assert rng._sample_run(sample_index) == run


@pytest.fixture
def launched(monkeypatch):
    """R1's wrapper replaced by a recorder of its arguments, so the dispatch
    of a key on the card is seen on the CPU."""
    calls = []
    monkeypatch.setattr(KR, "chunk_uniforms", lambda *a: calls.append(a) or "R1")
    return calls


@pytest.mark.parametrize("device, sample_index, launch", [
    ("cuda", 3, (3, 1, 4, 4, 1024, 1000, 1, 2)),
    ("cuda", range(0, 8), (0, 8, 4, 4, 1024, 1000, 1, 2)),
    ("cuda", [0, 1], ValueError), ("cuda", range(0, 8, 2), ValueError),
    ("cpu", 3, None), ("cpu", [0, 1], None),
])
def test_dispatch_rule(launched, device, sample_index, launch):
    """The key's device alone decides: a key on the card launches R1 with
    the sample run and ``_rng_tiling``'s tiles, and raises for a sample
    sequence R1 does not take; a CPU key runs the plain twin, whatever the
    samples."""
    plain = rng.chunk_uniforms_plain.calls
    if device == "cuda":
        key = types.SimpleNamespace(device=torch.device("cuda", 0))
        if launch is ValueError:
            with pytest.raises(ValueError, match="int or a range of step 1"):
                rng.chunk_uniforms(key, sample_index, 4, 1000, 1024, 2)
            assert not launched
        else:
            assert rng.chunk_uniforms(key, sample_index, 4, 1000, 1024, 2) == "R1"
            assert [a[1:] for a in launched] == [launch]
    else:
        out = rng.chunk_uniforms(rng.prng_key(5, "cpu"), sample_index, 4, 1000, 1024, 2)
        ns = 1 if isinstance(sample_index, int) else len(sample_index)
        assert out.shape == (ns * 1024, 16) and not launched
    assert rng.chunk_uniforms_plain.calls == plain + (device == "cpu")


@pytest.mark.parametrize("sample_index, launch", [
    (3, (3, 1, 1, 2, 1024, 1000, 1, 2)), (range(3, 4), (3, 1, 1, 2, 1024, 1000, 1, 2)),
    (range(3, 5), ValueError), ([3], ValueError),
])
def test_jitter_dispatch_on_the_card(launched, sample_index, launch):
    """A key on the card launches the jitter form of R1 for one sample, and
    raises for more than one or for a list."""
    key = types.SimpleNamespace(device=torch.device("cuda", 0))
    plain = rng.chunk_jitter_uniforms_plain.calls
    if launch is ValueError:
        with pytest.raises(ValueError):
            rng.chunk_jitter_uniforms(key, sample_index, 1000, 1024, 2)
        assert not launched
    else:
        assert rng.chunk_jitter_uniforms(key, sample_index, 1000, 1024, 2) == "R1"
        assert [a[1:] for a in launched] == [launch]
    assert rng.chunk_jitter_uniforms_plain.calls == plain


@pytest.mark.parametrize("stream", ["shade", "jitter"])
@pytest.mark.parametrize("n", [1000, 0])
def test_cpu_key_takes_the_plain_twin(stream, n):
    """A CPU key runs the plain twin once and launches nothing; the public
    function returns what the twin does, an empty chunk's zero rows too."""
    key = rng.prng_key(TOP - 1, "cpu")
    if stream == "shade":
        plain = rng.chunk_uniforms_plain
        args = (key, range(TOP - 2, TOP + 1), 4, n, 1024, 2**31 + 3)
        public = rng.chunk_uniforms
    else:
        plain = rng.chunk_jitter_uniforms_plain
        args = (key, TOP - 1, n, 1024, 2**31 + 3)
        public = rng.chunk_jitter_uniforms
    calls = plain.calls
    out = public(*args)
    assert plain.calls == calls + 1 and KR.chunk_uniforms.launches == 0
    assert torch.equal(out, plain(*args))
    if n == 0:
        assert out.shape[0] == (3 if stream == "shade" else 1) * 1024 and not out.any()


@pytest.mark.parametrize("kw, what", [
    (dict(key=torch.zeros(2, dtype=torch.int32)), "key"),
    (dict(key=torch.zeros(3, dtype=torch.int64)), "key"),
    (dict(width=3), "width"),
    (dict(width=2, depths=4), "width"),
    (dict(depths=0), "width"),
    (dict(tile_n=-1), "tile_n"),
    (dict(ns=-1), "ns"),
    (dict(), "no kernel"),
])
def test_wrapper_checks(kw, what):
    """The wrapper raises on arguments the kernel does not take, and on a
    key that is not on the card."""
    args = dict(key=torch.zeros(2, dtype=torch.int64), s0=0, ns=1, depths=4, width=4, n_pad=64,
                tile_n=64, nt=1, tile_base=0)
    args.update(kw)
    with pytest.raises(ValueError, match=what):
        KR.chunk_uniforms(**args)
    assert KR.chunk_uniforms.launches == 0


# (n, n_pad, tile_base, s0, ns, max_bounces, rng_tile, seed)
CASES = [
    (1000, 1024, 0, 7, 1, 5, rng.RNG_TILE, 0),  # n below the tile; zero rows
    (8192, 8192, 2, TOP - 3, 8, 4, rng.RNG_TILE, TOP - 1),  # n at the tile; samples wrap
    (20000, 20480, 2**31 + 3, TOP - 1, 1, 1, rng.RNG_TILE, 0),  # ragged last tile
    (20000, 16384, 2, TOP - 5, 8, 4, rng.RNG_TILE, TOP - 1),  # drawn rows dropped
    (65536, 65536, 0, 0, 8, 4, rng.RNG_TILE, 5),  # the Cornell render's call
    (131072, 131072, 0, 1, 1, 5, rng.RNG_TILE, 0),  # the reference step's
    (3000, 4096, 2**31 + 3, 5, 2, 5, 2048, TOP - 1),  # a per-bounce tile, ragged
    (9000, 9000, 2, TOP - 2, 8, 5, DEFAULT_TILE, 0),  # the per-bounce default tile
    (0, 1024, 2, 3, 2, 4, rng.RNG_TILE, TOP - 1),  # an empty chunk: zero rows only
]


@pytest.mark.cuda
@pytest.mark.parametrize("stream", ["shade", "jitter"])
@pytest.mark.parametrize("n, n_pad, tile_base, s0, ns, bounces, rng_tile, seed", CASES)
def test_kernel_matches_plain_twin(dev, stream, n, n_pad, tile_base, s0, ns, bounces, rng_tile,
                                   seed):
    """R1 on the card equals the plain twin on the CPU bit for bit, in one
    launch a call."""
    if stream == "shade":
        samples = s0 if ns == 1 else range(s0, s0 + ns)
        out = rng.chunk_uniforms(rng.prng_key(seed, dev), samples, bounces, n, n_pad, tile_base,
                                 rng_tile)
        ref = rng.chunk_uniforms_plain(rng.prng_key(seed, "cpu"), samples, bounces, n, n_pad,
                                       tile_base, rng_tile)
    else:
        out = rng.chunk_jitter_uniforms(rng.prng_key(seed, dev), s0, n, n_pad, tile_base,
                                        rng_tile)
        ref = rng.chunk_jitter_uniforms_plain(rng.prng_key(seed, "cpu"), s0, n, n_pad,
                                              tile_base, rng_tile)
    torch.cuda.synchronize()
    assert KR.chunk_uniforms.launches == 1
    assert out.shape == ref.shape and out.dtype == torch.float32
    assert torch.equal(out.cpu(), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("stream, samples", [
    ("shade", [4, 6]), ("shade", range(0, 8, 2)), ("jitter", range(4, 6)),
])
def test_other_sequences_raise_on_the_card(dev, stream, samples):
    """A sample sequence R1 does not take raises for a key on the card,
    and neither launches nor runs the plain twin."""
    calls = rng.chunk_uniforms_plain.calls + rng.chunk_jitter_uniforms_plain.calls
    with pytest.raises(ValueError):
        if stream == "shade":
            rng.chunk_uniforms(rng.prng_key(2, dev), samples, 3, 1000, 1024)
        else:
            rng.chunk_jitter_uniforms(rng.prng_key(2, dev), samples, 1000, 1024)
    assert KR.chunk_uniforms.launches == 0
    assert rng.chunk_uniforms_plain.calls + rng.chunk_jitter_uniforms_plain.calls == calls
