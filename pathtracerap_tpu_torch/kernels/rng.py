"""Kernel R1: the uniform stream (``csrc/rng.cu``).

:func:`chunk_uniforms` launches the kernel for a key on the card (counted
in ``chunk_uniforms.launches``): one launch derives the fold-in keys of
every (sample, depth, RNG tile) of a chunk and writes every uniform of
it, on uint32, straight into the layout the engines read.
``ops/rng.py`` picks it for a key on the card and runs its plain twins
(:func:`..ops.rng.chunk_uniforms_plain`,
:func:`..ops.rng.chunk_jitter_uniforms_plain`, threefry as int64 torch
ops) for a CPU key; the two agree bit for bit.  JAX draws these uniforms
with ``jax.random`` in XLA, not in a Pallas kernel.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build


def chunk_uniforms(key: torch.Tensor, s0: int, ns: int, depths: int, width: int, n_pad: int,
                   tile_n: int, nt: int, tile_base: int) -> torch.Tensor:
    """R1 on the card: (ns * n_pad, width * depths) f32 uniforms of samples
    ``s0 .. s0 + ns - 1`` (mod 2**32), rows in (sample, ray) order.
    ``width`` 4: column block ``b`` holds depth ``depths - b``; ``width``
    2: the quality camera's jitter, depth 0 (``depths`` 1).  Ray ``r``
    lies in RNG tile ``tile_base + r // tile_n`` (mod 2**32) at lane
    ``r % tile_n``; rows of tiles ``nt`` and on are zeros, and rows past
    ``n_pad`` are not drawn; ``tile_n`` 0 (an empty chunk) draws no tile
    and gives zero rows.  ``key`` is the (2,) int64 key on the card, read
    there (no sync)."""
    if key.dtype != torch.int64 or tuple(key.shape) != (2,):
        raise ValueError(f"key: expected int64 (2,), got {key.dtype} {tuple(key.shape)}")
    if width not in (2, 4) or (width == 2 and depths != 1) or depths < 1:
        raise ValueError(f"width {width} with {depths} depths: expected 4, or 2 with one depth")
    if ns < 0 or n_pad < 0 or tile_n < 0 or nt < 0:
        raise ValueError(f"ns {ns}, n_pad {n_pad}, tile_n {tile_n}, nt {nt}")
    dev = key.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    key = key.contiguous()
    out = torch.empty((ns * n_pad, width * depths), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    if tile_n == 0:
        tile_n, nt = n_pad, 0  # the kernel writes every row as a zero row
    # ctypes.c_uint32 wraps s0 and tile_base mod 2**32, as the stream does.
    err = _build.library().ptt_chunk_uniforms(
        ctypes.c_void_p(key.data_ptr()), ctypes.c_uint32(s0), ctypes.c_int(ns),
        ctypes.c_int(depths), ctypes.c_int(width), ctypes.c_int(n_pad), ctypes.c_int(tile_n),
        ctypes.c_int(nt), ctypes.c_uint32(tile_base), ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    _build.check(err, "ptt_chunk_uniforms")
    chunk_uniforms.launches += 1
    return out


chunk_uniforms.launches = 0
