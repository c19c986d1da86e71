"""Kernel S1: the shading of the train step's index forward
(``csrc/defer_shade.cu``).

:func:`defer_shade` shades a deferred bounce and :func:`defer_shade_primary`
bounce 0, each in one launch for tensors on the card (both counted in
``defer_shade.launches``).  ``kernels/megakernel.py``'s
``defer_shade_apply`` and ``first_wavefront`` pick them for tensors on the
card and run their plain twins, the torch bodies ``defer_shade_plain`` and
``primary_shade_plain``, for CPU ones; the two agree bit for bit.  The JAX
package shades these bounces in XLA, not in a Pallas kernel.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .trace import _check

STATE_COLS = 10  # the state pack [orig(0:3), dir(3:6), color(6:9), remaining(9)]


def _launchable(dev) -> None:
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")


def _rays(x: torch.Tensor, name: str, n: int, dev) -> int:
    """Checks (n, 3) f32 rays whose rows may lie any whole number of
    floats apart (a camera's eye expanded to every ray: 0); returns that
    number."""
    if x.dtype != torch.float32 or tuple(x.shape) != (n, 3) or x.device != dev:
        raise ValueError(f"{name}: expected {torch.float32} {(n, 3)} on {dev}, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    if x.stride(1) != 1 or x.stride(0) < 0:
        raise ValueError(f"{name}: its rows must be contiguous, got strides {x.stride()}")
    return x.stride(0)


def defer_shade(pack: torch.Tensor, t: torch.Tensor, col1: torch.Tensor, attr_rows: torch.Tensor,
                u: torch.Tensor, parity: bool, pix=None, b: int = 0) -> torch.Tensor:
    """S1's deferred form: the next (N, 10) state pack of ``pack`` after a
    bounce whose winner kernel 3 found, ``t`` (N,) f32 and ``col1`` (N,)
    int32 (column + 1 of the (16, C) ``attr_rows``, 0 a miss).  ``u``: this
    bounce's (N, 4) uniforms, or with ``pix`` ((N,) int64) the wavefront's
    (M, 4 * B) stream, ray i reading row ``pix[i]`` at columns ``4 * b`` to
    ``4 * b + 3`` (what ``u[:, 4 * b:4 * b + 4][pix]`` gathers)."""
    n = pack.shape[0]
    dev = pack.device
    _check(pack, "pack", torch.float32, (n, STATE_COLS), dev)
    _check(t, "t", torch.float32, (n,), dev)
    _check(col1, "col1", torch.int32, (n,), dev)
    _check(attr_rows, "attr_rows", torch.float32, (16, attr_rows.shape[-1]), dev)
    if pix is None:
        _check(u, "u", torch.float32, (n, 4), dev)
        b = 0
    else:
        _check(pix, "pix", torch.int64, (n,), dev)
        _check(u, "u", torch.float32, (u.shape[0], u.shape[-1]), dev)
        if u.shape[1] % 4 or not 0 <= b < u.shape[1] // 4:
            raise ValueError(f"column block {b} of {tuple(u.shape)} uniforms: expected "
                             f"whole blocks of 4 and 0 <= b < {u.shape[1] // 4}")
    _launchable(dev)
    out = torch.empty_like(pack)
    err = _build.library().ptt_defer_shade(
        ctypes.c_void_p(pack.data_ptr()), ctypes.c_void_p(t.data_ptr()),
        ctypes.c_void_p(col1.data_ptr()), ctypes.c_void_p(attr_rows.data_ptr()),
        ctypes.c_int(attr_rows.shape[1]), ctypes.c_void_p(u.data_ptr()), ctypes.c_int(u.shape[1]),
        ctypes.c_int(4 * b), ctypes.c_void_p(pix.data_ptr() if pix is not None else None),
        ctypes.c_int(n), ctypes.c_int(int(parity)), ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    _build.check(err, "ptt_defer_shade")
    defer_shade.launches += 1
    return out


defer_shade.launches = 0


def defer_shade_primary(hits, ro_p: torch.Tensor, rd_p: torch.Tensor, u_flat: torch.Tensor,
                        max_bounces: int, parity: bool) -> torch.Tensor:
    """S1's bounce 0: the ``ns`` samples of the ``n_pad`` primary rays
    ``ro_p``, ``rd_p`` (n_pad, 3; rows any whole number of floats apart),
    hit as the ``hits`` records (kernel 1's: every field but ``model`` and
    ``tri``), as one wavefront shaded with the first column block of the
    (ns * n_pad, 4 * max_bounces) uniforms ``u_flat``: the (ns * n_pad, 10)
    state pack, rows in (sample, ray) order."""
    n_pad = ro_p.shape[0]
    rows = u_flat.shape[0]
    dev = ro_p.device
    if n_pad == 0 or rows % n_pad or max_bounces < 1:
        raise ValueError(f"{rows} uniform rows, {n_pad} rays, {max_bounces} bounces: expected "
                         "whole samples of the rays and a bounce or more")
    fields = {"t": (torch.float32, (n_pad,)), "normal": (torch.float32, (n_pad, 3)),
              "mat_type": (torch.int32, (n_pad,)), "mat_color": (torch.float32, (n_pad, 3)),
              "geom_normal": (torch.float32, (n_pad, 3)), "mat_ri": (torch.float32, (n_pad,))}
    for name, (dtype, shape) in fields.items():
        x = getattr(hits, name)
        if x is None:
            raise ValueError(f"the hit record has no {name}")
        _check(x, name, dtype, shape, dev)
    ro_ld, rd_ld = _rays(ro_p, "ro_p", n_pad, dev), _rays(rd_p, "rd_p", n_pad, dev)
    _check(u_flat, "u_flat", torch.float32, (rows, 4 * max_bounces), dev)
    _launchable(dev)
    out = torch.empty((rows, STATE_COLS), dtype=torch.float32, device=dev)
    err = _build.library().ptt_defer_shade_primary(
        *(ctypes.c_void_p(getattr(hits, f).data_ptr()) for f in fields),
        ctypes.c_void_p(ro_p.data_ptr()), ctypes.c_int(ro_ld), ctypes.c_void_p(rd_p.data_ptr()),
        ctypes.c_int(rd_ld), ctypes.c_int(n_pad), ctypes.c_int(rows),
        ctypes.c_void_p(u_flat.data_ptr()), ctypes.c_int(u_flat.shape[1]),
        ctypes.c_int(max_bounces), ctypes.c_int(int(parity)), ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    _build.check(err, "ptt_defer_shade_primary")
    defer_shade.launches += 1
    return out
