"""24-bit BMP writer and reader, byte-compatible with the reference's
writer (the port's copy of ``pathtracerap_tpu/io/bmp.py``, pure Python).

The reference hand-rolls a 54-byte header and streams rows bottom-up
(``Renderer.cpp:15-63``).  Parity mode keeps two of its quirks so golden
files compare byte for byte: (R, G, B) channel order and rows not padded
to 4 bytes.  ``parity=False`` writes a standard BMP (BGR, padded rows).
"""

from __future__ import annotations

import struct

import numpy as np

_HEADER_SIZE = 54


def _header(width: int, height: int, image_size: int) -> bytes:
    return struct.pack(
        "<2sIHHIIiiHHIIiiII",
        b"BM", _HEADER_SIZE + image_size, 0, 0, _HEADER_SIZE,
        40,  # BITMAPINFOHEADER size
        width, height,
        1,  # planes
        24,  # bits per pixel
        0,  # no compression
        image_size, 0, 0, 0, 0,
    )


def write_bmp(path: str, image: np.ndarray, parity: bool = True) -> None:
    """Write an (H, W, 3) uint8 image, row 0 = bottom row, already
    quantized (:func:`quantize_image`)."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError("write_bmp expects (H, W, 3) uint8")
    h, w = image.shape[:2]
    if parity:
        rows = image.reshape(h, w * 3).tobytes()  # RGB, unpadded (quirk)
        image_size = 3 * w * h
    else:
        pad = (-3 * w) % 4
        bgr = image[:, :, ::-1]
        rows = b"".join(bgr[y].tobytes() + b"\x00" * pad for y in range(h))
        image_size = (3 * w + pad) * h
    with open(path, "wb") as f:
        f.write(_header(w, h, image_size))
        f.write(rows)


def read_bmp(path: str, parity: bool = True) -> np.ndarray:
    """Read a BMP written by :func:`write_bmp` back into (H, W, 3) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"BM":
        raise ValueError("not a BMP file")
    offset = struct.unpack_from("<I", data, 10)[0]
    w = struct.unpack_from("<i", data, 18)[0]
    h = struct.unpack_from("<i", data, 22)[0]
    if parity:
        body = np.frombuffer(data, dtype=np.uint8, count=3 * w * h, offset=offset)
        return body.reshape(h, w, 3).copy()
    stride = 3 * w + ((-3 * w) % 4)
    rows = []
    for y in range(h):
        row = np.frombuffer(data, dtype=np.uint8, count=3 * w, offset=offset + y * stride)
        rows.append(row.reshape(w, 3)[:, ::-1])
    return np.stack(rows)


def quantize_image(accum: np.ndarray, n_samples: int) -> np.ndarray:
    """Reference quantization: ``accum / ITER * 255`` truncated toward
    zero (``Renderer.cpp:48-50``), clipped to the byte range."""
    div = np.float32(1.0) / np.float32(n_samples)
    scaled = np.asarray(accum, dtype=np.float32) * div * np.float32(255.0)
    return np.clip(np.trunc(scaled), 0, 255).astype(np.uint8)
