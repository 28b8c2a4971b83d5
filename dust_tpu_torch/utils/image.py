"""Dependency-free PNG/NPY image IO for demos and debugging.

(The reference's output path is a Vulkan swapchain; ours is files.)

The port's copy of :mod:`dust_tpu.utils.image`.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["write_png", "read_png"]


def write_png(path: str, image: np.ndarray) -> None:
    """Write an (H,W), (H,W,3) or (H,W,4) image. Float arrays are treated
    as linear [0,1] already-encoded values and quantised to 8 bits."""
    img = np.asarray(image)
    if img.ndim == 2:
        img = img[:, :, None].repeat(3, axis=2)
    if img.dtype != np.uint8:
        img = (np.clip(np.nan_to_num(img, nan=0.0, posinf=1.0), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    h, w, c = img.shape
    color_type = {3: 2, 4: 6}[c]

    raw = b"".join(b"\x00" + img[i].tobytes() for i in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)


def read_png(path: str) -> np.ndarray:
    """Minimal reader for PNGs written by :func:`write_png` (8-bit,
    non-interlaced, filter 0)."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos = 8
    idat = b""
    w = h = c = None
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + ln]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            assert depth == 8
            c = {0: 1, 2: 3, 6: 4}[ctype]
        elif tag == b"IDAT":
            idat += body
        pos += 12 + ln
    raw = zlib.decompress(idat)
    stride = w * c + 1
    rows = []
    prev = np.zeros(w * c, dtype=np.uint8)
    for i in range(h):
        filt = raw[i * stride]
        line = np.frombuffer(raw[i * stride + 1 : (i + 1) * stride], dtype=np.uint8).copy()
        if filt == 0:
            pass
        elif filt == 2:  # Up
            line = (line.astype(np.int64) + prev).astype(np.uint8)
        else:
            raise NotImplementedError(f"PNG filter {filt}")
        rows.append(line)
        prev = line
    return np.stack(rows).reshape(h, w, c)
