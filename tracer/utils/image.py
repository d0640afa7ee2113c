"""Headless image output.

Reference parity: the reference blits frames to an interactive window
(SURVEY.md R8). This build is headless — frames are written as PNGs (a
dependency-free encoder using stdlib zlib) and animated runs write numbered
frame sequences (tracer.api.animate)."""
from __future__ import annotations

import struct
import zlib

import numpy as np


def tonemap(linear_rgb: np.ndarray, gamma: float = 2.2) -> np.ndarray:
    """Linear HDR -> uint8 sRGB-ish (simple gamma + clamp)."""
    x = np.clip(np.asarray(linear_rgb, np.float32), 0.0, 1.0)
    return (np.power(x, 1.0 / gamma) * 255.0 + 0.5).astype(np.uint8)


def write_png(path: str, rgb8: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 array as a PNG (no external deps)."""
    rgb8 = np.asarray(rgb8)
    assert rgb8.dtype == np.uint8 and rgb8.ndim == 3 and rgb8.shape[2] == 3
    h, w = rgb8.shape[:2]
    raw = b"".join(b"\x00" + rgb8[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Minimal PNG reader for our own 8-bit RGB files (round-trip tests)."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, w = 8, 0
    idat = b""
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", payload[:10])
            assert depth == 8 and ctype == 2, "only 8-bit RGB supported"
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + length
    raw = zlib.decompress(idat)
    stride = w * 3 + 1
    rows = []
    prev = np.zeros(w * 3, np.uint8)
    for y in range(len(raw) // stride):
        filt = raw[y * stride]
        row = np.frombuffer(raw[y * stride + 1 : (y + 1) * stride], np.uint8).copy()
        if filt == 0:
            pass
        elif filt == 2:  # Up
            row = (row.astype(np.int16) + prev).astype(np.uint8)
        else:
            raise ValueError(f"unsupported PNG filter {filt}")
        rows.append(row)
        prev = row
    return np.stack(rows).reshape(-1, w, 3)
