"""PNG encode and decode with the standard library (`zlib`, `struct`) and
numpy, for the image server: the card's machine has no PIL.

`encode_png` writes 8-bit grayscale, RGB or RGBA (colour types 0, 2, 6), one
IDAT chunk, every row with filter 0. `decode_png` reads the same colour types
at bit depth 8, non-interlaced, with any of the five row filters (what PIL
and other writers produce), checking each chunk's CRC.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPES = {1: 0, 3: 2, 4: 6}  # channels -> PNG colour type
_CHANNELS = {v: k for k, v in _COLOR_TYPES.items()}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def encode_png(image: np.ndarray) -> bytes:
    """uint8 [H, W] (grayscale) or [H, W, C] with C in 1, 3, 4 -> PNG bytes."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8 pixels, got {image.dtype}")
    if image.ndim == 2:
        image = image[..., None]
    if image.ndim != 3 or image.shape[-1] not in _COLOR_TYPES:
        raise ValueError(f"encode_png takes [H, W] or [H, W, 1|3|4] pixels, got shape {image.shape}")
    h, w, c = image.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), image.reshape(h, w * c)], axis=1)  # filter byte 0
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[c], 0, 0, 0)
    return SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(
        b"IEND", b"")


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _unfilter(kind: int, row: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    if kind == 0:
        return row
    if kind == 1:  # Sub: a running sum over each byte lane, mod 256
        return np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
    if kind == 2:  # Up
        return row + prior
    if kind not in (3, 4):
        raise ValueError(f"PNG row filter {kind} is not defined")
    out, up = bytearray(row.tobytes()), prior.tobytes()
    for x in range(len(out)):
        a = out[x - bpp] if x >= bpp else 0
        c = up[x - bpp] if x >= bpp else 0
        out[x] = (out[x] + ((a + up[x]) >> 1 if kind == 3 else _paeth(a, up[x], c))) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H, W, C] (C = 1, 3 or 4)."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace:
        raise ValueError(f"PNG of bit depth {depth}, colour type {color}, interlace {interlace}: only 8-bit "
                         "grayscale, RGB or RGBA, non-interlaced, is read")
    bpp = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * bpp)
    out = np.empty((h, w * bpp), np.uint8)
    prior = np.zeros(w * bpp, np.uint8)
    for y in range(h):
        prior = out[y] = _unfilter(int(raw[y, 0]), raw[y, 1:], prior, bpp)
    return out.reshape(h, w, bpp)
