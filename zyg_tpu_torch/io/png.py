"""Minimal dependency-free PNG writer and reader (counterpart of
zyg_tpu/io/png.py): pure numpy, zlib and struct."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    out = struct.pack(">I", len(data)) + tag + data
    return out + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)


def write_png(path: str, image: np.ndarray) -> None:
    """image: uint8 [H,W], [H,W,3] or [H,W,4]."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise TypeError("write_png expects uint8")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    data = (
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(raw, 6))
        + _chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(data)


def read_png(path: str) -> np.ndarray:
    """Minimal PNG reader: 8/16-bit greyscale, grey-alpha, RGB, RGBA and
    8-bit palette images, not interlaced. Returns uint8/uint16 [H, W, C]
    (a palette image as its RGB entries)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"not a PNG: {path}")
    pos = 8
    idat = b""
    w = h = bitdepth = color_type = None
    palette = None
    while pos < len(data):
        (length,) = struct.unpack_from(">I", data, pos)
        tag = data[pos + 4 : pos + 8]
        chunk = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, bitdepth, color_type, _, _, interlace = struct.unpack(">IIBBBBB", chunk)
            if interlace != 0:
                raise ValueError(f"interlaced PNG: {path}")
        elif tag == b"PLTE":
            palette = np.frombuffer(chunk, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat += chunk
        elif tag == b"IEND":
            break
    raw = zlib.decompress(idat)
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    bpp_bytes = max(bitdepth // 8, 1) * channels
    stride = (w * channels * bitdepth + 7) // 8
    img = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    rpos = 0
    for y in range(h):
        ft = raw[rpos]
        line = np.frombuffer(raw[rpos + 1 : rpos + 1 + stride], np.uint8).astype(np.int32)
        rpos += 1 + stride
        cur = line.copy()
        if ft == 1:  # sub
            for x in range(bpp_bytes, stride):
                cur[x] = (cur[x] + cur[x - bpp_bytes]) & 0xFF
        elif ft == 2:  # up
            cur = (cur + prev) & 0xFF
        elif ft == 3:  # average
            for x in range(stride):
                a = cur[x - bpp_bytes] if x >= bpp_bytes else 0
                cur[x] = (line[x] + ((a + prev[x]) >> 1)) & 0xFF
        elif ft == 4:  # Paeth
            for x in range(stride):
                a = cur[x - bpp_bytes] if x >= bpp_bytes else 0
                b = prev[x]
                c = prev[x - bpp_bytes] if x >= bpp_bytes else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[x] = (line[x] + pred) & 0xFF
        img[y] = cur.astype(np.uint8)
        prev = cur
    if bitdepth == 16:
        out = img.view(">u2").astype(np.uint16).reshape(h, w, channels)
    else:
        out = img.reshape(h, w, channels)
    if color_type == 3:
        out = palette[out[..., 0]]
    return out


def linear_to_srgb_np(c: np.ndarray) -> np.ndarray:
    c = np.clip(c, 0.0, 1.0)
    return np.where(c <= 0.0031308, 12.92 * c, 1.055 * np.power(c, 1.0 / 2.4) - 0.055)


def float_to_srgb8(image: np.ndarray, dither: bool = True, seed: int = 0) -> np.ndarray:
    """[H,W,3] linear float -> sRGB uint8, with uniform dithering."""
    srgb = linear_to_srgb_np(np.clip(image, 0.0, 1.0)) * 255.0
    if dither:
        rng = np.random.default_rng(seed)
        srgb = srgb + (rng.random(srgb.shape) - 0.5)
    return np.clip(np.rint(srgb), 0, 255).astype(np.uint8)
