"""Radiance RGBE (.hdr) writer and reader (counterpart of
zyg_tpu/io/rgbe.py): the writer RLE-encodes scanlines as the JAX package
does, byte for byte; the reader takes flat and new-style RLE scanlines."""

from __future__ import annotations

import numpy as np


def float_to_rgbe(rgb: np.ndarray) -> np.ndarray:
    """[..., 3] float -> [..., 4] uint8 shared-exponent texels."""
    maxc = rgb.max(axis=-1)
    out = np.zeros(rgb.shape[:-1] + (4,), np.uint8)
    nz = maxc >= 1e-32
    mant, exp = np.frexp(np.where(nz, maxc, 1.0))
    scale = mant * 256.0 / np.where(nz, maxc, 1.0)
    for c in range(3):
        out[..., c] = np.clip(rgb[..., c] * scale * nz, 0, 255).astype(np.uint8)
    out[..., 3] = np.where(nz, exp + 128, 0).astype(np.uint8)
    return out


def _rle_encode(row: np.ndarray) -> bytes:
    """One channel of a scanline: runs of 4 to 127 equal bytes as
    (128 + run, byte), everything between as literal spans of <= 128."""
    out = bytearray()
    i = 0
    n = len(row)
    while i < n:
        run = 1
        while i + run < n and run < 127 and row[i + run] == row[i]:
            run += 1
        if run >= 4:
            out += bytes([128 + run, int(row[i])])
            i += run
        else:
            # literals up to the next run of 4
            j = i
            while j < n and j - i < 128:
                r = 1
                while j + r < n and r < 4 and row[j + r] == row[j]:
                    r += 1
                if r >= 4:
                    break
                j += 1
            out += bytes([j - i]) + row[i:j].tobytes()
            i = j
    return bytes(out)


def write_hdr(path: str, image: np.ndarray) -> None:
    """image: [H, W, 3] linear float; RLE scanlines where 8 <= W <= 32767,
    flat texels otherwise."""
    h, w, _ = image.shape
    rgbe = float_to_rgbe(np.asarray(image, np.float32))
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\n")
        f.write(b"FORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        if w < 8 or w > 0x7FFF:
            f.write(rgbe.tobytes())
            return
        for y in range(h):
            f.write(bytes([2, 2, (w >> 8) & 0xFF, w & 0xFF]))
            for c in range(4):
                f.write(_rle_encode(rgbe[y, :, c]))


def rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    """[..., 4] uint8 shared-exponent texels -> [..., 3] float32."""
    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp != 0, np.ldexp(1.0, exp - 136), 0.0)
    return (rgbe[..., :3].astype(np.float32) + 0.5) * scale[..., None]


def read_hdr(path: str) -> np.ndarray:
    """A .hdr file -> [H, W, 3] float (the header's "-Y H +X W" order)."""
    with open(path, "rb") as f:
        data = f.read()
    pos = 0

    def line():
        nonlocal pos
        e = data.index(b"\n", pos)
        s = data[pos:e]
        pos = e + 1
        return s

    if not line().startswith(b"#?"):
        raise ValueError(f"not a Radiance HDR file: {path}")
    while line() != b"":
        pass
    dims = line().split()
    h, w = int(dims[1]), int(dims[3])
    img = np.zeros((h, w, 4), np.uint8)
    for y in range(h):
        if data[pos] == 2 and data[pos + 1] == 2:
            pos += 4
            for c in range(4):
                x = 0
                while x < w:
                    count = data[pos]
                    pos += 1
                    if count > 128:  # a run
                        img[y, x : x + count - 128, c] = data[pos]
                        pos += 1
                        x += count - 128
                    else:  # literals
                        img[y, x : x + count, c] = np.frombuffer(data[pos : pos + count], np.uint8)
                        pos += count
                        x += count
        else:
            img[y] = np.frombuffer(data[pos : pos + 4 * w], np.uint8).reshape(w, 4)
            pos += 4 * w
    return rgbe_to_float(img)
