"""Minimal OpenEXR writer and reader (counterpart of zyg_tpu/io/exr.py):
single-part scanline images, RGB(A) and any AOV channels, HALF or FLOAT,
ZIP compression (16-line blocks, with the spec's byte predictor) or none.
zlib and numpy only. The writer's bytes equal the JAX package's.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

MAGIC = 20000630
HALF = 1
FLOAT = 2
NO_COMPRESSION = 0
ZIP_COMPRESSION = 3

_SCANLINES_PER_BLOCK = {NO_COMPRESSION: 1, ZIP_COMPRESSION: 16}


def _attr(name: bytes, type_: bytes, data: bytes) -> bytes:
    return name + b"\x00" + type_ + b"\x00" + struct.pack("<I", len(data)) + data


def _predictor_encode(data: bytearray) -> bytes:
    """EXR zip pre-filter, per the OpenEXR spec (ImfZip compress; ref
    exr_writer.zig reorder()): deinterleave bytes into two halves FIRST,
    then delta-encode (+128+256 bias) over the reordered buffer."""
    arr = np.frombuffer(bytes(data), np.uint8)
    half = (len(arr) + 1) // 2
    reordered = np.empty_like(arr)
    reordered[:half] = arr[0::2]
    reordered[half:] = arr[1::2]
    s = reordered.astype(np.int16)
    delta = np.empty_like(s)
    delta[0] = s[0]
    delta[1:] = s[1:] - s[:-1] + 128 + 256
    return (delta & 0xFF).astype(np.uint8).tobytes()


def _predictor_decode(data: bytes) -> bytes:
    """Inverse of _predictor_encode: undo the delta predictor first
    (cumulative sum mod 256), then re-interleave the two halves."""
    arr = np.frombuffer(data, np.uint8).astype(np.int16)
    out = arr.copy()
    out[1:] = out[1:] - 128 - 256
    np.cumsum(out, out=out)
    dec = (out & 0xFF).astype(np.uint8)
    half = (len(dec) + 1) // 2
    inter = np.empty_like(dec)
    inter[0::2] = dec[:half]
    inter[1::2] = dec[half:]
    return inter.tobytes()


def write_exr(
    path: str,
    channels: dict[str, np.ndarray],
    half: bool = True,
    compression: int = ZIP_COMPRESSION,
) -> None:
    """channels: name -> float array [H, W]; names sorted per EXR spec."""
    names = sorted(channels.keys())
    h, w = channels[names[0]].shape
    pixel_type = HALF if half else FLOAT
    dtype = np.float16 if half else np.float32
    psize = 2 if half else 4

    chan_data = b""
    for name in names:
        chan_data += (
            name.encode() + b"\x00"
            + struct.pack("<i", pixel_type)
            + struct.pack("<B3x", 0)
            + struct.pack("<ii", 1, 1)
        )
    chan_data += b"\x00"

    header = b""
    header += _attr(b"channels", b"chlist", chan_data)
    header += _attr(b"compression", b"compression", struct.pack("<B", compression))
    header += _attr(b"dataWindow", b"box2i", struct.pack("<iiii", 0, 0, w - 1, h - 1))
    header += _attr(b"displayWindow", b"box2i", struct.pack("<iiii", 0, 0, w - 1, h - 1))
    header += _attr(b"lineOrder", b"lineOrder", struct.pack("<B", 0))
    header += _attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
    header += _attr(b"screenWindowCenter", b"v2f", struct.pack("<ff", 0.0, 0.0))
    header += _attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
    header += b"\x00"

    lines_per_block = _SCANLINES_PER_BLOCK[compression]
    num_blocks = (h + lines_per_block - 1) // lines_per_block

    planes = {n: np.asarray(channels[n], np.float32).astype(dtype) for n in names}

    blocks = []
    for b in range(num_blocks):
        y0 = b * lines_per_block
        y1 = min(y0 + lines_per_block, h)
        raw = bytearray()
        for y in range(y0, y1):
            for n in names:
                raw += planes[n][y].tobytes()
        if compression == ZIP_COMPRESSION:
            comp = zlib.compress(_predictor_encode(raw), 6)
            if len(comp) >= len(raw):
                comp = bytes(raw)
        else:
            comp = bytes(raw)
        blocks.append((y0, comp))

    with open(path, "wb") as f:
        f.write(struct.pack("<I", MAGIC))
        f.write(struct.pack("<I", 2))  # version 2, scanline
        f.write(header)
        offset_table_pos = f.tell()
        f.write(b"\x00" * (8 * num_blocks))
        offsets = []
        for y0, comp in blocks:
            offsets.append(f.tell())
            f.write(struct.pack("<i", y0))
            f.write(struct.pack("<I", len(comp)))
            f.write(comp)
        f.seek(offset_table_pos)
        for off in offsets:
            f.write(struct.pack("<Q", off))


def read_exr(path: str) -> dict[str, np.ndarray]:
    """Reads single-part scanline EXR (ZIP or uncompressed, half/float)."""
    with open(path, "rb") as f:
        data = f.read()
    magic, version = struct.unpack_from("<II", data, 0)
    if magic != MAGIC:
        raise ValueError(f"not an EXR file: {path}")
    pos = 8
    attrs = {}
    while data[pos] != 0:
        e = data.index(b"\x00", pos)
        name = data[pos:e].decode()
        pos = e + 1
        e = data.index(b"\x00", pos)
        type_ = data[pos:e].decode()
        pos = e + 1
        (size,) = struct.unpack_from("<I", data, pos)
        pos += 4
        attrs[name] = (type_, data[pos : pos + size])
        pos += size
    pos += 1

    chans = []
    cdata = attrs["channels"][1]
    cpos = 0
    while cdata[cpos] != 0:
        e = cdata.index(b"\x00", cpos)
        cname = cdata[cpos:e].decode()
        cpos = e + 1
        (ptype,) = struct.unpack_from("<i", cdata, cpos)
        cpos += 16
        chans.append((cname, ptype))
    (compression,) = struct.unpack_from("<B", attrs["compression"][1], 0)
    x0, y0, x1, y1 = struct.unpack_from("<iiii", attrs["dataWindow"][1], 0)
    w, h = x1 - x0 + 1, y1 - y0 + 1

    lines_per_block = _SCANLINES_PER_BLOCK[compression]
    num_blocks = (h + lines_per_block - 1) // lines_per_block
    offsets = struct.unpack_from(f"<{num_blocks}Q", data, pos)

    out = {n: np.zeros((h, w), np.float32) for n, _ in chans}
    for off in offsets:
        (y,) = struct.unpack_from("<i", data, off)
        (size,) = struct.unpack_from("<I", data, off + 4)
        comp = data[off + 8 : off + 8 + size]
        ny = min(lines_per_block, h - y)
        raw_size = ny * sum(w * (2 if pt == HALF else 4) for _, pt in chans)
        raw = comp if len(comp) == raw_size else _predictor_decode(zlib.decompress(comp))
        rpos = 0
        for yy in range(y, y + ny):
            for cname, ptype in chans:
                n = w * (2 if ptype == HALF else 4)
                dt = np.float16 if ptype == HALF else np.float32
                out[cname][yy] = np.frombuffer(raw[rpos : rpos + n], dt).astype(np.float32)
                rpos += n
    return out
