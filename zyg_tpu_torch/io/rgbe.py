"""Radiance RGBE (.hdr) reader (counterpart of zyg_tpu/io/rgbe.py:26
`rgbe_to_float` and :76 `read_hdr`): flat and new-style RLE scanlines."""

from __future__ import annotations

import numpy as np


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
