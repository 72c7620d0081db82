"""Cem Yuksel's HAIR format reader (counterpart of zyg_tpu/io/hair.py
`read_hair`; ref shape/curve/hair_reader.zig): strands of line segments
regrouped into cubic Beziers (3 segments a cubic; a short remainder
repeats its last point), moved from HAIR's axes into the scene's and
paired with per-point widths.
"""

from __future__ import annotations

import struct

import numpy as np

from ..scene.curves import HostCurves

# ref hair_reader.zig fromHAIRspace: an axis swizzle and a global scale
_HAIR_SCALE = 0.004


def read_hair(stream) -> HostCurves:
    data = stream.read()
    if data[:4] != b"HAIR":
        raise ValueError("not a HAIR file (bad signature)")
    num_strands, num_vertices, flags, default_segments = struct.unpack_from("<IIII", data, 4)
    default_thickness, _default_alpha = struct.unpack_from("<ff", data, 20)
    # the default colour (3 floats) and 88 bytes of file info follow
    off = 4 + 4 * 4 + 4 * 2 + 12 + 88
    if not flags & 2:
        raise ValueError("HAIR file without vertex data")
    if flags & 1:
        segments = np.frombuffer(data, "<u2", num_strands, off).astype(np.int64)
        off += 2 * num_strands
    else:
        segments = np.full(num_strands, default_segments, np.int64)
    verts = np.frombuffer(data, "<f4", num_vertices * 3, off).reshape(-1, 3)
    off += 4 * num_vertices * 3
    if flags & 4:
        thickness = np.frombuffer(data, "<f4", num_vertices, off).astype(np.float32)
    else:
        thickness = np.full(num_vertices, default_thickness, np.float32)
    # transparency and colour arrays are not read: the material gives colour

    pos = np.stack([-verts[:, 1], verts[:, 2], verts[:, 0]], axis=-1).astype(np.float32)
    pos = pos * _HAIR_SCALE
    widths_src = thickness * (_HAIR_SCALE * 0.625)  # ref: thickness * 0.0025

    pts, wid, starts, sids, sus = [], [], [], [], []
    src = dst = 0
    for s in range(num_strands):
        nseg = int(segments[s])
        sv = pos[src:src + nseg + 1]
        sw = widths_src[src:src + nseg + 1]
        src += nseg + 1
        full, rem = nseg // 3, nseg % 3
        ncurve = full + (1 if rem else 0)
        if ncurve == 0:
            continue
        out_p, out_w = [], []
        for c in range(full):
            out_p.extend(sv[c * 3:c * 3 + 3])
            out_w.extend(sw[c * 3:c * 3 + 3])
        out_p.append(sv[full * 3])
        out_w.append(sw[full * 3])
        if rem:
            end = full * 3 + rem
            # a degenerate tail cubic (ref hair_reader.zig remainder)
            out_p.extend([sv[min(full * 3 + 1, end)], sv[end], sv[end]])
            out_w.extend([sw[min(full * 3 + 1, end)], sw[end], sw[end]])
        for c in range(ncurve):
            starts.append(dst + c * 3)
            sids.append(s)
            sus.append((c / ncurve, (c + 1) / ncurve))
        pts.extend(out_p)
        wid.extend(out_w)
        dst += len(out_p)
    return HostCurves(
        points=np.asarray(pts, np.float32),
        widths=np.asarray(wid, np.float32),
        curve_starts=np.asarray(starts, np.int64),
        strand_ids=np.asarray(sids, np.int32),
        strand_u=np.asarray(sus, np.float32),
    )
