"""Asset streams (counterpart of zyg_tpu/io/fs.py `resolve` and
`open_stream`): a relative asset name resolves against the scene file's
directory, then as given; gzip-compressed files are unwrapped
transparently (ref read_stream.zig gzip magic sniff). The JAX package's
mount stack (`-m` on its CLI) is not ported: the port's CLI takes no
mounts.
"""

from __future__ import annotations

import gzip
import io
import os


def resolve(name: str, base_dir: str = "") -> str | None:
    """The first existing path among base_dir/name and name, or None."""
    if os.path.isabs(name) and os.path.exists(name):
        return name
    candidates = [os.path.join(base_dir, name)] if base_dir else []
    candidates.append(name)
    for c in candidates:
        if os.path.exists(c):
            return c
    return None


def open_stream(name: str, base_dir: str = ""):
    """A binary stream of the asset; a gzip file is decompressed."""
    path = resolve(name, base_dir)
    if path is None:
        raise FileNotFoundError(name)
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        data = gzip.decompress(f.read())
        f.close()
        return io.BytesIO(data)
    return f
