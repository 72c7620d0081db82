"""Host resource cache keyed by (kind, name, options) (counterpart of
zyg_tpu/io/resource.py `ResourceCache`, ref resource/cache.zig:86): a
file decoded once is reused by every scene load that names it with the
same options, as a frame sequence reloads its scene each frame. Names
with a frame pattern ('#') are refused by the loader before they get
here, so the cache keys names as given.
"""

from __future__ import annotations


class ResourceCache:
    """Decoded host resources, keyed by (kind, name, options)."""

    def __init__(self):
        self._store: dict = {}

    def get_or_load(self, kind: str, name: str, options: tuple, loader):
        """The cached resource, else `loader(name)`, kept unless it returned
        None (a failed load is retried at the next lookup, as the
        reference's cache does)."""
        key = (kind, name, options)
        if key in self._store:
            return self._store[key]
        val = loader(name)
        if val is not None:
            self._store[key] = val
        return val

    def __len__(self) -> int:
        return len(self._store)


GLOBAL = ResourceCache()
