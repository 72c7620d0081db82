"""Binary BVH over primitive AABBs in the threaded (hit/miss-link) layout
(counterpart of zyg_tpu/scene/bvh.py). The build is the C++ binned-SAH
builder (native/); scene/trimesh.py collapses the result into 8-wide rows.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class FlatBVH:
    """Flattened threaded BVH, DFS numbered.

    nodes_min/max: [M, 3] float32
    hit_link:      [M] int32 node visited when the AABB is hit (inner
                   nodes: the left child; leaves: the miss link)
    miss_link:     [M] int32 node visited when missed (-1 = done)
    first_prim:    [M] int32 (-1 for inner nodes)
    prim_count:    [M] int32
    prim_order:    [P] int32 primitive permutation, leaf-contiguous
    """

    nodes_min: np.ndarray
    nodes_max: np.ndarray
    hit_link: np.ndarray
    miss_link: np.ndarray
    first_prim: np.ndarray
    prim_count: np.ndarray
    prim_order: np.ndarray


def build_bvh(prim_min: np.ndarray, prim_max: np.ndarray, leaf_size: int) -> FlatBVH:
    """Binned-SAH top-down build over primitive AABBs (C++)."""
    from ..native import build_bvh_native

    return build_bvh_native(prim_min, prim_max, leaf_size)
