"""Host C++ for the mesh arena: the binned-SAH BVH builder
(native/bvh_builder.cpp), built with g++ at first use and bound with ctypes
(counterpart of zyg_tpu/native/__init__.py::build_bvh_native).

The library goes to the gitignored zyg_tpu_torch/_build/, named by a hash
of the source and flags so an edited source is never loaded stale. Several
processes may build at once (test workers): each compiles to its own
temporary file and renames it into place. There is no numpy fallback: a
missing compiler or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "bvh_builder.cpp"
BUILD_DIR = _SRC.parent.parent / "_build"
GXX_FLAGS = ["-O2", "-shared", "-fPIC", "-pthread"]

_lib = None


def library() -> ctypes.CDLL:
    """Build (at first use) and load the BVH builder library."""
    global _lib
    if _lib is not None:
        return _lib
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the mesh arena's BVH builder needs a C++ compiler")
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + _SRC.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"libzyg_bvh_{h}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(_SRC)],
                             capture_output=True, text=True, check=False)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed ({res.returncode}):\n{res.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.zyg_build_bvh2.restype = ctypes.c_int
    lib.zyg_build_bvh2.argtypes = [
        f32p, f32p, ctypes.c_int, ctypes.c_int,
        f32p, f32p, i32p, i32p, i32p, i32p, i32p, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int),
    ]
    _lib = lib
    return lib


def build_bvh_native(prim_min: np.ndarray, prim_max: np.ndarray, leaf_size: int):
    """C++ binned-SAH build over primitive AABBs -> scene.bvh.FlatBVH."""
    from ..scene.bvh import FlatBVH

    lib = library()
    pmin = np.ascontiguousarray(prim_min, np.float32)
    pmax = np.ascontiguousarray(prim_max, np.float32)
    n = pmin.shape[0]
    # spatial-split duplication budget (ref builder_base.zig spatial
    # splits): straddling references may duplicate up to 25 %
    prim_cap = n + n // 4 + 16
    cap = max(2 * prim_cap, 4)
    nodes_min = np.empty((cap, 3), np.float32)
    nodes_max = np.empty((cap, 3), np.float32)
    hit_link = np.empty(cap, np.int32)
    miss_link = np.empty(cap, np.int32)
    first_prim = np.empty(cap, np.int32)
    prim_count = np.empty(cap, np.int32)
    prim_order = np.empty(prim_cap, np.int32)
    nprims = ctypes.c_int(0)
    m = lib.zyg_build_bvh2(
        pmin, pmax, n, leaf_size,
        nodes_min, nodes_max, hit_link, miss_link, first_prim, prim_count,
        prim_order, cap, prim_cap, ctypes.byref(nprims),
    )
    if m <= 0:
        raise RuntimeError(f"BVH build failed over {n} primitives (code {m})")
    return FlatBVH(
        nodes_min=nodes_min[:m].copy(),
        nodes_max=nodes_max[:m].copy(),
        hit_link=hit_link[:m].copy(),
        miss_link=miss_link[:m].copy(),
        first_prim=first_prim[:m].copy(),
        prim_count=prim_count[:m].copy(),
        prim_order=prim_order[: nprims.value].copy(),
    )
