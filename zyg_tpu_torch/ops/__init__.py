"""Hand-written CUDA kernels for the renderer's hot ops, and their loader.

Every kernel lives in `zyg_tpu_torch/csrc/*.cu` with a plain C entry point.
At first use all sources are compiled by `nvcc` into ONE shared library
under `zyg_tpu_torch/_build/` (keyed by a hash of the sources and flags, so
a rebuilt checkout never loads a stale library) and bound with `ctypes`.

Each op module keeps a plain PyTorch version beside its kernel. The op's
wrapper takes the plain version only for tensors on the CPU; for a CUDA
tensor it launches the kernel or raises. Every `Kernel` counts its own
launches, so a run can show which kernels the main path went through.

Numerics: the library is built with `-fmad=false` (no fused multiply-add
contraction) and IEEE division and square root, so a kernel rounds each
operation the way the plain torch version does on the same card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-prec-div=true", "-prec-sqrt=true", "-Xptxas", "-v"]

_lib = None
build_info: dict = {}  # {"seconds", "path", "ptxas"} of this process's load


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA kernels requested but torch sees no CUDA device")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"libzyg_kernels_{_source_hash()}.so"
    t0 = time.perf_counter()
    log = BUILD_DIR / (so.stem + ".ptxas.txt")
    if not so.exists():
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
        res = subprocess.run(cmd, capture_output=True, text=True, check=False)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
        log.write_text(res.stdout + res.stderr)
        os.replace(tmp, so)
    _lib = ctypes.CDLL(str(so))
    build_info.update(
        seconds=time.perf_counter() - t0,
        path=str(so),
        ptxas=log.read_text() if log.exists() else "",
    )
    return _lib


class Kernel:
    """One C entry point of the library, with its launch count.

    Calling it launches the kernel on the current stream; a non-zero
    `cudaError_t` from the entry point (a refused launch) raises."""

    def __init__(self, name: str, symbol: str, argtypes: list):
        self.name = name
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(library(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            raise RuntimeError(f"{self.name}: CUDA launch failed with cudaError_t {err}")
        self.launches += 1


KERNELS: dict[str, Kernel] = {}


def register(name: str, symbol: str, argtypes: list) -> Kernel:
    k = Kernel(name, symbol, argtypes)
    KERNELS[name] = k
    return k


def launch_counts() -> dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def resident_lanes(symbol: str) -> int:
    """The lanes one pass of a persistent kernel's resident grid covers on
    the current device (SMs x resident blocks x block size), from the
    library's `symbol` (zyg_shade_resident_lanes, zyg_traverse_resident_lanes)."""
    fn = getattr(library(), symbol)
    fn.argtypes = [ctypes.POINTER(ctypes.c_int64)]
    fn.restype = ctypes.c_int
    out = ctypes.c_int64(0)
    err = fn(ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"{symbol}: cudaError_t {err}")
    return out.value


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype, device: torch.device,
               shape: tuple | None = None, contiguous: bool = True) -> None:
    """Raise unless `t` is what a kernel may read through a raw pointer."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {t.device}")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
