"""The lighttracer's camera splat (counterpart of the XLA scatter of
zyg_tpu/render/integrator/lighttracer.py:287-308; not a TPU kernel in the
JAX package). Kernel: csrc/lt_splat.cu.

At each vertex of a light path that connects to the camera, the BSDF
toward the camera, f (f * |cos|), and the contribution cam_pdf *
throughput * f added to the pixel the vertex projects to. A lane
connects where `connect` holds (the path goes on, the point projects
onto the frame in front of the camera, the prop is camera-visible and
the importance pdf is positive: every test of the JAX `connect` but the
BSDF's) and max(f) > 0; it adds where it connects and its shadow ray to
the camera is not `blocked`. The splat is [P, 4] float32: RGB and a
padding column that stays 0 (the kernel adds each contribution with one
float4 atomic). `count` (int64 [1]) gains the connecting lanes: the JAX
loop's rays add them.

`lt_splat` runs the plain version for CPU tensors and the kernel for
CUDA tensors. The kernel evaluates the substitute BSDF only
(csrc/shade_core.cuh::eval_terms); the other kinds a light path meets
add nothing (smooth glass and Light materials, whose f is 0), and a
material set with rough glass, which does evaluate a BSDF, is refused by
name. The plain version is the JAX expression in torch: `eval_bsdf` of
render/materials.py, then `index_add_` of the contributions in lane
order (XLA's scatter order on the CPU). The kernel's atomics add in
another order, and its BSDF rounds as the fused kernels' does, a few
float32 ulps from the plain version's.
"""

from __future__ import annotations

import ctypes

import torch

from . import check_cuda, register, stream_handle

_SPLAT = register(
    "lt_splat",
    "zyg_lt_splat",
    [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p],
)

# the kernel's lane inputs after the fit table, in its pointer order, with
# their dtype and trailing shape
LANE_FIELDS = (("wo", torch.float32, (3,)), ("wi", torch.float32, (3,)),
               ("n", torch.float32, (3,)), ("geo_n", torch.float32, (3,)),
               ("kind", torch.int32, ()), ("albedo", torch.float32, (3,)),
               ("f0", torch.float32, (3,)), ("alpha", torch.float32, ()),
               ("metallic", torch.float32, ()), ("specular", torch.float32, ()),
               ("throughput", torch.float32, (3,)), ("cam_pdf", torch.float32, ()),
               ("ids", torch.int64, ()), ("connect", torch.bool, ()),
               ("blocked", torch.bool, ()))
_FIT = {}  # device -> the GGX energy-fit table


def contributions(params, wo, wi, n, geo_n, throughput, cam_pdf, connect, blocked):
    """(the connecting lanes bool[N], each lane's contribution [N, 3], 0
    where it adds nothing), in the JAX order: cam_pdf * throughput * f."""
    from ..render.materials import eval_bsdf

    f, _ = eval_bsdf(params, wo, wi, n, geo_n)
    conn = connect & (f.amax(dim=1) > 0.0)
    contrib = torch.where((conn & ~blocked)[:, None], cam_pdf[:, None] * throughput * f, 0.0)
    return conn, contrib


def lt_splat_plain(params, wo, wi, n, geo_n, throughput, cam_pdf, ids, connect, blocked,
                   splat, count) -> None:
    """The splat in torch (see the module docstring): splat [P, 4] and
    count int64 [1] in place."""
    conn, contrib = contributions(params, wo, wi, n, geo_n, throughput, cam_pdf, connect,
                                  blocked)
    count += conn.sum()
    splat[:, :3].index_add_(0, ids, contrib)


def _fit(device):
    from ..render.materials import fit_table

    if device not in _FIT:
        _FIT[device] = fit_table(device)
    return _FIT[device]


def lt_splat(params, wo, wi, n, geo_n, throughput, cam_pdf, ids, connect, blocked, splat,
             count) -> None:
    """The camera splat of the connecting lanes (see the module
    docstring): the plain version for CPU tensors, the kernel for CUDA
    tensors. params: the material rows (render/materials.py gather); wo
    toward the previous vertex, wi toward the camera, n and geo_n the
    shading and geometric normals [N, 3]; throughput [N, 3], cam_pdf [N];
    ids int64[N], the pixel in [0, P); connect and blocked bool[N]."""
    if wo.device.type == "cpu":
        lt_splat_plain(params, wo, wi, n, geo_n, throughput, cam_pdf, ids, connect, blocked,
                       splat, count)
        return
    dev = wo.device
    if "rough_glass" in params.get("features", ()):
        raise ValueError("lt_splat: the kernel evaluates the substitute BSDF only (rough glass "
                         "in a light path)")
    nl = wo.shape[0]
    lanes = {"wo": wo, "wi": wi, "n": n, "geo_n": geo_n, "throughput": throughput,
             "cam_pdf": cam_pdf, "ids": ids, "connect": connect, "blocked": blocked, **params}
    ptrs = [_fit(dev).data_ptr()]
    for k, dtype, tail in LANE_FIELDS:
        check_cuda(f"lt_splat.{k}", lanes[k], dtype, dev, (nl, *tail))
        ptrs.append(lanes[k].data_ptr())
    check_cuda("lt_splat.splat", splat, torch.float32, dev, (splat.shape[0], 4))
    check_cuda("lt_splat.count", count, torch.int64, dev, (1,))
    ptrs += [splat.data_ptr(), count.data_ptr()]
    if nl > 0:
        arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
        _SPLAT(arr, nl, splat.shape[0], stream_handle(dev))
