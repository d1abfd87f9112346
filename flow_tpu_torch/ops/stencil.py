# 27-point constant-coefficient stencil on a structured 3-D grid: the
# hand-written CUDA kernel (csrc/stencil3d.cu) that replaces the Pallas
# kernel flow_tpu/ops/pallas_stencil.py::stencil_apply_3d, and its plain
# PyTorch version.
#
# stencil_apply_3d launches the kernel for a CUDA tensor and takes the plain
# version only for a CPU tensor; any other device raises. It counts its
# launches in STENCIL_3D.launches, so a run can show that its main path went
# through the kernel.
from __future__ import annotations

import ctypes

import torch

from .._build import Kernel

__all__ = ["stencil_apply_3d", "stencil_apply_3d_plain", "STENCIL_3D"]


_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]
STENCIL_3D = Kernel("stencil3d", {"stencil27_f32": _ARGS, "stencil27_f64": _ARGS})

_ENTRY = {torch.float32: "stencil27_f32", torch.float64: "stencil27_f64"}


def stencil_apply_3d_plain(xgrid, kernel):
    """y[i,j,k] = sum_{d in {-1,0,1}^3} kernel[d] * x[i+d] (zero padded):
    the sum of 27 shifted slices of a zero-padded copy. No convolution
    library is involved, so it is independent of cuDNN and TF32."""
    X, Y, Z = xgrid.shape
    xp = xgrid.new_zeros((X + 2, Y + 2, Z + 2))
    xp[1:-1, 1:-1, 1:-1] = xgrid
    y = torch.zeros_like(xgrid)
    for dx in range(3):
        for dy in range(3):
            for dz in range(3):
                y += kernel[dx, dy, dz] * xp[dx:dx + X, dy:dy + Y, dz:dz + Z]
    return y


def stencil_apply_3d(xgrid, kernel):
    """y[i,j,k] = sum_{d in {-1,0,1}^3} kernel[d] * x[i+d] (zero padded).

    xgrid: [X, Y, Z] float32/float64; kernel: [3, 3, 3], same dtype and
    device. CUDA tensors go through the hand-written kernel; CPU tensors
    through stencil_apply_3d_plain."""
    if xgrid.device.type == "cpu" and kernel.device.type == "cpu":
        return stencil_apply_3d_plain(xgrid, kernel)
    if xgrid.device.type != "cuda":
        raise ValueError(f"stencil_apply_3d: no kernel for device {xgrid.device}")
    if kernel.device != xgrid.device:
        raise ValueError("stencil_apply_3d: xgrid and kernel on different devices")
    if xgrid.dim() != 3 or tuple(kernel.shape) != (3, 3, 3):
        raise ValueError(
            f"stencil_apply_3d: want xgrid [X,Y,Z] and kernel [3,3,3], got "
            f"{tuple(xgrid.shape)} and {tuple(kernel.shape)}"
        )
    if xgrid.dtype not in _ENTRY or kernel.dtype != xgrid.dtype:
        raise TypeError(
            f"stencil_apply_3d: want float32 or float64 of one dtype, got "
            f"{xgrid.dtype} and {kernel.dtype}"
        )
    if not (xgrid.is_contiguous() and kernel.is_contiguous()):
        raise ValueError("stencil_apply_3d: xgrid and kernel must be contiguous")
    X, Y, Z = xgrid.shape
    if min(X, Y, Z) < 1 or xgrid.numel() >= 2**31:
        raise ValueError(f"stencil_apply_3d: unsupported grid {tuple(xgrid.shape)}")
    y = torch.empty_like(xgrid)
    with torch.cuda.device(xgrid.device):
        stream = torch.cuda.current_stream().cuda_stream
        STENCIL_3D.launch(_ENTRY[xgrid.dtype], xgrid.data_ptr(), kernel.data_ptr(),
                          y.data_ptr(), X, Y, Z, stream)
    return y
