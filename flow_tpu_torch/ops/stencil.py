# Constant-coefficient stencils on structured grids: the hand-written CUDA
# kernels that replace the Pallas kernels of flow_tpu/ops/pallas_stencil.py,
# and their plain PyTorch versions:
#   - stencil_apply_3d, 27 points (csrc/stencil3d.cu, K1);
#   - stencil_apply_2d, 9 points (csrc/stencil2d.cu, K2).
#
# Each wrapper launches its kernel for a CUDA tensor and takes the plain
# version only for a CPU tensor; any other device raises. It counts its
# launches in STENCIL_3D.launches or STENCIL_2D.launches, so a run can show
# that its main path went through the kernel. Both launch on every grid
# size: the JAX package's size gate for the Pallas kernel is a TPU decision.
from __future__ import annotations

import ctypes
import itertools

import torch

from .._build import Kernel

__all__ = ["stencil_apply_3d", "stencil_apply_3d_plain", "STENCIL_3D",
           "stencil_apply_2d", "stencil_apply_2d_plain", "STENCIL_2D"]


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS3 = [_P, _P, _P, _I, _I, _I, _P]
_ARGS2 = [_P, _P, _P, _I, _I, _P]
STENCIL_3D = Kernel("stencil3d", {"stencil27_f32": _ARGS3, "stencil27_f64": _ARGS3})
STENCIL_2D = Kernel("stencil2d", {"stencil9_f32": _ARGS2, "stencil9_f64": _ARGS2})

# dim -> (kernel, {dtype: entry point})
_ENTRIES = {
    3: (STENCIL_3D, {torch.float32: "stencil27_f32", torch.float64: "stencil27_f64"}),
    2: (STENCIL_2D, {torch.float32: "stencil9_f32", torch.float64: "stencil9_f64"}),
}


def _plain(xgrid, kernel):
    """The sum of 3^dim shifted slices of a zero-padded copy, offsets in
    lexicographic order. No convolution library is involved, so it is
    independent of cuDNN and TF32."""
    shape = xgrid.shape
    xp = xgrid.new_zeros(tuple(s + 2 for s in shape))
    xp[(slice(1, -1),) * xgrid.dim()] = xgrid
    y = torch.zeros_like(xgrid)
    for d in itertools.product(range(3), repeat=xgrid.dim()):
        y += kernel[d] * xp[tuple(slice(o, o + s) for o, s in zip(d, shape))]
    return y


def stencil_apply_3d_plain(xgrid, kernel):
    """y[i,j,k] = sum_{d in {-1,0,1}^3} kernel[d] * x[i+d] (zero padded)."""
    return _plain(xgrid, kernel)


def stencil_apply_2d_plain(xgrid, kernel):
    """y[i,j] = sum_{d in {-1,0,1}^2} kernel[d] * x[i+d] (zero padded)."""
    return _plain(xgrid, kernel)


def _apply(name, dim, xgrid, kernel):
    if xgrid.device.type == "cpu" and kernel.device.type == "cpu":
        return _plain(xgrid, kernel)
    if xgrid.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {xgrid.device}")
    if kernel.device != xgrid.device:
        raise ValueError(f"{name}: xgrid and kernel on different devices")
    if xgrid.dim() != dim or tuple(kernel.shape) != (3,) * dim:
        raise ValueError(
            f"{name}: want a {dim}-D xgrid and kernel {(3,) * dim}, got "
            f"{tuple(xgrid.shape)} and {tuple(kernel.shape)}"
        )
    launcher, entries = _ENTRIES[dim]
    if xgrid.dtype not in entries or kernel.dtype != xgrid.dtype:
        raise TypeError(
            f"{name}: want float32 or float64 of one dtype, got "
            f"{xgrid.dtype} and {kernel.dtype}"
        )
    if not (xgrid.is_contiguous() and kernel.is_contiguous()):
        raise ValueError(f"{name}: xgrid and kernel must be contiguous")
    if min(xgrid.shape) < 1 or xgrid.numel() >= 2**31:
        raise ValueError(f"{name}: unsupported grid {tuple(xgrid.shape)}")
    y = torch.empty_like(xgrid)
    with torch.cuda.device(xgrid.device):
        stream = torch.cuda.current_stream().cuda_stream
        launcher.launch(entries[xgrid.dtype], xgrid.data_ptr(), kernel.data_ptr(),
                        y.data_ptr(), *xgrid.shape, stream)
    return y


def stencil_apply_3d(xgrid, kernel):
    """y[i,j,k] = sum_{d in {-1,0,1}^3} kernel[d] * x[i+d] (zero padded).

    xgrid: [X, Y, Z] float32/float64; kernel: [3, 3, 3], same dtype and
    device. CUDA tensors go through the hand-written kernel; CPU tensors
    through stencil_apply_3d_plain."""
    return _apply("stencil_apply_3d", 3, xgrid, kernel)


def stencil_apply_2d(xgrid, kernel):
    """y[i,j] = sum_{d in {-1,0,1}^2} kernel[d] * x[i+d] (zero padded).

    xgrid: [X, Y] float32/float64; kernel: [3, 3], same dtype and device.
    CUDA tensors go through the hand-written kernel; CPU tensors through
    stencil_apply_2d_plain."""
    return _apply("stencil_apply_2d", 2, xgrid, kernel)
