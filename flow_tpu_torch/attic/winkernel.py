# Window-blocked scalar stiffness apply, y = K x with K = int grad(u).grad(v),
# on the uniform-stride layout of attic/window.py: the hand-written CUDA
# kernel (csrc/winstiff.cu) that replaces the Pallas kernel
# flow_tpu/attic/winkernel.py::WindowStiffnessOperator._pallas (K4b), and its
# plain PyTorch version.
#
# It is the pressure operator of the window route (navier_stokes/fast.py) and
# the operator of every large P1Hierarchy level (solvers/multigrid.py). Like
# the JAX package, the apply computes in float32 whatever the caller's dtype
# and casts at the boundary.
#
# stiffness_windows launches the kernel for CUDA tensors and takes the plain
# version only for CPU tensors. It counts its launches in WINSTIFF.launches.
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .._build import Kernel
from ..fem import assembly
from ..mesh3d import _device
from .window import build_scatter_lists, build_window_layout

__all__ = ["WindowStiffnessOperator", "stiffness_windows",
           "stiffness_windows_plain", "WINSTIFF"]

_P = ctypes.c_void_p
_I = ctypes.c_int
WINSTIFF = Kernel("winstiff", {
    "winstiff_p1_2d": [_P] * 8 + [_I] * 4 + [_P],
})


def stiffness_windows_plain(x_pad, lidx, valid, cg, kref, S, W):
    """Per-block output windows [nb, W] of the scalar stiffness apply.

    x_pad [nb*S + W] float32 (permuted, zero padded); lidx [nb, NL, C] int32;
    valid [nb, C]; cg [nb, DIM*DIM, C] with row DIM*k+l = C[c, k, l];
    kref [DIM*DIM*NL, NL] with row (DIM*k+l)*NL + i = Kref[k, l, i, :]."""
    nb, NL, C = lidx.shape
    d2 = cg.shape[1]
    base = (torch.arange(nb, device=lidx.device) * S)[:, None, None]
    u = x_pad[(base + lidx).long()]  # [nb, NL, C]
    K = kref.reshape(d2, NL, NL)
    loc = torch.einsum("bkc,kij,bjc->bic", cg, K, u) * valid[:, None, :]
    out = x_pad.new_zeros(nb * W)
    rows = (torch.arange(nb, device=lidx.device) * W)[:, None, None] + lidx
    return out.index_add_(0, rows.reshape(-1).long(), loc.reshape(-1)).view(nb, W)


def stiffness_windows(x_pad, lidx, valid, cg, kref, S, W, scatter=None):
    """Per-block output windows [nb, W] of the scalar stiffness apply (see
    stiffness_windows_plain). CPU tensors take the plain version; CUDA
    tensors launch the kernel, which sums each window dof along the
    layout's scatter lists `scatter` = (rowptr, ent) tensors. The kernel
    holds a block's C cells in shared memory at once and raises
    (RuntimeError) when they do not fit."""
    if x_pad.device.type == "cpu":
        return stiffness_windows_plain(x_pad, lidx, valid, cg, kref, S, W)
    if x_pad.device.type != "cuda":
        raise ValueError(f"stiffness_windows: no kernel for device {x_pad.device}")
    nb, NL, C = lidx.shape
    d2 = cg.shape[1]
    rowptr, ent = scatter
    if (d2, NL) != (4, 3):
        raise ValueError(
            f"stiffness_windows: the kernel takes 2-D P1 (DIM=2, NL=3), got "
            f"DIM^2={d2}, NL={NL}"
        )
    tensors = (x_pad, lidx, valid, cg, kref, rowptr, ent)
    for t in tensors:
        if t.device != x_pad.device or not t.is_contiguous():
            raise ValueError("stiffness_windows: tensors must be contiguous "
                             "and on one device")
    if any(t.dtype != torch.float32 for t in (x_pad, valid, cg, kref)):
        raise TypeError("stiffness_windows: float tensors must be float32")
    if any(t.dtype != torch.int32 for t in (lidx, rowptr, ent)):
        raise TypeError("stiffness_windows: index tensors must be int32")
    if (x_pad.numel() != nb * S + W or tuple(valid.shape) != (nb, C)
            or tuple(cg.shape) != (nb, d2, C) or kref.numel() != d2 * NL * NL
            or tuple(rowptr.shape) != (nb, W + 1)
            or tuple(ent.shape) != (nb, C * NL)
            or x_pad.numel() >= 2**31 or ent.numel() >= 2**31):
        raise ValueError("stiffness_windows: inconsistent layout shapes")
    out = torch.empty((nb, W), dtype=torch.float32, device=x_pad.device)
    with torch.cuda.device(x_pad.device):
        stream = torch.cuda.current_stream().cuda_stream
        WINSTIFF.launch(
            "winstiff_p1_2d", x_pad.data_ptr(), lidx.data_ptr(),
            valid.data_ptr(), cg.data_ptr(), kref.data_ptr(),
            rowptr.data_ptr(), ent.data_ptr(), out.data_ptr(),
            nb, S, W, C, stream,
        )
    return out


class WindowStiffnessOperator:
    """Scalar stiffness apply on the window layout of a P1 space (the
    pressure-Poisson and multigrid-level operator). Tables live in float32
    on `device` (default: the mesh's). apply(x) takes x [n] in the original
    numbering, in any float dtype, and returns K x in that dtype."""

    def __init__(self, space, S=None, device=None):
        self.space = space
        wl = build_window_layout(space, S=S)
        self.wl = wl
        self.device = space.mesh.device if device is None else _device(device)
        dim = assembly._dim(space)
        geom = assembly.geometry(space.mesh)
        cells = np.asarray(wl.cells, dtype=np.int64)
        cg = geom.C[cells]  # [nb, C, dim, dim]
        kref = assembly.ref_stiffness(space.degree, dim)
        nl = kref.shape[-1]

        def dev(a, dtype=torch.float32):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=self.device)

        # [nb, dim^2, C] with row dim*k+l
        self.Cg = dev(np.transpose(cg, (0, 2, 3, 1)).reshape(wl.nb, dim * dim, -1))
        # row (dim*k+l)*NL + i -> Kref[k, l, i, :]
        self.kref = dev(kref.reshape(dim * dim * nl, nl))
        self.lidx = dev(np.transpose(wl.lidx, (0, 2, 1)), torch.int32)
        self.valid = dev(wl.valid)
        self.perm = dev(wl.perm, torch.int64)
        self.inv = dev(wl.inv, torch.int64)
        self.scatter = None
        if self.device.type == "cuda":
            self.scatter = tuple(dev(a, torch.int32) for a in build_scatter_lists(wl))

    def windows(self, x_pad):
        """[nb*S + W] float32 permuted, padded input -> [nb, W] windows."""
        wl = self.wl
        return stiffness_windows(x_pad, self.lidx, self.valid, self.Cg,
                                 self.kref, wl.S, wl.W, self.scatter)

    def apply(self, x):
        wl = self.wl
        x_pad = x.new_zeros(wl.n_pad, dtype=torch.float32)
        x_pad[:wl.n] = x[self.perm]
        yw = wl.overlap_add(self.windows(x_pad))
        return yw[self.inv].to(x.dtype)
