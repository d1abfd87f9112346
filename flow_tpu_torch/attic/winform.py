# Window-blocked apply of a compiled element matrix (formlang -> window
# kernel): the hand-written CUDA kernel (csrc/winform.cu) that replaces the
# Pallas kernel flow_tpu/attic/winform.py::WindowElementOperator._pallas
# (K5), and its plain PyTorch version.
#
# fem/formlang.py compiles any scalar bilinear form to a per-cell element
# matrix loc[e, i, j] (CompiledForm.local()). window_operator(form) applies
# the same discrete operator on the window layout of attic/window.py; the
# element matrix is a kernel input, re-blocked per step by set_matrix
# without rebuilding the layout. It costs NL^2 floats per cell (36 for P2
# triangles, 100 for P2 tets): the trade for coefficient-bearing forms
# (convection-diffusion, SUPG-stabilised heat) whose quadrature chains would
# otherwise be recomputed every matvec. Like the JAX package, the apply
# computes in float32 whatever the caller's dtype and casts at the boundary.
#
# element_windows launches the kernel for CUDA tensors and takes the plain
# version only for CPU tensors: thread-block clusters that stage the local
# results at their scatter-list positions in shared memory (K4a's launch,
# attic/winkernel.cluster_launch). It counts its launches in
# WINFORM.launches.
from __future__ import annotations

import ctypes
import time

import numpy as np
import torch

from .._build import Kernel
from ..mesh3d import _device
from .window import build_window_layout, position_lists
from .winkernel import (WINDOW_NL, check_window_args, cluster_launch,
                        gather_windows_plain, scatter_windows_plain)

__all__ = ["WindowElementOperator", "window_operator", "element_windows",
           "element_windows_plain", "WINFORM"]

_P, _I = ctypes.c_void_p, ctypes.c_int
WINFORM = Kernel("winform", {
    "winform": [_P] * 7 + [_I] * 9 + [_P],
    "winform_clusters": [_I] * 4 + [_P],
})


def element_windows_plain(x_pad, lidx, valid, aloc, S, W):
    """Per-block output windows [nb, W] of the element-matrix apply.

    x_pad [nb*S + W] float32 (permuted, zero padded); lidx [nb, NL, C]
    int32; valid [nb, C]; aloc [nb, NL*NL, C] with row i*NL + j = A[c, i, j]."""
    nb, NL, C = lidx.shape
    u = gather_windows_plain(x_pad, lidx, S)  # [nb, NL, C]
    loc = torch.einsum("bijc,bjc->bic", aloc.view(nb, NL, NL, C), u) * valid[:, None, :]
    return scatter_windows_plain(loc, lidx, W)


def element_windows(x_pad, lidx, valid, aloc, S, W, positions=None):
    """Per-block output windows [nb, W] of the element-matrix apply (see
    element_windows_plain). CPU tensors take the plain version; CUDA tensors
    launch the kernel (csrc/winform.cu), which reads `positions` =
    (rowptr, pos) tensors, pos the inverse of the layout's scatter lists
    (window.position_lists): each cell stores its local results at their
    list positions in the shared memory of a cluster of blocks
    (winkernel.cluster_launch), in passes where they exceed it, and each
    row sums its positions in order."""
    if x_pad.device.type == "cpu":
        return element_windows_plain(x_pad, lidx, valid, aloc, S, W)
    if x_pad.device.type != "cuda":
        raise ValueError(f"element_windows: no kernel for device {x_pad.device}")
    nb, NL, C = lidx.shape
    if NL not in WINDOW_NL:
        raise ValueError(f"element_windows: the kernel takes NL in {WINDOW_NL}, got {NL}")
    check_window_args("element_windows", x_pad, lidx, valid, (aloc,), positions, S, W)
    if tuple(aloc.shape) != (nb, NL * NL, C):
        raise ValueError("element_windows: inconsistent layout shapes")
    rowptr, pos = positions
    out = torch.empty((nb, W), dtype=torch.float32, device=x_pad.device)
    plan = cluster_launch(WINFORM, nb, C, NL, x_pad.device)
    with torch.cuda.device(x_pad.device):
        stream = torch.cuda.current_stream().cuda_stream
        WINFORM.launch("winform", x_pad.data_ptr(), lidx.data_ptr(), valid.data_ptr(),
                       aloc.data_ptr(), rowptr.data_ptr(), pos.data_ptr(),
                       out.data_ptr(), nb, S, W, C, NL, plan.clusters, plan.cl,
                       plan.threads, plan.cap, stream)
    return out


class WindowElementOperator:
    """Apply of a per-cell element matrix loc [nc, NL, NL] on the window
    layout of a scalar P1 or P2 space on triangles or tets: y = A x with A
    the assembled operator. Tables live on `device` (default: the mesh's);
    the blocked matrix in float32. apply(x) takes x [n] in the original
    numbering, in any float dtype, and returns A x in that dtype. On the
    card the operator holds the lists its kernel reads, `positions` (see
    element_windows). layout_seconds: the host seconds of the layout, its
    tables and lists."""

    def __init__(self, space, loc=None, S=None, device=None):
        self.space = space
        t0 = time.perf_counter()
        wl = build_window_layout(space, S=S)
        self.wl = wl
        self.device = space.mesh.device if device is None else _device(device)

        def dev(a, dtype=torch.int32):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=self.device)

        self.lidx = dev(np.transpose(wl.lidx, (0, 2, 1)))
        self.valid = dev(wl.valid, torch.float32)
        self.perm = dev(wl.perm, torch.int64)
        self.inv = dev(wl.inv, torch.int64)
        self.nl = int(wl.lidx.shape[2])
        self._cells = dev(wl.cells, torch.int64)
        self.positions = None
        if self.device.type == "cuda":
            self.positions = tuple(dev(a) for a in position_lists(wl))
        self.layout_seconds = time.perf_counter() - t0
        self.aloc = None if loc is None else self.block_matrix(loc)

    def block_matrix(self, loc):
        """loc [nc, NL, NL] element matrices (array or tensor) -> blocked
        [nb, NL*NL, C] float32 kernel input (row i*NL + j), contiguous."""
        nl = self.nl
        lb = torch.as_tensor(loc, dtype=torch.float32, device=self.device)[self._cells]
        return lb.permute(0, 2, 3, 1).reshape(self.wl.nb, nl * nl, -1).contiguous()

    def set_matrix(self, loc):
        self.aloc = self.block_matrix(loc)

    def windows(self, x_pad):
        """[nb*S + W] float32 permuted, padded input -> [nb, W] windows."""
        assert self.aloc is not None, "no element matrix: call set_matrix first"
        wl = self.wl
        return element_windows(x_pad, self.lidx, self.valid, self.aloc, wl.S, wl.W,
                               self.positions)

    def apply(self, x):
        wl = self.wl
        x_pad = x.new_zeros(wl.n_pad, dtype=torch.float32)
        x_pad[:wl.n] = x[self.perm]
        yw = wl.overlap_add(self.windows(x_pad))
        return yw[self.inv].to(x.dtype)


def window_operator(form, S=None):
    """CompiledForm (scalar bilinear, same test/trial space) -> the
    WindowElementOperator applying the same discrete operator."""
    assert form.space_j is not None and form.axes == "", (
        "window_operator covers scalar bilinear forms; vector-coupled "
        "forms use the dedicated momentum kernel (attic/winmom.py)"
    )
    assert form.space_i is form.space_j, "test/trial space must match"
    return WindowElementOperator(form.space_i, loc=form.local(), S=S)
