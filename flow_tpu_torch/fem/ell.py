# Padded-ELL sparse operators for constant bilinear forms. Port of
# flow_tpu/fem/ell.py, cut to ell_from_local/ell_stiffness and the apply:
# the pressure operator of FastStepper's einsum route and the operator of
# every P1Hierarchy level the window kernels do not take. Assembly is host
# numpy (duplicate (row, col) pairs summed once); the tables move to the
# device once.
#
# On a CUDA device ELLMatrix.apply launches one of the two hand-written
# kernels of csrc/ell.cu, chosen once by shape at construction and recorded
# in ELLMatrix.kernel:
#   - "window" (P2 of the TPU probes): where the columns of every 128-row
#     block span a window that fits one block's shared memory in the
#     matrix's dtype, the block stages x[w0 : w0 + W] there and gathers
#     through block-local indices;
#   - "direct" (P1): elsewhere, one thread per row gathers x through L1/L2.
# Both read the column-major ("lane") copies [K, n] the matrix builds on
# the card, in which a warp's reads of one slot are coalesced (the JAX
# package's layout="lane", there a TPU tile-padding fix). A CPU tensor takes
# the plain version, ell_apply_plain. The wrappers count their launches in
# ELL_DIRECT.launches and ELL_WINDOW.launches.
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .._build import Kernel
from ..mesh3d import _device
from . import assembly
from .spaces import FunctionSpace

__all__ = ["ELLMatrix", "ell_from_local", "ell_stiffness", "ell_apply_plain",
           "ell_apply_window_plain", "ell_window_tables", "ELL_DIRECT",
           "ELL_WINDOW", "WINDOW_ROWS", "SMEM_BYTES"]

_P, _I = ctypes.c_void_p, ctypes.c_int
ELL_DIRECT = Kernel("ell", {"ell_direct_f32": [_P] * 4 + [_I] * 2 + [_P],
                            "ell_direct_f64": [_P] * 4 + [_I] * 2 + [_P]})
ELL_WINDOW = Kernel("ell", {"ell_window_f32": [_P] * 5 + [_I] * 3 + [_P],
                            "ell_window_f64": [_P] * 5 + [_I] * 3 + [_P]})
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

WINDOW_ROWS = 128  # rows of a window block (the probe's R)
WINDOW_ALIGN = 32  # window starts and widths, in elements
SMEM_BYTES = 232448  # shared memory one H100 block may opt in to (227 KB)


def ell_apply_plain(vals, cols, x):
    """y[r] = sum_k vals[r, k] x[cols[r, k]] on the row layout [n, K]."""
    return (vals * x[cols]).sum(dim=1)


def ell_window_tables(cols, valid=None, rows=WINDOW_ROWS, align=WINDOW_ALIGN):
    """Window tables of the row layout cols [n, K] (numpy), as
    scripts/onehot_window_probe.py builds them but aligned to `align`
    elements: per block of `rows` rows the window start w0 [nb] (the
    smallest column of its valid entries, rounded down), the block-local
    indices lidx [n, K] = cols - w0 (0 on padding entries) and the width W,
    the largest span max(cols) - w0 + 1 of a block rounded up to `align`."""
    cols = np.asarray(cols, dtype=np.int64)
    n, K = cols.shape
    valid = np.ones((n, K), dtype=bool) if valid is None else np.asarray(valid, bool)
    nb = -(-n // rows)
    pad = nb * rows - n
    vpad = np.concatenate([valid, np.zeros((pad, K), dtype=bool)])
    cpad = np.concatenate([cols, np.zeros((pad, K), dtype=np.int64)])
    lo = np.where(vpad, cpad, n).reshape(nb, rows * K).min(axis=1)
    hi = np.where(vpad, cpad, -1).reshape(nb, rows * K).max(axis=1)
    w0 = (lo // align) * align
    W = int(-(-int((hi - w0 + 1).max()) // align) * align)
    lidx = np.where(valid, cols - np.repeat(w0, rows)[:n, None], 0)
    return w0, lidx, W


def ell_apply_window_plain(vals, lidx, w0, x, W, rows=WINDOW_ROWS):
    """The windowed apply on the row layout: block b's window
    x[w0[b] : w0[b] + W] (zero past the end of x), gathered through the
    block-local indices lidx [n, K]."""
    n, K = lidx.shape
    nb = w0.shape[0]
    xpad = torch.cat([x, x.new_zeros(W)])
    win = xpad[w0.long()[:, None] + torch.arange(W, device=x.device)]  # [nb, W]
    lpad = torch.cat([lidx.long(), lidx.new_zeros((nb * rows - n, K)).long()])
    g = torch.gather(win, 1, lpad.view(nb, rows * K)).view(nb * rows, K)[:n]
    return (vals * g).sum(dim=1)


class ELLMatrix:
    """Static-shape padded ELL matrix: cols [n, K] int64 and vals [n, K] in
    `dtype` on `device` (default: the card). Padding entries have col=0,
    val=0 (they multiply x[0] harmlessly); valid [n, K] marks the real
    entries (default: all). apply(x) takes x [n] in `dtype`.

    kernel is "window" where every 128-row block's columns span a window of
    at most SMEM_BYTES in `dtype`, else "direct": the CUDA kernel that
    apply launches on the card. A window matrix holds its window tables
    (ell_window_tables) as w0 [nb] and lidx [n, K] int32 with the width W.
    On the card the matrix also holds the kernels' lane copies: vals_t
    [K, n], cols_t [K, n] int32 and, for the window kernel, lidx_t [K, n]."""

    def __init__(self, cols, vals, dtype, device=None, valid=None):
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals, dtype=np.float64)
        self.n, self.width = cols.shape
        self.dtype = dtype
        self.device = device = _device(device)
        self.cols = torch.as_tensor(cols, device=device)
        self.vals = torch.as_tensor(vals, dtype=dtype, device=device)
        w0, lidx, W = ell_window_tables(cols, valid)
        itemsize = torch.finfo(dtype).bits // 8
        self.kernel = "window" if W * itemsize <= SMEM_BYTES else "direct"
        self.W = W
        if self.kernel == "window":
            self.w0 = torch.as_tensor(w0, dtype=torch.int32, device=device)
            self.lidx = torch.as_tensor(lidx, dtype=torch.int32, device=device)
        if device.type == "cuda":
            if dtype not in _SUFFIX:
                raise TypeError(f"ELLMatrix: the kernels take float32 and float64, "
                                f"not {dtype}")
            if self.n * self.width >= 2**31:
                raise ValueError("ELLMatrix: too many entries for int32 indices")

            def lane(a, t):
                return torch.as_tensor(np.ascontiguousarray(a.T), dtype=t,
                                       device=device)

            self.vals_t = lane(vals, dtype)
            self.cols_t = lane(cols, torch.int32)
            if self.kernel == "window":
                self.lidx_t = lane(lidx, torch.int32)

    def _check(self, x):
        if x.device != self.vals.device:
            raise ValueError(f"ELLMatrix.apply: x on {x.device}, the matrix on "
                             f"{self.vals.device}")
        if x.dtype != self.dtype or tuple(x.shape) != (self.n,):
            raise ValueError(f"ELLMatrix.apply: want x [{self.n}] in {self.dtype}, "
                             f"got {tuple(x.shape)} in {x.dtype}")
        return x.contiguous()

    def apply(self, x):
        """y = A x: the plain version for a CPU tensor, else the matrix's
        kernel."""
        if x.device.type == "cpu" and self.device.type == "cpu":
            return ell_apply_plain(self.vals, self.cols, x)
        if self.kernel == "window":
            return self.apply_window(x)
        return self.apply_direct(x)

    def apply_direct(self, x):
        """y = A x through the direct kernel (P1) on the card; the plain
        version for a CPU tensor."""
        if x.device.type == "cpu" and self.device.type == "cpu":
            return ell_apply_plain(self.vals, self.cols, x)
        if x.device.type != "cuda":
            raise ValueError(f"ELLMatrix.apply: no kernel for device {x.device}")
        x = self._check(x)
        y = torch.empty_like(x)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            ELL_DIRECT.launch(f"ell_direct_{_SUFFIX[self.dtype]}",
                              self.vals_t.data_ptr(), self.cols_t.data_ptr(),
                              x.data_ptr(), y.data_ptr(), self.n, self.width, stream)
        return y

    def apply_window(self, x):
        """y = A x through the windowed kernel (P2) on the card, for a matrix
        whose kernel is "window"; the plain windowed version for a CPU
        tensor."""
        if self.kernel != "window":
            raise ValueError(f"ELLMatrix: a window of {self.W} values does not fit "
                             f"shared memory in {self.dtype}")
        if x.device.type == "cpu" and self.device.type == "cpu":
            return ell_apply_window_plain(self.vals, self.lidx, self.w0, x, self.W)
        if x.device.type != "cuda":
            raise ValueError(f"ELLMatrix.apply: no kernel for device {x.device}")
        x = self._check(x)
        y = torch.empty_like(x)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            ELL_WINDOW.launch(f"ell_window_{_SUFFIX[self.dtype]}",
                              self.vals_t.data_ptr(), self.lidx_t.data_ptr(),
                              self.w0.data_ptr(), x.data_ptr(), y.data_ptr(),
                              self.n, self.width, self.W, stream)
        return y

    def __call__(self, x):
        return self.apply(x)


def ell_from_local(space: FunctionSpace, loc, dtype=None, device=None):
    """Assemble element matrices loc [nc, nl, nl] into an ELLMatrix in
    `dtype` on `device` (defaults: the mesh's); rows padded to the max row
    valence."""
    loc = np.asarray(loc, dtype=np.float64)
    cd = space.cell_dofs_np.astype(np.int64)
    nl = cd.shape[1]
    n = space.n_dofs
    rows = np.repeat(cd, nl, axis=1).ravel()
    cols = np.tile(cd, (1, nl)).ravel()
    vals = loc.reshape(len(cd), nl * nl).ravel()

    key = rows * n + cols
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    uniq, start = np.unique(key_s, return_index=True)
    sums = np.add.reduceat(vals[order], start)
    r = uniq // n
    c = uniq % n

    counts = np.bincount(r, minlength=n)
    width = int(counts.max())
    pos = np.arange(len(r)) - np.concatenate([[0], np.cumsum(counts)])[r]
    cols_pad = np.zeros((n, width), dtype=np.int64)
    vals_pad = np.zeros((n, width), dtype=np.float64)
    cols_pad[r, pos] = c
    vals_pad[r, pos] = sums
    valid = np.arange(width)[None, :] < counts[:, None]
    mesh = space.mesh
    return ELLMatrix(
        cols_pad, vals_pad,
        mesh.dtype if dtype is None else dtype,
        mesh.device if device is None else device,
        valid=valid,
    )


def ell_stiffness(space: FunctionSpace, geom, coeff=None, dtype=None, device=None):
    """Assembled stiffness K_ij = int c grad(phi_i).grad(phi_j) as ELL (the
    values of assembly.stiffness_apply, exact factored tensors); coeff: a
    constant or per-cell [nc] factor c (default 1)."""
    return ell_from_local(
        space, assembly.stiffness_local(space, geom, coeff=coeff), dtype=dtype,
        device=device,
    )
