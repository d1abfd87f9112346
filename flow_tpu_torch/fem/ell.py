# Padded-ELL sparse operators for constant bilinear forms. Port of
# flow_tpu/fem/ell.py, cut to ell_from_local/ell_stiffness and the row-layout
# apply: the operator of every P1Hierarchy level below the window-kernel
# size. Assembly is host numpy (duplicate (row, col) pairs summed once);
# cols/vals move to the device once. The JAX package's "lane" layout works
# around the TPU's (8, 128) tile padding and is not carried over.
from __future__ import annotations

import numpy as np
import torch

from . import assembly
from .spaces import FunctionSpace

__all__ = ["ELLMatrix", "ell_from_local", "ell_stiffness"]


class ELLMatrix:
    """Static-shape padded ELL matrix: cols [n, K] int64, vals [n, K] on
    `device`. Padding entries have col=0, val=0 (they multiply row 0
    harmlessly). apply(x) takes x [n]."""

    def __init__(self, cols, vals, dtype, device):
        self.n, self.width = cols.shape
        self.cols = torch.as_tensor(cols, dtype=torch.int64, device=device)
        self.vals = torch.as_tensor(vals, dtype=dtype, device=device)

    def apply(self, x):
        return (self.vals * x[self.cols]).sum(dim=1)


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
    mesh = space.mesh
    return ELLMatrix(
        cols_pad, vals_pad,
        mesh.dtype if dtype is None else dtype,
        mesh.device if device is None else device,
    )


def ell_stiffness(space: FunctionSpace, geom, dtype=None, device=None):
    """Assembled stiffness K_ij = int grad(phi_i).grad(phi_j) as ELL
    (the values of assembly.stiffness_apply, exact factored tensors)."""
    return ell_from_local(
        space, assembly.stiffness_local(space, geom), dtype=dtype, device=device
    )
