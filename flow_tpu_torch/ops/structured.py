# Structured-grid P1 Laplacian. Port of flow_tpu/ops/structured.py.
#
# On a uniform rectangle ('left'/'right' diagonal) or box mesh the P1
# stiffness operator is translation-invariant in the interior, so its action
# is a 3x3 (2-D) or 3x3x3 (3-D) stencil plus an O(surface) correction on the
# grid-boundary vertices, whose assembled rows differ from the interior
# stencil. The stencil runs through ops/stencil.py: the CUDA kernels (K2 in
# 2-D, K1 in 3-D) for every grid size on the card, through a StencilLaunch
# fixed at construction, and the plain version on the CPU.
from __future__ import annotations

import numpy as np
import torch

from ..fem import assembly
from ..fem.assembly import geometry
from ..fem.spaces import FunctionSpace
from ..mesh3d import _device
from .stencil import StencilLaunch, stencil_apply_2d, stencil_apply_3d

__all__ = ["supports", "StructuredLaplacian"]


def supports(mesh):
    return hasattr(mesh, "grid_shape")


def _interior_kernel(mesh):
    """Extract the interior stencil by probing a small same-spacing mesh
    (a 'right' rectangle in 2-D, as the JAX package does for either
    diagonal)."""
    dim = getattr(mesh, "dim", 2)
    sp = mesh.grid_spacing
    # host-only probe: its arrays never leave numpy
    if dim == 2:
        from ..mesh import rectangle_mesh

        probe = rectangle_mesh((0, 0), (6 * sp[0], 6 * sp[1]), 6, 6,
                               diagonal="right", device="cpu")
    else:
        from ..mesh3d import box_mesh

        probe = box_mesh((0, 0, 0), (6 * sp[0], 6 * sp[1], 6 * sp[2]), 6, 6, 6,
                         device="cpu")
    shape = (7,) * dim
    S = FunctionSpace(probe, 1)
    e = np.zeros(S.n_dofs)
    e[np.ravel_multi_index((3,) * dim, shape)] = 1.0
    y = assembly.stiffness_apply(S, geometry(probe), e)
    return y.reshape(shape)[(slice(2, 5),) * dim].copy()


class StructuredLaplacian:
    """y = K_stiffness x on a uniform structured rectangle or box mesh, as
    stencil + boundary correction: the P1 stiffness apply on the mesh's
    vertex grid.
    Tables live on `device` (default: the mesh's) in `dtype` (default: the
    mesh's). On the card the stencil's launch is fixed at construction
    (ops/stencil.StencilLaunch, on self.kernel), so that a call checks only
    x."""

    def __init__(self, mesh, device=None, dtype=None):
        assert supports(mesh)
        self.mesh = mesh
        self.dim = getattr(mesh, "dim", 2)
        self.grid = tuple(mesh.grid_shape)
        self.dtype = mesh.dtype if dtype is None else dtype
        self.device = _device(mesh.device if device is None else device)
        n = int(np.prod(self.grid))

        Kst = _interior_kernel(mesh)  # [3,3(,3)]
        self.kernel = torch.as_tensor(Kst, dtype=self.dtype, device=self.device)
        self.launch = (StencilLaunch(self.kernel, self.grid)
                       if self.device.type == "cuda" else None)

        # ---- boundary correction (host setup) ------------------------------
        S = FunctionSpace(mesh, 1)
        geom = geometry(mesh)
        grid = self.grid
        coords = np.stack(
            np.unravel_index(np.arange(n), grid), axis=1
        )  # [n, dim]
        on_bnd = np.zeros(n, dtype=bool)
        for d in range(self.dim):
            on_bnd |= (coords[:, d] == 0) | (coords[:, d] == grid[d] - 1)
        bverts = np.where(on_bnd)[0]
        bpos = -np.ones(n, dtype=np.int64)
        bpos[bverts] = np.arange(len(bverts))

        # assemble the true rows of boundary vertices from element matrices
        cd = S.cell_dofs_np
        touch = on_bnd[cd].any(axis=1)
        ct = np.where(touch)[0]
        K_loc_sub = np.einsum(
            "ekl,klij->eij", geom.C[ct], assembly.ref_stiffness(1, self.dim)
        )
        nl = cd.shape[1]
        r = np.repeat(cd[ct], nl, axis=1).ravel()
        c = np.tile(cd[ct], (1, nl)).ravel()
        v = K_loc_sub.reshape(-1)
        sel = on_bnd[r]
        r, c, v = r[sel], c[sel], v[sel]
        # combine duplicates
        key = r.astype(np.int64) * n + c
        uk, inv = np.unique(key, return_inverse=True)
        vals = np.zeros(len(uk))
        np.add.at(vals, inv, v)
        ru = uk // n
        cu = uk % n

        # subtract the stencil contribution K[offset] and build gather tables
        S_stencil = 3**self.dim
        off = coords[cu] - coords[ru] + 1  # in [0, 2]
        koff = np.ravel_multi_index(off.T, (3,) * self.dim)
        dvals = vals - Kst.reshape(-1)[koff]

        nb = len(bverts)
        tbl_idx = np.zeros((nb, S_stencil), dtype=np.int64)
        tbl_val = np.zeros((nb, S_stencil))
        tbl_idx[bpos[ru], koff] = cu
        tbl_val[bpos[ru], koff] = dvals

        self.bverts = torch.as_tensor(bverts, device=self.device)
        self.tbl_idx = torch.as_tensor(tbl_idx, device=self.device)
        self.tbl_val = torch.as_tensor(tbl_val, dtype=self.dtype, device=self.device)
        self.n = n

    def __call__(self, x):
        if self.launch is not None:
            y = self.launch(x)
        else:
            xg = x.reshape(self.grid).contiguous()
            apply = stencil_apply_3d if self.dim == 3 else stencil_apply_2d
            y = apply(xg, self.kernel).reshape(self.n)
        corr = torch.sum(self.tbl_val * x[self.tbl_idx], dim=1)
        # bverts are unique, so index_add_ is deterministic; y is a fresh
        # buffer owned by this call, updated in place
        return y.index_add_(0, self.bverts, corr)
