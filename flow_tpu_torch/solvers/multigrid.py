# Geometric multigrid for the P1 pressure-Poisson operator on a
# refine_uniform chain of triangle meshes. Port of
# flow_tpu/solvers/multigrid.py (P1Hierarchy).
#
# Fine vertices are [coarse vertices; coarse edge midpoints], so the
# prolongation is index arithmetic with no interpolation matrix. V-cycle
# with Chebyshev smoothing (Jacobi-scaled), a dense inverse on the coarsest
# level, and the constant-nullspace projection for the pure-Neumann system.
# Level operators: assembled padded-ELL (fem/ell.py), or, with
# winkernel=True, the window stiffness kernel (attic/winkernel.py) on every
# level of at least winkernel_min_dofs dofs. The window apply computes in
# float32 even in float64 runs; that is preconditioner-side only, as in the
# JAX package.
from __future__ import annotations

import numpy as np
import torch

from ..fem import assembly, dense
from ..fem.assembly import geometry
from ..fem.ell import ell_stiffness
from ..fem.spaces import FunctionSpace
from ..mesh3d import _device
from .chebyshev import power_iteration_lmax

__all__ = ["P1Hierarchy"]


class _Level:
    pass


class P1Hierarchy:
    """V-cycle preconditioner for K p = b on the finest mesh of a
    refine_uniform chain.

    meshes: list coarse -> fine, each `refine_uniform` of the previous.
    bc_mask: optional finest-level Dirichlet mask [n_fine] (1.0 on
    constrained dofs); if None the operator is treated as pure-Neumann and
    the constant nullspace is projected at every level. Tables live on
    `device` in `dtype` (defaults: the finest mesh's).
    fine_window: optional WindowStiffnessOperator of the finest mesh's P1
    space (the stepper's pressure operator), used as the finest level's
    operator when that level is a window level, instead of building the
    same layout and tables a second time.
    """

    def __init__(
        self,
        meshes,
        bc_mask=None,
        smoother_degree=2,
        coarse_dense_max=3000,
        lmin_ratio=0.30,
        winkernel=False,
        winkernel_min_dofs=20000,
        fine_window=None,
        device=None,
        dtype=None,
    ):
        assert len(meshes) >= 1
        self.nlevels = len(meshes)
        self.neumann = bc_mask is None
        self.lmin_ratio = lmin_ratio
        self.dtype = dtype = meshes[-1].dtype if dtype is None else dtype
        self.device = device = _device(meshes[-1].device if device is None
                                       else device)

        # restrict the fine bc mask down the hierarchy: coarse vertices are
        # the first n_coarse fine vertices
        masks = [None] * self.nlevels
        if bc_mask is not None:
            masks[-1] = torch.as_tensor(bc_mask, dtype=dtype, device=device)
            for l in range(self.nlevels - 2, -1, -1):
                masks[l] = masks[l + 1][: meshes[l].n_points]

        self.levels = []
        for l, mesh in enumerate(meshes):
            L = _Level()
            L.space = space = FunctionSpace(mesh, 1)
            geom = geometry(mesh)
            L.n = mesh.n_points
            L.mask = mask = masks[l]
            L.win = None
            if winkernel and L.n >= winkernel_min_dofs:
                from ..attic.winkernel import WindowStiffnessOperator

                if fine_window is not None and l == self.nlevels - 1:
                    if (fine_window.space.mesh is not mesh
                            or fine_window.space.degree != 1
                            or fine_window.device != device):
                        raise ValueError("P1Hierarchy: fine_window is not an "
                                         "operator of the finest P1 space on "
                                         f"{device}")
                    L.win = fine_window
                else:
                    L.win = WindowStiffnessOperator(space, device=device)
                base_apply = L.win.apply
            else:
                base_apply = ell_stiffness(space, geom, dtype=dtype,
                                           device=device).apply

            if mask is None:
                L.K = base_apply
            else:
                free = 1.0 - mask

                def K(x, base_apply=base_apply, free=free, mask=mask):
                    return free * base_apply(free * x) + mask * x

                L.K = K
            diag = assembly.stiffness_diag(space, geom)
            diag = torch.as_tensor(np.where(diag > 0, diag, 1.0), dtype=dtype,
                                   device=device)
            if mask is not None:
                diag = (1.0 - mask) * diag + mask
            L.diag = diag
            self.set_lmax(L, power_iteration_lmax(L.K, diag, L.n, dtype=dtype))
            self.levels.append(L)

        # prolongation data: fine edge midpoint dof n_coarse+e interpolates
        # the coarse edge (edges of the coarse mesh)
        self.edges = [
            torch.as_tensor(m.edges_np, dtype=torch.int64, device=device)
            for m in meshes[:-1]
        ]

        # coarsest solve: dense (pin the nullspace by a rank-1 shift if
        # Neumann)
        L0 = self.levels[0]
        assert L0.n <= coarse_dense_max, (
            f"coarsest level too big for dense solve: {L0.n}"
        )
        K0 = dense.scalar_dense(
            L0.space, assembly.stiffness_local(L0.space, geometry(meshes[0]))
        )
        if self.neumann:
            v = np.full(L0.n, 1.0 / np.sqrt(L0.n))
            K0 = K0 + np.outer(v, v)
        else:
            m0 = L0.mask.cpu().numpy() == 1.0
            K0[m0, :] = 0.0
            K0[:, m0] = 0.0
            K0[m0, m0] = 1.0
        self.K0_inv = torch.as_tensor(np.linalg.inv(K0), dtype=dtype, device=device)
        self.smoother_degree = smoother_degree

    def set_lmax(self, L, lmax):
        """Set a level's lambda_max estimate and the Chebyshev interval
        [lmin_ratio, 1.05] * lmax derived from it."""
        L.lmax = float(lmax)
        lmax_s, lmin_s = 1.05 * L.lmax, self.lmin_ratio * L.lmax
        L.theta = 0.5 * (lmax_s + lmin_s)
        L.delta = 0.5 * (lmax_s - lmin_s)

    # -- grid transfer -------------------------------------------------------
    def prolong(self, l, xc):
        """coarse level l -> fine level l+1."""
        e = self.edges[l]
        mid = 0.5 * (xc[e[:, 0]] + xc[e[:, 1]])
        return torch.cat([xc, mid])

    def restrict(self, l, xf):
        """fine level l+1 -> coarse level l (transpose of prolong)."""
        nc = self.levels[l].n
        e = self.edges[l]
        half = 0.5 * xf[nc:]
        xr = xf[:nc].clone()
        xr.index_add_(0, e[:, 0], half)
        xr.index_add_(0, e[:, 1], half)
        return xr

    # -- smoothing -----------------------------------------------------------
    def _smooth(self, L, b, x):
        """`smoother_degree` Chebyshev iterations on K x = b from initial x."""
        sigma = L.theta / L.delta
        rho = 1.0 / sigma
        r = b - L.K(x)
        d = (r / L.diag) / L.theta
        x = x + d
        for _ in range(self.smoother_degree - 1):
            r = r - L.K(d)
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = rho_new * rho * d + (2.0 * rho_new / L.delta) * (r / L.diag)
            x = x + d
            rho = rho_new
        return x

    @staticmethod
    def _project(x):
        return x - torch.mean(x)

    # -- V-cycle ---------------------------------------------------------------
    def v_cycle(self, b):
        """One V(smooth, smooth) cycle applied to b (zero initial guess).
        Linear and SPD: use as M in CG."""
        if self.neumann:
            b = self._project(b)
        bs = [None] * self.nlevels
        xs = [None] * self.nlevels
        bs[-1] = b
        # down-sweep
        for l in range(self.nlevels - 1, 0, -1):
            L = self.levels[l]
            x = self._smooth(L, bs[l], torch.zeros_like(bs[l]))
            r = bs[l] - L.K(x)
            if self.neumann:
                r = self._project(r)
            xs[l] = x
            rc = self.restrict(l - 1, r)
            if self.levels[l - 1].mask is not None:
                rc = (1.0 - self.levels[l - 1].mask) * rc
            bs[l - 1] = rc
        # coarse solve
        x0 = self.K0_inv @ bs[0]
        if self.neumann:
            x0 = self._project(x0)
        xs[0] = x0
        # up-sweep
        for l in range(1, self.nlevels):
            corr = self.prolong(l - 1, xs[l - 1])
            if self.levels[l].mask is not None:
                corr = (1.0 - self.levels[l].mask) * corr
            x = xs[l] + corr
            x = self._smooth(self.levels[l], bs[l], x)
            xs[l] = x
        out = xs[-1]
        if self.neumann:
            out = self._project(out)
        return out
