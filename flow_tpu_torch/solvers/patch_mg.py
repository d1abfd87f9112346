# Geometric multigrid for the pressure Poisson operator in the patch layout
# (fem/patch.py): the twin of solvers/multigrid.P1Hierarchy for
# FastStepper(patches=...). Port of flow_tpu/solvers/patch_mg.py.
#
# Level l is P1 on the same coarse patches with lattice 2^l:
#   * level operators: the factored stiffness apply through PatchSpace
#     (window slices and overlap-adds; seams only on O(C n) rows);
#   * prolongation: the lattice interleave (coarse nodes copied, edge
#     midpoints averaged along rows, columns and diagonals), pure slices;
#   * restriction: its exact adjoint (replica-weight split, the transposed
#     interleave, the coarse seam sum);
#   * the coarsest solve: a dense inverse on the real coarse mesh, entered
#     and left through its representative slots.
# Chebyshev smoothing, the lambda_max estimates, the Neumann nullspace and
# the BC masks follow P1Hierarchy, so the two preconditioners interchange.
from __future__ import annotations

import numpy as np
import torch

from ..fem import assembly, dense
from ..fem.patch import PatchGeom, PatchSpace
from ..fem.spaces import FunctionSpace
from .chebyshev import power_iteration_lmax

__all__ = ["PatchP1Hierarchy"]


class _Level:
    pass


class PatchP1Hierarchy:
    """V-cycle preconditioner over the patch lattice ladder of `info`.

    bc_mask: the finest level's Dirichlet mask in the patch layout (1 on
    constrained slots, the padding slots included, as
    PatchNSContext.mask_to_patch makes it), or None for the pure-Neumann
    operator. Tables in `dtype` on `device` (defaults: the finest mesh's)."""

    def __init__(self, info, bc_mask=None, smoother_degree=3,
                 coarse_dense_max=3000, lmin_ratio=0.30, dtype=None, device=None):
        fine = info.meshes[-1]
        self.dtype = dtype = fine.dtype if dtype is None else dtype
        self.device = device = fine.device if device is None else torch.device(device)
        self.info = info
        self.nlevels = info.k + 1
        self.neumann = bc_mask is None
        self.smoother_degree = smoother_degree
        self.lmin_ratio = lmin_ratio

        self.levels = []
        for l in range(self.nlevels):
            L = _Level()
            L.space = PatchSpace(info.layout(1, l), info.meshes[l], 1, dtype=dtype,
                                 device=device)
            L.geom = PatchGeom(info, level=l).on(dtype, device)
            L.n = L.space.n_dofs
            self.levels.append(L)

        # the fine mask down the ladder: the coarse lattice is the even fine
        # lattice (padding slots coarsen onto padding slots)
        masks = [None] * self.nlevels
        if bc_mask is not None:
            masks[-1] = torch.as_tensor(bc_mask, dtype=dtype, device=device)
            for l in range(self.nlevels - 2, -1, -1):
                masks[l] = self._flat(l, self._planes(l + 1, masks[l + 1])[:, ::2, ::2])

        Kd = torch.as_tensor(np.einsum("klii->kli", assembly.ref_stiffness(1, 2)),
                             dtype=dtype, device=device)
        for l, L in enumerate(self.levels):
            L.mask = mask = masks[l]
            space, geom = L.space, L.geom

            def base(x, space=space, geom=geom):
                return assembly.stiffness_apply(space, geom, x)

            if mask is None:
                L.K = base
            else:
                def K(x, base=base, free=1.0 - mask, mask=mask):
                    return free * base(free * x) + mask * x

                L.K = K
            diag = space.dof_sum(torch.einsum("ekl,kli->ei", geom.C, Kd))
            diag = torch.where(diag > 0, diag, torch.ones_like(diag))
            if mask is not None:
                diag = (1.0 - mask) * diag + mask
            L.diag = diag
            self.set_lmax(L, power_iteration_lmax(L.K, diag, L.n, dtype=dtype))

        # the coarsest solve: dense on the real coarse mesh
        mesh0 = info.meshes[0]
        S0 = FunctionSpace(mesh0, 1)
        n0 = mesh0.n_points
        assert n0 <= coarse_dense_max, f"coarse level too big: {n0}"
        K0 = dense.scalar_dense(S0, assembly.stiffness_local(S0, assembly.geometry(mesh0)))
        L0 = self.levels[0]
        if self.neumann:
            v = np.full(n0, 1.0 / np.sqrt(n0))
            K0 = K0 + np.outer(v, v)
        else:
            m0 = L0.space.from_patch(L0.mask).cpu().numpy() == 1.0
            K0[m0, :] = 0.0
            K0[:, m0] = 0.0
            K0[m0, m0] = 1.0
        self.K0_inv = torch.as_tensor(np.linalg.inv(K0), dtype=dtype, device=device)

    def set_lmax(self, L, lmax):
        """A level's lambda_max and the Chebyshev interval
        [lmin_ratio, 1.05] * lmax derived from it."""
        L.lmax = float(lmax)
        lmax_s, lmin_s = 1.05 * L.lmax, self.lmin_ratio * L.lmax
        L.theta = 0.5 * (lmax_s + lmin_s)
        L.delta = 0.5 * (lmax_s - lmin_s)

    # -- single-plane P1 layouts ------------------------------------------------
    def _planes(self, l, x):
        return self.levels[l].space._unflatten(x)[0]

    def _flat(self, l, plane):
        return self.levels[l].space._flatten([plane])

    # -- grid transfer ------------------------------------------------------------
    def prolong(self, l, xc):
        """Level l -> l+1: P1 interpolation on the lattice (even nodes
        copied, row, column and diagonal midpoints averaged)."""
        Xc = self._planes(l, xc)
        C, mc, _ = Xc.shape
        mf = 2 * mc - 1
        mid = 0.5 * (Xc[:, :, :-1] + Xc[:, :, 1:])
        Y = torch.cat([torch.stack([Xc[:, :, :-1], mid], dim=3).reshape(C, mc, 2 * (mc - 1)),
                       Xc[:, :, -1:]], dim=2)  # even rows [C, mc, mf]
        colmid_e = 0.5 * (Xc[:, :-1, :] + Xc[:, 1:, :])
        colmid_o = 0.5 * (Xc[:, 1:, :-1] + Xc[:, :-1, 1:])  # diagonal mids
        R = torch.cat([torch.stack([colmid_e[:, :, :-1], colmid_o], dim=3)
                       .reshape(C, mc - 1, 2 * (mc - 1)),
                       colmid_e[:, :, -1:]], dim=2)  # odd rows [C, mc-1, mf]
        out = torch.cat([torch.stack([Y[:, :-1, :], R], dim=2).reshape(C, 2 * (mc - 1), mf),
                         Y[:, -1:, :]], dim=1)
        return self._flat(l + 1, out)

    def restrict(self, l, rf):
        """Level l+1 -> l: the exact transpose of prolong on the replicated
        layout (the fine dual split by the replica weights, the transposed
        interleave, the coarse seam sum)."""
        spf = self.levels[l + 1].space
        Rf = self._planes(l + 1, spf._weight * rf)
        E = Rf[:, ::2, ::2]
        H = Rf[:, 1::2, ::2]  # horizontal mids [C, mc-1, mc]
        Vm = Rf[:, ::2, 1::2]  # vertical mids [C, mc, mc-1]
        D = Rf[:, 1::2, 1::2]  # diagonal mids [C, mc-1, mc-1]
        out = E.clone()
        out[:, :-1, :] += 0.5 * H
        out[:, 1:, :] += 0.5 * H
        out[:, :, :-1] += 0.5 * Vm
        out[:, :, 1:] += 0.5 * Vm
        out[:, 1:, :-1] += 0.5 * D
        out[:, :-1, 1:] += 0.5 * D
        return self.levels[l].space.seam_sum(self._flat(l, out))

    # -- smoothing / projection ---------------------------------------------------
    def _smooth(self, L, b, x):
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

    def _project(self, l, x):
        sp = self.levels[l].space
        w = sp._weight
        return (x - torch.sum(w * x) / torch.sum(w)) * sp._validf

    def v_cycle(self, b):
        """One V(s, s) cycle from a zero guess: linear, SPD on the
        consistent subspace (M of a weighted-dot CG)."""
        if self.neumann:
            b = self._project(self.nlevels - 1, b)
        bs = [None] * self.nlevels
        xs = [None] * self.nlevels
        bs[-1] = b
        for l in range(self.nlevels - 1, 0, -1):
            L = self.levels[l]
            x = self._smooth(L, bs[l], torch.zeros_like(bs[l]))
            r = bs[l] - L.K(x)
            if self.neumann:
                r = self._project(l, r)
            xs[l] = x
            rc = self.restrict(l - 1, r)
            if self.levels[l - 1].mask is not None:
                rc = (1.0 - self.levels[l - 1].mask) * rc
            bs[l - 1] = rc
        L0 = self.levels[0]
        x0 = L0.space.to_patch(self.K0_inv @ L0.space.from_patch(bs[0]))
        if self.neumann:
            x0 = self._project(0, x0)
        xs[0] = x0
        for l in range(1, self.nlevels):
            corr = self.prolong(l - 1, xs[l - 1])
            if self.levels[l].mask is not None:
                corr = (1.0 - self.levels[l].mask) * corr
            xs[l] = self._smooth(self.levels[l], bs[l], xs[l] + corr)
        out = xs[-1]
        if self.neumann:
            out = self._project(self.nlevels - 1, out)
        # the range stays in the valid subspace (padding slots exactly 0)
        return out * self.levels[-1].space._validf
