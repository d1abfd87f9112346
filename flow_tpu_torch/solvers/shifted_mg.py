# Shift-parameterized P1 geometric multigrid for reaction-diffusion
# operators S(shift, c) = shift * M_lumped + c * kappa * K: the heat solve's
# preconditioner. Port of flow_tpu/solvers/shifted_mg.py.
#
# The shift is a call-time scalar: the Boussinesq driver rebuilds its Heat
# operator every Banach sweep with alpha = 1/dt changing between steps, and
# every shift-dependent quantity is algebraic:
#   * level apply:  c*kappa*K x + shift*(dM * x)   (lumped mass = diagonal)
#   * Jacobi diag:  c*kappa*dK + shift*dM
#   * Chebyshev interval: lambda_max(D_s^{-1} S) <= max(lambda_K, 1) for
#     every shift >= 0 (for SPD A, B with diagonals dA, dB,
#     x'(A+B)x <= max(lmax(dA^{-1}A), lmax(dB^{-1}B)) x'(dA+dB)x, and the
#     lumped mass is its own diagonal); lambda_K is power-iterated once;
#   * coarsest level: a dense solve of c*kappa*K0 + shift*diag(M0)
#     (torch.linalg, LU factors kept per (shift, c)).
# Works on 2-D and 3-D refine_uniform chains (fine vertices = [coarse vertices;
# coarse edge midpoints]) and preconditions P2 spaces through the exact
# P2(mesh_k) == P1(mesh_{k+1}) dof identification.
#
# Every level's stiffness apply sums its element contributions with
# fem/gathersum.GatherSum, and the restriction sums each coarse vertex's
# edge halves through a member table of its own: a fixed order, so a
# V-cycle repeats bitwise on the card (the JAX package restricts with a
# scatter-add).
from __future__ import annotations

import time

import numpy as np
import torch

from ..fem import assembly, dense
from ..fem.gathersum import GatherSum, member_table
from ..fem.spaces import FunctionSpace
from .chebyshev import power_iteration_lmax

__all__ = ["ShiftedP1Hierarchy"]


class _Level:
    pass


class ShiftedP1Hierarchy:
    """P1 hierarchy over `meshes` (coarse to fine, a refine_uniform chain)
    of S(shift, c) with the Dirichlet rows of bc_mask (on the finest level;
    coarser levels take its vertex rows), in the finest mesh's dtype and on
    its device.

    extra_diff (optional): per-level per-cell artificial diffusion [nc_l]
    added to kappa in every level operator, the streamline-upwind
    kappa_eff = kappa + |b| h / 2 that keeps the V-cycle a good
    preconditioner of convection-dominated heat operators. set_lmax(L, v)
    sets a level's Chebyshev bound (interop.load_hierarchy_lmax carries
    the JAX package's). setup_seconds: the host seconds of construction."""

    def __init__(
        self,
        meshes,
        bc_mask=None,
        kappa=1.0,
        smoother_degree=2,
        coarse_dense_max=3000,
        lmin_ratio=0.30,
        extra_diff=None,
    ):
        assert len(meshes) >= 1
        t0 = time.perf_counter()
        self.nlevels = len(meshes)
        self.kappa = float(kappa)
        self.smoother_degree = smoother_degree
        self.lmin_ratio = lmin_ratio
        self.dtype = dtype = meshes[-1].dtype
        self.device = device = torch.device(meshes[-1].device)

        def dev(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        masks = [None] * self.nlevels
        if bc_mask is not None:
            m = bc_mask.detach().cpu().numpy() if isinstance(bc_mask, torch.Tensor) \
                else np.asarray(bc_mask)
            masks[-1] = np.asarray(m, dtype=np.float64)
            for l in range(self.nlevels - 2, -1, -1):
                masks[l] = masks[l + 1][: meshes[l].n_points]

        self.levels = []
        for l, mesh in enumerate(meshes):
            L = _Level()
            L.space = space = FunctionSpace(mesh, 1)
            hgeom = assembly.geometry(mesh)
            L.n = mesh.n_points
            L.mask = None if masks[l] is None else dev(masks[l])
            L.free = None if L.mask is None else 1.0 - L.mask
            L.dM = dev(assembly.lumped_mass_diag(space, hgeom))
            # per-cell diffusion coefficient: kappa + artificial part
            kc = None
            if extra_diff is not None and extra_diff[l] is not None:
                kc = np.asarray(extra_diff[l]) / self.kappa + 1.0
            L.kcoeff = kc
            dK = dev(assembly.stiffness_diag(space, hgeom, coeff=kc))
            L.dK = torch.where(dK > 0, dK, torch.ones_like(dK))
            C = assembly.geometry_on(mesh, dtype, device).C
            L.C = C if kc is None else C * dev(kc)[:, None, None]
            L.cell_dofs = space.cell_dofs_on(device)
            L.gsum = GatherSum(space.cell_dofs_np, L.n, device)
            self.levels.append(L)
        self.Kref = dev(assembly.ref_stiffness(1, getattr(meshes[-1], "dim", 2)))

        for L in self.levels:
            # the shift-independent Chebyshev bound (module header)
            if L.mask is None:
                lK = power_iteration_lmax(lambda x, L=L: self.K_stiff(L, x), L.dK,
                                          L.n, dtype=dtype)
            else:

                def Kb(x, L=L):
                    return L.free * self.K_stiff(L, L.free * x) + L.mask * x

                lK = power_iteration_lmax(Kb, L.free * L.dK + L.mask, L.n,
                                          dtype=dtype)
            self.set_lmax(L, 1.05 * max(lK, 1.0))

        # transfers: fine vertex n_c + e is the midpoint of coarse edge e;
        # the restriction sums each coarse vertex's edge halves in the
        # order of a member table
        self.edges, self.restrict_tables = [], []
        for m in meshes[:-1]:
            e = m.edges_np.astype(np.int64)
            self.edges.append(torch.as_tensor(e, device=device))
            targets = np.concatenate([e[:, 0], e[:, 1]])
            self.restrict_tables.append(torch.as_tensor(
                member_table(targets, m.n_points), device=device))

        L0 = self.levels[0]
        assert L0.n <= coarse_dense_max, f"coarse level too big: {L0.n}"
        K0 = dense.scalar_dense(
            L0.space,
            assembly.stiffness_local(L0.space, assembly.geometry(meshes[0]),
                                     coeff=L0.kcoeff),
        )
        self.K0 = dev(K0)
        self.M0d = L0.dM
        self.mask0 = L0.mask
        self._coarse_lu = {}
        self.setup_seconds = time.perf_counter() - t0

    def set_lmax(self, L, lmax):
        """Set a level's Chebyshev upper bound (the power-iterated lambda_K
        times 1.05, at least 1.05)."""
        L.lmax = float(lmax)

    # -- level operators -----------------------------------------------------
    def K_stiff(self, L, x):
        """The level's (coefficient-weighted) P1 stiffness apply."""
        return L.gsum(torch.einsum("ekl,klij,ej->ei", L.C, self.Kref,
                                   x[L.cell_dofs]))

    def _S(self, L, x, shift, c):
        if L.mask is None:
            return (c * self.kappa) * self.K_stiff(L, x) + shift * (L.dM * x)
        xf = L.free * x
        return L.free * (
            (c * self.kappa) * self.K_stiff(L, xf) + shift * (L.dM * xf)
        ) + L.mask * x

    def _diag(self, L, shift, c):
        d = (c * self.kappa) * L.dK + shift * L.dM
        d = torch.where(d > 0, d, torch.ones_like(d))
        if L.mask is None:
            return d
        return L.free * d + L.mask

    # -- transfers -----------------------------------------------------------
    def prolong(self, l, xc):
        e = self.edges[l]
        mid = 0.5 * (xc[e[:, 0]] + xc[e[:, 1]])
        return torch.cat([xc, mid])

    def restrict(self, l, xf):
        nc = self.levels[l].n
        half = 0.5 * xf[nc:]
        halves = torch.cat([half, half, half.new_zeros(1)])
        return xf[:nc] + halves[self.restrict_tables[l]].sum(dim=1)

    # -- Chebyshev smoothing with the shift-independent interval -------------
    def _smooth(self, L, b, x, shift, c):
        diag = self._diag(L, shift, c)
        lmax_s = L.lmax
        lmin_s = self.lmin_ratio * L.lmax
        theta = 0.5 * (lmax_s + lmin_s)
        delta = 0.5 * (lmax_s - lmin_s)
        sigma = theta / delta
        rho = 1.0 / sigma
        r = b - self._S(L, x, shift, c)
        d = (r / diag) / theta
        x = x + d
        for _ in range(self.smoother_degree - 1):
            r = r - self._S(L, d, shift, c)
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = rho_new * rho * d + (2.0 * rho_new / delta) * (r / diag)
            x = x + d
            rho = rho_new
        return x

    def _coarse_solve(self, b, shift, c):
        key = (float(shift), float(c))
        lu = self._coarse_lu.get(key)
        if lu is None:
            S0 = (c * self.kappa) * self.K0 + shift * torch.diag(self.M0d)
            if self.mask0 is not None:
                m = self.mask0
                S0 = (1.0 - m)[:, None] * S0 * (1.0 - m)[None, :] + torch.diag(m)
            lu = torch.linalg.lu_factor(S0)
            self._coarse_lu[key] = lu
        return torch.linalg.lu_solve(*lu, b[:, None])[:, 0]

    # -- V-cycle --------------------------------------------------------------
    def v_cycle(self, b, shift, c=1.0):
        """One V(s, s) cycle on S(shift, c) x = b from a zero initial guess.
        Linear and SPD: valid as M in CG/GMRES."""
        shift = float(shift)
        bs = [None] * self.nlevels
        xs = [None] * self.nlevels
        bs[-1] = b
        for l in range(self.nlevels - 1, 0, -1):
            L = self.levels[l]
            x = self._smooth(L, bs[l], torch.zeros_like(bs[l]), shift, c)
            r = bs[l] - self._S(L, x, shift, c)
            xs[l] = x
            rc = self.restrict(l - 1, r)
            if self.levels[l - 1].mask is not None:
                rc = self.levels[l - 1].free * rc
            bs[l - 1] = rc

        xs[0] = self._coarse_solve(bs[0], shift, c)

        for l in range(1, self.nlevels):
            corr = self.prolong(l - 1, xs[l - 1])
            if self.levels[l].mask is not None:
                corr = self.levels[l].free * corr
            x = xs[l] + corr
            xs[l] = self._smooth(self.levels[l], bs[l], x, shift, c)
        return xs[-1]
