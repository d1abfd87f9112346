# The momentum residual and the setup tables of the pressure-correction
# (projection) step on a P2/P1 pair, on triangles or tets. Port of the
# pieces of flow_tpu/navier_stokes/pressure_correction.py::_Context that the
# window and einsum routes of navier_stokes/fast.py read: the theta-weighted
# residual (Newton or with a lagged transport), its boundary (ds) terms, the
# pressure solve without a preconditioner, the velocity correction on the
# consistent mass, the Jacobi diagonals and the boundary tabulations
# (BoundaryTab on edges in 2-D, BoundaryFaceTab on faces in 3-D). The
# Chorin/IPCS/Rotational scheme drivers are not ported.
#
# The residual of the tentative velocity, theta = (w_ex, w_im):
#   F1(ui) = (ui - u0, v) - dt/rho * [w_ex rhs_weak(u0, v; p0, u0)
#                                     + w_im rhs_weak(ui, v; p0, T)]
# with rhs_weak the skew-symmetric convection transported by T (T = ui:
# the full nonlinearity), the stress form 2 mu eps(u):eps(v) - p0 div(v),
# and the ds-terms -p0 n.v + mu (grad u)^T n . v - 0.5 rho (T.n)+ u.v
# (directional do-nothing).
from __future__ import annotations

import numpy as np
import torch

from ..fem import assembly, forms
from ..fem.assembly import BoundaryFaceTab, BoundaryTab, geometry_on
from ..solvers import krylov

__all__ = ["NSContext", "CONV_RULE"]

CONV_RULE = assembly.CONV_RULE


class NSContext:
    """Per-(V, Q) tables of the projection step, in `dtype` on `device`."""

    def __init__(self, V, Q, dtype, device):
        self.V, self.Q = V, Q
        mesh = V.mesh
        self.dtype, self.device = dtype, device
        self.geom = geometry_on(mesh, dtype, device)
        Tab = BoundaryTab if getattr(mesh, "dim", 2) == 2 else BoundaryFaceTab
        self.btab = Tab(V, rule_degree=6, dtype=dtype, device=device)
        self.btabQ = Tab(Q, rule_degree=6, dtype=dtype, device=device)
        hgeom = assembly.geometry(mesh)
        ncomp = V.n_components

        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=device)

        # diagonals for Jacobi preconditioning
        self.mass_diag_V = dev(np.repeat(assembly.mass_diag(V, hgeom)[:, None],
                                         ncomp, axis=1))
        self.stiff_diag_V = dev(np.repeat(
            assembly.stiffness_diag(V, hgeom)[:, None], ncomp, axis=1))
        self.stiff_diag_Q = dev(assembly.stiffness_diag(Q, hgeom))
        self.ones_Q = torch.ones(Q.n_dofs, dtype=dtype, device=device)

    def _rhs_weak_loc(self, Wloc, rho, mu, Ploc, Tloc):
        """Local (pre-dof-sum) rhs_weak volume contributions [nc, nl, m]
        with the convection transported by Tloc."""
        V, Q, geom = self.V, self.Q, self.geom
        loc = -rho * forms.skew_convection_lagged_loc(
            V, geom, Tloc, Wloc, rule_degree=CONV_RULE
        )
        loc = loc - forms.sym_grad_loc(V, geom, Wloc, mu)
        return loc + forms.pressure_grad_loc(V, Q, geom, Ploc)

    def _rhs_weak_bnd(self, W, P0, rho, mu, T):
        """Boundary (ds) contributions of rhs_weak at the dof level, with T
        the transport of the directional do-nothing term."""
        bt = self.btab
        p0b = self.btabQ.values(P0)
        val = -p0b[:, :, None] * bt.normals[:, None, :]
        # + mu (grad u)^T n: out_a = sum_m du_m/dx_a n_m
        gw = bt.grads(W)  # [b,q,a,d] = du_a/dx_d
        val = val + mu * torch.einsum("bqma,bm->bqa", gw, bt.normals)
        # directional do-nothing (Braack & Mucha): restore the skew form's
        # dropped flux 0.5 (w.n)(w.v) ds where the flow leaves
        wb = bt.values(W)  # [b,q,m]
        tn = torch.einsum("bqm,bm->bq", bt.values(T), bt.normals)
        val = val - 0.5 * rho * torch.clamp(tn, min=0.0)[:, :, None] * wb
        return bt.integrate_rhs(val)

    def residual(self, Ui, U0, P0, rho, mu, dt, theta=(0.0, 1.0),
                 transport=None):
        """F1(ui) with the theta weights (w_ex, w_im), one gather per field
        and one dof sum. The explicit terms transport with u0; the implicit
        ones with `transport`, or with ui itself when it is None (the
        Newton residual)."""
        V, Q = self.V, self.Q
        w_ex, w_im = theta
        Uiloc = V.gather(Ui)
        U0loc = V.gather(U0)
        Ploc = Q.gather(P0)
        Tloc = Uiloc if transport is None else V.gather(transport)
        loc = forms.mass_loc(V, self.geom, Uiloc - U0loc)
        if w_ex:
            loc = loc - (dt / rho) * w_ex * self._rhs_weak_loc(
                U0loc, rho, mu, Ploc, U0loc)
        if w_im:
            loc = loc - (dt / rho) * w_im * self._rhs_weak_loc(
                Uiloc, rho, mu, Ploc, Tloc)
        r = V.dof_sum(loc)
        bnd = None
        if w_ex:
            bnd = (dt / rho) * w_ex * self._rhs_weak_bnd(U0, P0, rho, mu, T=U0)
        if w_im:
            T = Ui if transport is None else transport
            b = (dt / rho) * w_im * self._rhs_weak_bnd(Ui, P0, rho, mu, T=T)
            bnd = b if bnd is None else bnd + b
        return r if bnd is None else r - bnd

    def pressure_solve(self, Ui, P0, alpha, rho, dt, mu, mask, gvals, tol,
                       neumann, rotational):
        """Pressure Poisson in increment form, Jacobi-preconditioned CG on
        the exact P1 stiffness (no multigrid): the JAX package's
        _pressure_solve_impl. Returns (p1, SolveInfo)."""
        V, Q, geom = self.V, self.Q, self.geom

        def K(p):
            return assembly.stiffness_apply(Q, geom, p)

        L2 = -(alpha * rho / dt) * forms.div_rhs(V, Q, geom, Ui)
        if rotational:
            L2 = L2 - mu * forms.grad_div_ustar_rhs(V, Q, geom, Ui)
        sd = self.stiff_diag_Q
        diag = torch.where(sd > 0, sd, torch.ones_like(sd))
        if neumann:
            phi, sinfo = krylov.cg(
                K, L2, M=lambda r: r / diag, rtol=tol, maxiter=1000,
                nullspace=[self.ones_Q],
            )
        else:
            free = 1.0 - mask

            def K_bc(p):
                return free * K(free * p) + mask * p

            pin = mask * (gvals - P0)
            rhs = free * (L2 - K(pin)) + pin
            phi, sinfo = krylov.cg(
                K_bc, rhs, M=lambda r: r / (free * diag + mask), rtol=tol,
                maxiter=1000,
            )
        return P0 + phi, sinfo

    def velocity_correction(self, Ui, P1, P0, rho, mu, dt, mask, gvals, tol,
                            rotational):
        """Velocity correction in increment form: M d = -(dt/rho)
        grad(p1 - p0) (with the rotational form's grad(div u*) part), Jacobi
        CG on the consistent vector mass, for d = u1 - u*: the JAX package's
        _velocity_correction_impl. Returns (u1, SolveInfo)."""
        V, Q, geom = self.V, self.Q, self.geom
        div_part = mu * forms.grad_div_ustar(V, geom, Ui) if rotational else None
        free = 1.0 - mask

        def M_bc(u):
            return free * assembly.mass_apply(V, geom, free * u) + mask * u

        diag = free * self.mass_diag_V + mask
        L3 = -(dt / rho) * forms.grad_phi_rhs(
            V, Q, geom, P1 - P0, div_part=div_part, rule_degree=4
        )
        dmask = mask * (gvals - Ui)
        rhs = free * (L3 - assembly.mass_apply(V, geom, dmask)) + dmask
        d, sinfo = krylov.cg(M_bc, rhs, M=lambda r: r / diag, rtol=tol,
                             maxiter=500)
        return Ui + d, sinfo
