# Adaptive AB2/trapezoid monolithic Navier-Stokes integrator (Gresho and
# Sani, sec. 3.16.4). Port of flow_tpu/experimental/ab2tr.py:
#   * consistent initialization: solve the coupled system
#       [M  C] [du/dt]   [F(u0)]
#       [C^T 0] [ p   ] = [ 0   ]
#     for the initial acceleration and pressure;
#   * an explicit Adams-Bashforth-2 predictor;
#   * a nonlinear trapezoid corrector on the velocity-pressure saddle
#     point, by Newton with GMRES inner solves (the Jacobian's action by
#     torch.func.jvp at the Newton iterate);
#   * the local-truncation-error step-size controller
#       dt' = dt * (eps / ||u_TR - u_AB2||)^(1/3).
# Taylor-Hood P2/P1 on triangles, on the mesh's device in its dtype.
from __future__ import annotations

import torch

from ..fem import assembly, forms
from ..fem.assembly import geometry, geometry_on, tabulation
from ..fem.bc import combine_bcs
from ..fem.interpolate import eval_callable
from ..fem.spaces import Function, FunctionSpace
from ..solvers import krylov

__all__ = ["AB2TR"]


class AB2TR:
    """Monolithic adaptive NS integrator on Taylor-Hood (V = P2 vector,
    Q = P1).

        integ = AB2TR(V, Q, u_bcs, rho, mu, f)
        state = integ.bootstrap(u0)
        state, dt_next, lte = integ.step(state, dt)
    """

    def __init__(self, V: FunctionSpace, Q: FunctionSpace, u_bcs, rho, mu, f=None):
        self.V, self.Q = V, Q
        self.rho = float(rho)
        self.mu = float(mu)
        mesh = V.mesh
        dtype, device = mesh.dtype, mesh.device
        hgeom = geometry(mesh)
        self.geom = geometry_on(mesh, dtype, device)

        def dev(a):
            return torch.as_tensor(a, dtype=dtype, device=device)

        mask_u, val_u = combine_bcs(V, u_bcs)
        self.mask_u, self.val_u = dev(mask_u), dev(val_u)
        self.free_u = 1.0 - self.mask_u
        self.f = f
        self.ones_Q = torch.ones(Q.n_dofs, dtype=dtype, device=device)
        self.mass_diag = dev(assembly.mass_diag(V, hgeom))[:, None].expand(V.n_dofs, 2)
        self.mp_diag = dev(assembly.lumped_mass_diag(Q, hgeom))

        self._f_q = None
        if f is not None:
            ftab = tabulation(V, 6)
            self._f_q = eval_callable(f, dev(hgeom.physical_points(ftab.ref_pts)))

    def _pack(self, a, b):
        return torch.cat([a.reshape(-1), b])

    def _unpack(self, z):
        nV2 = self.V.n_dofs * 2
        return z[:nV2].reshape(self.V.n_dofs, 2), z[nV2:]

    # -- spatial operator: the momentum rhs without the pressure ---------------
    def _rhs_mom(self, U):
        V, geom = self.V, self.geom
        out = -self.rho * forms.skew_convection_combined_rhs(V, geom, U, rule_degree=5)
        out = out - forms.sym_grad_apply(V, geom, U, self.mu)
        if self._f_q is not None:
            ftab = tabulation(V, 6).on(U.dtype, U.device)
            out = out + assembly.integrate_rhs(V, ftab, geom, val=self._f_q)
        return out

    # -- consistent initialization ---------------------------------------------
    def bootstrap(self, u0: Function, dudt_bc_vals=None):
        """Solve the coupled [M C; C^T 0] system for (du/dt, p) at t = 0
        (GMRES(80), rtol 1e-10, the pressure constant projected out)."""
        V, Q, geom = self.V, self.Q, self.geom
        U0 = u0.vector
        mask, free = self.mask_u, self.free_u
        gdot = torch.zeros_like(U0) if dudt_bc_vals is None else dudt_bc_vals

        def op(z):
            Ud, P = self._unpack(z)
            ru = assembly.mass_apply(V, geom, free * Ud) - forms.pressure_grad_rhs(
                V, Q, geom, P)
            ru = free * ru + mask * Ud
            rp = forms.div_rhs(V, Q, geom, free * Ud + mask * gdot)
            rp = rp - torch.mean(rp)
            return self._pack(ru, rp)

        bu = self._rhs_mom(U0)
        bu = free * bu + mask * gdot
        b = self._pack(bu, torch.zeros(Q.n_dofs, dtype=U0.dtype, device=U0.device))

        ns = self._pack(torch.zeros_like(U0), self.ones_Q)
        ns = ns / torch.sqrt(torch.sum(ns * ns))

        def Mprec(z):
            Ud, P = self._unpack(z)
            return self._pack(Ud / self.mass_diag, P / self.mp_diag)

        z, _ = krylov.gmres(
            lambda z: op(z - torch.sum(ns * z) * ns),
            b - torch.sum(ns * b) * ns,
            M=Mprec, rtol=1e-10, maxiter=4000, restart=80,
        )
        Udot, P = self._unpack(z)
        P = P - torch.mean(P)
        return {"u": U0, "udot": Udot, "p": P, "udot_old": Udot, "dt_old": None}

    # -- one adaptive step -------------------------------------------------------
    def step(self, state, dt, eps=1e-4, newton_tol=1e-9, newton_maxiter=8):
        """AB2 predict, TR correct, the LTE-based next dt. Returns
        (new_state, dt_next, lte)."""
        V, Q, geom = self.V, self.Q, self.geom
        U0, Udot0 = state["u"], state["udot"]
        dt_old = state["dt_old"]
        mask, free = self.mask_u, self.free_u

        # AB2 predictor (forward Euler on the first step)
        if dt_old is None:
            U_pred = U0 + dt * Udot0
        else:
            r = dt / dt_old
            U_pred = U0 + 0.5 * dt * ((2.0 + r) * Udot0 - r * state["udot_old"])

        # TR corrector for (u1, p_half):
        #   M(u1 - u0) = dt/2 (rhs(u1) + rhs(u0)) + dt C p,   C^T u1 = 0
        rhs0 = self._rhs_mom(U0)

        def res(z):
            U1, P = self._unpack(z)
            ru = assembly.mass_apply(V, geom, U1 - U0) - 0.5 * dt * (
                self._rhs_mom(U1) + rhs0)
            ru = ru - dt * forms.pressure_grad_rhs(V, Q, geom, P)
            ru = free * ru + mask * (U1 - self.val_u)
            # the BC-consistent velocity in the constraint (the boundary
            # data carries a flux the interior must balance)
            rp = forms.div_rhs(V, Q, geom, free * U1 + mask * self.val_u)
            rp = rp - torch.mean(rp)
            return self._pack(ru, rp)

        def Mprec(z):
            U1, P = self._unpack(z)
            return self._pack(U1 / self.mass_diag, P / (dt * self.mp_diag / self.rho))

        z = self._pack(free * U_pred + mask * self.val_u, state["p"])
        for _ in range(newton_maxiter):
            r = res(z)
            rn = float(torch.sqrt(torch.sum(r * r)))
            if rn < newton_tol:
                break

            def Jv(v, z=z):
                return torch.func.jvp(res, (z,), (v,))[1]

            dz, _ = krylov.gmres(Jv, -r, M=Mprec, rtol=1e-8, maxiter=2000, restart=80)
            z = z + dz

        U1, P1 = self._unpack(z)
        P1 = P1 - torch.mean(P1)
        Udot1 = (2.0 / dt) * (U1 - U0) - Udot0  # TR consistency

        lte = float(torch.max(torch.abs(U1 - U_pred))) / 3.0
        dt_next = dt * (eps / max(lte, 1e-30)) ** (1.0 / 3.0)
        dt_next = min(dt_next, 2.0 * dt)

        new_state = {"u": U1, "udot": Udot1, "p": P1, "udot_old": Udot0,
                     "dt_old": dt}
        return new_state, dt_next, lte
