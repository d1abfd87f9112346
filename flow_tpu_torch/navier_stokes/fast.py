# The projection stepper of the Karman benchmark path on the window-kernel
# route. Port of flow_tpu/navier_stokes/fast.py::FastStepper, cut to the
# route that runs the window kernels (the JAX package's FLOW_WINKERNEL=1,
# BiCGStab momentum, packed=False):
#
#   1. tentative velocity, in the window layout's permuted row order:
#      - Newton (the default): a Newton loop on the nonlinear residual; each
#        iteration solves with BiCGStab whose matvec is the exact tangent,
#        the window momentum kernel in Newton mode (attic/winmom.py, K3 with
#        the reaction term) plus the exact tangents of the O(surface)
#        ds-terms;
#      - lagged: the transport frozen at the initial guess, so the residual
#        is affine and one BiCGStab solve (K3, lagged) is the step;
#   2. pressure Poisson in increment form: CG on the window stiffness
#      operator (attic/winkernel.py, K4b) preconditioned by the caller's
#      V-cycle (solvers/multigrid.P1Hierarchy), or, without one, Jacobi CG on
#      the exact stiffness (NSContext.pressure_solve);
#   3. velocity correction, CG on the consistent mass through the window
#      momentum kernel with zero convection and stress weights.
#
# Time schemes: backward Euler, Crank-Nicolson and variable-step BDF2, which
# runs as a backward-Euler step from u_hat = ((1+r)^2 u_n - r^2 u_{n-1}) /
# (1+2r) with dt* = dt (1+r)/(1+2r), r = dt_n/dt_{n-1}, and the extrapolated
# initial guess (1+r) u_n - r u_{n-1}. Forward Euler is not ported.
#
# The JAX package's lax.scan and lax.while_loop are Python loops here
# (run, the Newton loop): the Newton loop reads one boolean from the device
# per iteration; the time step and the CFL controller stay on the device as
# 0-d tensors. The route is a constructor argument (winkernel=True), not an
# environment variable. Every other route of the JAX stepper raises
# NotImplementedError and names its ROADMAP item.
from __future__ import annotations

import torch

from ..fem import forms
from ..fem.bc import combine_bcs
from ..mesh3d import _device
from ..solvers import krylov
from .boxfast import StepStats
from .pressure_correction import NSContext

__all__ = ["FastStepper"]

_TODO = "not ported (ROADMAP queue 1 item 7: navier_stokes/fast.py)"
_THETA = {
    "backward euler": (0.0, 1.0),
    "bdf2": (0.0, 1.0),
    "crank-nicolson": (0.5, 0.5),
}


class FastStepper:
    """Projection stepper bound to (spaces, BCs, material constants).

    step(U, P, dt)     -> (U1, P1, StepStats), one theta-method step
    run(U, P, dt0, n)  -> (U, P, dt, telemetry), n steps with the CFL
                          controller on the device; BDF2 returns
                          (..., (Um1, dtp)) as well

    U is [n_V, 2] and P [n_Q] in the spaces' numbering, in `dtype` on
    `device` (defaults: the mesh's). Set `pressure_precond` (a callable
    r -> z, e.g. P1Hierarchy.v_cycle) before stepping, or leave it None for
    Jacobi CG. forces_probe: a callable (U1, P1) -> [2], or with
    needs_history (U1, P1, U0, dt) -> [2] (navier_stokes/forces.py), whose
    values run() reports as telemetry["forces"].
    """

    def __init__(
        self,
        V,
        Q,
        u_bcs,
        p_bcs,
        rho,
        mu,
        time_step_method="backward euler",
        rotational_form=True,
        newton_tol=1.0e-10,
        newton_rtol=0.0,
        newton_maxiter=10,
        linear_rtol=1.0e-7,
        ew_forcing=False,
        pressure_rtol=1.0e-10,
        pressure_maxiter=1000,
        pressure_precond=None,
        correction_rtol=1.0e-10,
        cfl_target=1.0,
        dt_max=1.0,
        forces_probe=None,
        packed="auto",
        convection="newton",
        momentum_solver="bicgstab",
        winkernel=False,
        winkernel_S=None,
        device=None,
        dtype=None,
    ):
        if not winkernel:
            raise NotImplementedError(
                f"FastStepper: only the window-kernel route (winkernel=True) "
                f"is ported; the einsum, element-matrix and assembled-ELL "
                f"momentum routes are {_TODO}"
            )
        if convection not in ("newton", "lagged"):
            raise ValueError(f"FastStepper: unknown convection {convection!r}")
        if time_step_method not in _THETA:
            raise NotImplementedError(
                f"FastStepper: time_step_method {time_step_method!r} is {_TODO}"
            )
        if momentum_solver != "bicgstab":
            raise NotImplementedError(f"FastStepper: GMRES momentum is {_TODO}")
        if packed is True:
            raise NotImplementedError(
                "FastStepper: the lane-packed layout is not ported (ROADMAP "
                "queue 1 item 7: fem/packed.py)"
            )
        mesh = V.mesh
        self.V, self.Q = V, Q
        self.device = mesh.device if device is None else _device(device)
        self.dtype = dtype = mesh.dtype if dtype is None else dtype
        self.rho = float(rho)
        self.mu = float(mu)
        self.rotational = rotational_form
        self.lagged = convection == "lagged"
        self.bdf2 = time_step_method == "bdf2"
        self.theta = _THETA[time_step_method]
        self.newton_tol = newton_tol
        self.newton_rtol = newton_rtol
        self.newton_maxiter = newton_maxiter
        self.linear_rtol = linear_rtol
        self.ew_forcing = ew_forcing  # Eisenstat-Walker choice 2 inner rtol
        self.pressure_rtol = pressure_rtol
        self.pressure_maxiter = pressure_maxiter
        self.pressure_precond = pressure_precond
        self.correction_rtol = correction_rtol
        self.cfl_target = cfl_target
        self.dt_max = dt_max
        self.forces_probe = forces_probe
        self.hmax = mesh.hmax

        self.ctx = ctx = NSContext(V, Q, dtype, self.device)

        def dev(a):
            return torch.as_tensor(a, dtype=dtype, device=self.device)

        mask_u, val_u = combine_bcs(V, u_bcs)
        self.mask_u, self.val_u = dev(mask_u), dev(val_u)
        self.has_p_bcs = bool(p_bcs)
        if self.has_p_bcs:
            mask_p, val_p = combine_bcs(Q, p_bcs)
            self.mask_p, self.val_p = dev(mask_p), dev(val_p)
        else:
            self.mask_p = torch.zeros(Q.n_dofs, dtype=dtype, device=self.device)
            self.val_p = self.mask_p

        from ..attic.winkernel import WindowStiffnessOperator
        from ..attic.winmom import WindowLaggedMomentum

        # S=None sizes the windows from the RCM bandwidth
        self.winmom = op = WindowLaggedMomentum(V, S=winkernel_S, device=self.device)
        # the solve lives in the layout's permuted rows: BC rows and the
        # boundary facet tables are permuted once here
        self.mask_up = self.mask_u[op.perm]
        self.btab_perm = ctx.btab.permuted(op.wl.inv)
        self.Tq_zero = op.zero_transport()
        self.K_Q = WindowStiffnessOperator(Q, device=self.device)

    def zeros(self):
        return (
            torch.zeros((self.V.n_dofs, 2), dtype=self.dtype, device=self.device),
            torch.zeros(self.Q.n_dofs, dtype=self.dtype, device=self.device),
        )

    def _scalar(self, v):
        return torch.as_tensor(v, dtype=self.dtype, device=self.device)

    def step(self, U, P, dt):
        """One projection step -> (U1, P1, StepStats)."""
        return self._step_impl(U, P, self._scalar(dt))

    # -- BDF2 as a backward-Euler step from a modified state -------------------
    @staticmethod
    def _bdf2_hat(U, Um1, dt, dtp):
        r = dt / dtp
        uhat = ((1.0 + r) ** 2 * U - r * r * Um1) / (1.0 + 2.0 * r)
        dt_eff = dt * (1.0 + r) / (1.0 + 2.0 * r)
        return uhat, dt_eff, r

    def _step_impl_bdf2(self, U, Um1, P, dt, dtp):
        uhat, dt_eff, r = self._bdf2_hat(U, Um1, dt, dtp)
        # second-order extrapolated initial guess
        return self._step_impl(uhat, P, dt_eff, x0=(1.0 + r) * U - r * Um1)

    # -- substep 1: tentative velocity, window route ---------------------------
    def _step_impl(self, U, P, dt, x0=None):
        ctx = self.ctx
        rho, mu = self.rho, self.mu
        mask, val = self.mask_u, self.val_u
        free = 1.0 - mask
        s = (dt / rho) * self.theta[1]
        diag = ctx.mass_diag_V + s * (2.0 * mu) * ctx.stiff_diag_V
        diag = free * diag + mask
        x0 = free * (U if x0 is None else x0) + mask * val

        def res_bc(x, transport=None):
            r = ctx.residual(x, U, P, rho, mu, dt, self.theta, transport)
            return free * r + mask * (x - val)

        op = self.winmom
        perm, inv = op.perm, op.inv
        maskp = self.mask_up
        freep = 1.0 - maskp
        diagp = diag[perm]
        bt = ctx.btab

        def bnd_p(vp, tnp, pos=None, tb=None):
            # tangents of the x-dependent ds-terms, in permuted rows: the
            # stress term is linear; the do-nothing term -(rho/2)(T.n)+ x is
            # linear in x with T frozen (lagged), and differentiates into
            # (x.n)+ v + H(x.n)(v.n) x with T = x (Newton)
            btp = self.btab_perm
            val_b = mu * torch.einsum("bqma,bm->bqa", btp.grads(vp), bt.normals)
            wb = btp.values(vp)
            if pos is None:
                t = -0.5 * rho * tnp[:, :, None] * wb
            else:
                wn = torch.einsum("bqm,bm->bq", wb, bt.normals)
                t = -0.5 * rho * (tnp[:, :, None] * wb + (pos * wn)[:, :, None] * tb)
            return btp.integrate_rhs(val_b + t)

        def solve(Tq, r, rtol, tnp, pos=None, tb=None, Uq=None, Gu=None):
            def Jv_p(vp):
                av = op.apply_perm_rows(vp, Tq, 1.0, s * rho, s * mu, Uq, Gu)
                av = av - s * bnd_p(vp, tnp, pos, tb)
                return freep * av + maskp * vp

            dxp, sinfo = krylov.bicgstab(
                Jv_p, -r[perm], M=lambda t: t / diagp, rtol=rtol,
                atol=0.05 * self.newton_tol, maxiter=300,
            )
            return dxp[inv], sinfo

        if self.lagged:
            # transport with x0 (u^n for the theta methods, the BDF2
            # extrapolation): the residual is affine in x, so one linear
            # solve to the Newton target is the step
            r0 = res_bc(x0, transport=x0)
            tnp = torch.clamp(
                torch.einsum("bqm,bm->bq", bt.values(x0), bt.normals), min=0.0
            )
            dx, sinfo = solve(op.transport_qp(x0), r0, self.newton_rtol, tnp)
            Ui = x0 + dx
            niters, nres, lin, mconv = 1, sinfo.resnorm, sinfo.iters, sinfo.converged
        else:
            Ui, niters, nres, lin, mconv = self._newton(res_bc, x0, solve)
        P1, pinfo = self._pressure_solve(Ui, P, dt)
        U1, cinfo = self._correction(Ui, P1, P, dt)
        stats = StepStats(niters, nres, lin, pinfo.iters, cinfo.iters,
                          pinfo.converged, cinfo.converged, mconv)
        return U1, P1, stats

    def _newton(self, res_bc, x, solve):
        """Newton on res_bc from x: each iteration one BiCGStab solve with
        the exact tangent (K3 in Newton mode) to the inner rtol eta
        (linear_rtol, or Eisenstat-Walker). Stops on |r| <= max(newton_tol,
        newton_rtol |r0|) or newton_maxiter iterations -> (x, iterations,
        |r|, linear iterations, converged)."""
        bt, op = self.ctx.btab, self.winmom
        r = res_bc(x)
        rnorm = torch.sqrt(torch.sum(r * r))
        target = torch.clamp(self.newton_rtol * rnorm, min=self.newton_tol)
        eta = self._scalar(self.linear_rtol)
        k = lin = 0
        while k < self.newton_maxiter and bool(rnorm > target):
            Tq, Uq, Gu = op.state_qp(x)
            tb = bt.values(x)
            tn = torch.einsum("bqm,bm->bq", tb, bt.normals)
            dx, sinfo = solve(Tq, r, eta, torch.clamp(tn, min=0.0),
                              (tn > 0.0).to(tb.dtype), tb, Uq, Gu)
            x = x + dx
            r = res_bc(x)
            rnorm_new = torch.sqrt(torch.sum(r * r))
            if self.ew_forcing:
                gamma = 0.9
                eta_new = gamma * (rnorm_new / rnorm) ** 2
                guard = gamma * eta * eta
                eta_new = torch.where(guard > 0.1, torch.maximum(eta_new, guard),
                                      eta_new)
                eta = torch.clamp(eta_new, 1.0e-4, 0.5)
            rnorm = rnorm_new
            k += 1
            lin += sinfo.iters
        return x, k, rnorm, lin, rnorm <= target

    # -- substep 2: pressure Poisson, increment form ----------------------------
    def _pressure_solve(self, Ui, P, dt):
        if self.pressure_precond is None:
            return self.ctx.pressure_solve(
                Ui, P, 1.0, self.rho, dt, self.mu, self.mask_p, self.val_p,
                self.pressure_rtol, neumann=not self.has_p_bcs,
                rotational=self.rotational,
            )
        return self._pressure_solve_mg(Ui, P, dt)

    def _pressure_solve_mg(self, Ui, P, dt):
        V, Q, geom = self.V, self.Q, self.ctx.geom
        K = self.K_Q.apply
        L2 = -(self.rho / dt) * forms.div_rhs(V, Q, geom, Ui)
        if self.rotational:
            L2 = L2 - self.mu * forms.grad_div_ustar_rhs(V, Q, geom, Ui)
        if not self.has_p_bcs:
            phi, sinfo = krylov.cg(
                K, L2, M=self.pressure_precond, rtol=self.pressure_rtol,
                maxiter=self.pressure_maxiter, nullspace=[self.ctx.ones_Q],
            )
            return P + phi, sinfo
        mask, free = self.mask_p, 1.0 - self.mask_p

        def K_bc(p):
            return free * K(free * p) + mask * p

        pin = mask * (self.val_p - P)
        rhs = free * (L2 - K(pin)) + pin
        phi, sinfo = krylov.cg(
            K_bc, rhs, M=self.pressure_precond, rtol=self.pressure_rtol,
            maxiter=self.pressure_maxiter,
        )
        return P + phi, sinfo

    # -- substep 3: velocity correction through the window mass -----------------
    def _correction(self, Ui, P1, P, dt):
        V, Q, geom = self.V, self.Q, self.ctx.geom
        op = self.winmom
        phi = P1 - P
        div_part = None
        if self.rotational:
            div_part = self.mu * forms.grad_div_ustar(V, geom, Ui)
        mask, free = self.mask_u, 1.0 - self.mask_u
        Tq0 = self.Tq_zero

        def M_bc(u):
            return free * op.apply(free * u, Tq0, 1.0, 0.0, 0.0) + mask * u

        diag = free * self.ctx.mass_diag_V + mask
        L3 = -(dt / self.rho) * forms.grad_phi_rhs(
            V, Q, geom, phi, div_part=div_part, rule_degree=4
        )
        dmask = mask * (self.val_u - Ui)
        rhs = free * (L3 - op.apply(dmask, Tq0, 1.0, 0.0, 0.0)) + dmask
        d, sinfo = krylov.cg(
            M_bc, rhs, M=lambda r: r / diag, rtol=self.correction_rtol,
            maxiter=500,
        )
        return Ui + d, sinfo

    # -- time loop with the CFL controller -------------------------------------
    def run(self, U, P, dt0, n_steps, Um1=None, dtp0=None, dt_max=None):
        """n_steps steps with the CFL controller -> (U, P, dt, telemetry);
        BDF2 also returns (Um1, dtp), the previous velocity and step, which
        continue a run at full order when passed back (the defaults Um1=U,
        dtp=dt0 make the first step a backward-Euler-like start). dt_max
        overrides the constructor's cap for this run.

        telemetry maps t, dt, the per-step iteration counts (the JAX
        stepper's keys), the convergence flags of the three solves and,
        with a forces probe, forces [n_steps, 2] to tensors."""
        dt_cap = self._scalar(self.dt_max if dt_max is None else dt_max)
        cfl = self._scalar(self.cfl_target)
        dt = self._scalar(dt0)
        t = self._scalar(0.0)
        if self.bdf2:
            Um1 = U if Um1 is None else Um1
            dtp = dt if dtp0 is None else self._scalar(dtp0)
        probe = self.forces_probe
        history = getattr(probe, "needs_history", False)
        rows = []
        for _ in range(n_steps):
            if self.bdf2:
                U1, P1, stats = self._step_impl_bdf2(U, Um1, P, dt, dtp)
            else:
                U1, P1, stats = self._step_impl(U, P, dt)
            t = t + dt
            forces = None
            if probe is not None and not history:
                forces = probe(U1, P1)
            elif probe is not None:
                # the scheme's own time derivative: for BDF2, (U1 - u_hat) /
                # dt_eff is exactly the variable-step BDF2 derivative
                U0, dt0_ = self._bdf2_hat(U, Um1, dt, dtp)[:2] if self.bdf2 else (U, dt)
                forces = probe(U1, P1, U0, dt0_)
            rows.append((t, dt, stats, forces))
            # smooth CFL-style controller, on the device
            umax = torch.sqrt(torch.max(torch.sum(U1 * U1, dim=1)))
            target_dt = cfl * self.hmax / torch.clamp(umax, min=1e-30)
            dt_new = torch.minimum(
                dt_cap,
                dt * torch.clamp(1.0 + 0.5 * (target_dt - dt) / dt, max=2.0),
            )
            if self.bdf2:
                Um1, dtp = U, dt
            U, P, dt = U1, P1, dt_new
        telemetry = {
            "t": torch.stack([r[0] for r in rows]),
            "dt": torch.stack([r[1] for r in rows]),
        }
        if probe is not None:
            telemetry["forces"] = torch.stack([r[3] for r in rows])
        for key in ("momentum_converged", "pressure_converged",
                    "correction_converged"):
            telemetry[key] = torch.stack([getattr(r[2], key) for r in rows])
        for key in ("newton_iters", "linear_iters", "pressure_iters",
                    "correction_iters"):
            telemetry[key] = torch.tensor(
                [getattr(r[2], key) for r in rows], dtype=torch.int64
            )
        if self.bdf2:
            return U, P, dt, telemetry, (Um1, dtp)
        return U, P, dt, telemetry
