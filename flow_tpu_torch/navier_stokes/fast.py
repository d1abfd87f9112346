# The projection stepper of the Karman benchmark path on the window-kernel
# route. Port of flow_tpu/navier_stokes/fast.py::FastStepper, cut to the
# route that runs the window kernels (the JAX package's FLOW_WINKERNEL=1 with
# convection="lagged", backward Euler, BiCGStab momentum, packed=False):
#
#   1. tentative velocity: one linear (lagged) momentum solve, BiCGStab in
#      the window layout's permuted row order; every matvec is the window
#      momentum kernel (attic/winmom.py, K3) plus the O(surface) ds-terms;
#   2. pressure Poisson in increment form, CG on the window stiffness
#      operator (attic/winkernel.py, K4b) preconditioned by the caller's
#      V-cycle (solvers/multigrid.P1Hierarchy);
#   3. velocity correction, CG on the consistent mass through the window
#      momentum kernel with zero convection and stress weights.
#
# The JAX package's lax.scan loop is a Python loop here (run); the time step
# and the CFL controller stay on the device as 0-d tensors. The route is a
# constructor argument (winkernel=True), not an environment variable. Every
# other route of the JAX stepper raises NotImplementedError and names its
# ROADMAP item.
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


class FastStepper:
    """Projection stepper bound to (spaces, BCs, material constants).

    step(U, P, dt)       -> (U1, P1, StepStats)
    run(U, P, dt0, n)    -> (U, P, dt, telemetry), n steps with the CFL
                            controller on the device

    U is [n_V, 2] and P [n_Q] in the spaces' numbering, in `dtype` on
    `device` (defaults: the mesh's). Set `pressure_precond` (a callable
    r -> z, e.g. P1Hierarchy.v_cycle) before stepping. The lagged momentum
    system is linear, so its one BiCGStab solve stops on the Newton target,
    max(newton_rtol |r0|, 0.05 newton_tol); the JAX stepper's Newton-loop
    settings (newton_maxiter, linear_rtol) have no effect on this route and
    are not taken.
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
        pressure_rtol=1.0e-10,
        pressure_maxiter=1000,
        pressure_precond=None,
        correction_rtol=1.0e-10,
        cfl_target=1.0,
        dt_max=1.0,
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
        if convection != "lagged":
            raise NotImplementedError(f"FastStepper: Newton convection is {_TODO}")
        if time_step_method != "backward euler":
            raise NotImplementedError(
                f"FastStepper: {time_step_method!r} (BDF2, Crank-Nicolson) is {_TODO}"
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
        self.newton_tol = newton_tol
        self.newton_rtol = newton_rtol
        self.pressure_rtol = pressure_rtol
        self.pressure_maxiter = pressure_maxiter
        self.pressure_precond = pressure_precond
        self.correction_rtol = correction_rtol
        self.cfl_target = cfl_target
        self.dt_max = dt_max
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

    # -- substep 1: lagged momentum, window route ------------------------------
    def _step_impl(self, U, P, dt):
        ctx = self.ctx
        rho, mu = self.rho, self.mu
        mask, val = self.mask_u, self.val_u
        free = 1.0 - mask
        s = dt / rho  # backward Euler: theta weight 1
        diag = ctx.mass_diag_V + s * (2.0 * mu) * ctx.stiff_diag_V
        diag = free * diag + mask
        # transport with u^n; the residual is affine in x, so one linear
        # solve to the Newton target is the step
        x0 = free * U + mask * val
        r0 = ctx.residual(x0, U, P, rho, mu, dt, transport=x0)
        r0 = free * r0 + mask * (x0 - val)

        op = self.winmom
        Tq = op.transport_qp(x0)
        perm, inv = op.perm, op.inv
        maskp = self.mask_up
        freep = 1.0 - maskp
        diagp = diag[perm]
        bt, btp = ctx.btab, self.btab_perm
        # transport factor of the do-nothing term, once per step
        tnp = torch.clamp(
            torch.einsum("bqm,bm->bq", bt.values(x0), bt.normals), min=0.0
        )

        def bnd_p(vp):
            # x-dependent ds-terms of the residual, in permuted rows
            val_b = mu * torch.einsum("bqma,bm->bqa", btp.grads(vp), bt.normals)
            val_b = val_b + -0.5 * rho * tnp[:, :, None] * btp.values(vp)
            return btp.integrate_rhs(val_b)

        def Jv_p(vp):
            av = op.apply_perm_rows(vp, Tq, 1.0, s * rho, s * mu)
            av = av - s * bnd_p(vp)
            return freep * av + maskp * vp

        dxp, sinfo = krylov.bicgstab(
            Jv_p, -r0[perm], M=lambda t: t / diagp, rtol=self.newton_rtol,
            atol=0.05 * self.newton_tol, maxiter=300,
        )
        Ui = x0 + dxp[inv]
        P1, pinfo = self._pressure_solve_mg(Ui, P, dt)
        U1, cinfo = self._correction(Ui, P1, P, dt)
        stats = StepStats(1, sinfo.resnorm, sinfo.iters, pinfo.iters,
                          cinfo.iters, pinfo.converged, cinfo.converged,
                          sinfo.converged)
        return U1, P1, stats

    # -- substep 2: pressure Poisson, increment form ----------------------------
    def _pressure_solve_mg(self, Ui, P, dt):
        if self.pressure_precond is None:
            raise NotImplementedError(
                "FastStepper: the pressure solve without a preconditioner is "
                f"{_TODO}; set pressure_precond (e.g. P1Hierarchy.v_cycle)"
            )
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
    def run(self, U, P, dt0, n_steps):
        """n_steps steps with the CFL controller -> (U, P, dt, telemetry).

        telemetry maps t, dt and the per-step iteration counts (the JAX
        stepper's keys) plus the convergence flags of the three solves to
        [n_steps] tensors."""
        dt_cap = self._scalar(self.dt_max)
        cfl = self._scalar(self.cfl_target)
        dt = self._scalar(dt0)
        t = self._scalar(0.0)
        rows = []
        for _ in range(n_steps):
            U1, P1, stats = self._step_impl(U, P, dt)
            t = t + dt
            rows.append((t, dt, stats))
            # smooth CFL-style controller, on the device
            umax = torch.sqrt(torch.max(torch.sum(U1 * U1, dim=1)))
            target_dt = cfl * self.hmax / torch.clamp(umax, min=1e-30)
            dt = torch.minimum(
                dt_cap,
                dt * torch.clamp(1.0 + 0.5 * (target_dt - dt) / dt, max=2.0),
            )
            U, P = U1, P1
        telemetry = {
            "t": torch.stack([r[0] for r in rows]),
            "dt": torch.stack([r[1] for r in rows]),
        }
        for key in ("momentum_converged", "pressure_converged",
                    "correction_converged"):
            telemetry[key] = torch.stack([getattr(r[2], key) for r in rows])
        for key in ("newton_iters", "linear_iters", "pressure_iters",
                    "correction_iters"):
            telemetry[key] = torch.tensor(
                [getattr(r[2], key) for r in rows], dtype=torch.int64
            )
        return U, P, dt, telemetry
