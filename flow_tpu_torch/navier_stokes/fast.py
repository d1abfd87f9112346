# The projection stepper of the Karman benchmark path and of the 3-D cavity
# driver, on triangles or tets. Port of
# flow_tpu/navier_stokes/fast.py::FastStepper, cut to two routes (BiCGStab
# momentum, packed=False; the JAX stepper never packs in 3-D):
#
# - the einsum route (winkernel=False, the JAX package's default):
#   1. tentative velocity:
#      - Newton (the default): a Newton loop on the nonlinear residual; each
#        iteration solves with BiCGStab whose matvec is the exact tangent,
#        written out (mass, c(x; v) + c(v; x), stress, ds-terms) in place of
#        jax.linearize / jax.jvp: tangent_mode="linearize" keeps x's
#        quadrature-point values and gradients for the whole iteration,
#        "jvp" recomputes them in every matvec (no storage);
#      - lagged: the transport frozen at the initial guess; one BiCGStab
#        solve whose matvec is the element-matrix (EMA) tangent, a scalar
#        [nc, nl, nl] tensor (mass + viscous + lagged convection) built once
#        per step plus the factored stress coupling and the ds-terms;
#   2. pressure Poisson in increment form: CG on the assembled ELL
#      stiffness (fem/ell.py, the P1/P2 kernels of csrc/ell.cu on the card);
#   3. velocity correction, Jacobi CG on the consistent vector mass;
# - the window-kernel route (winkernel=True, the JAX package's
#   FLOW_WINKERNEL=1):
#   1. tentative velocity in the window layout's permuted row order, Newton
#      with the window momentum kernel in Newton mode as the tangent
#      (attic/winmom.py, K3 with the reaction term) plus the exact tangents
#      of the O(surface) ds-terms, or lagged with K3 lagged;
#   2. pressure Poisson on the window stiffness operator (attic/winkernel.py,
#      K4b);
#   3. velocity correction, CG on the consistent mass through the window
#      momentum kernel with zero convection and stress weights.
#
# The pressure solve on either route is preconditioned by the caller's
# V-cycle (solvers/multigrid.P1Hierarchy in 2-D,
# solvers/structured_mg.StructuredHierarchy on a box mesh), or, without one,
# is Jacobi CG on the exact stiffness (NSContext.pressure_solve).
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

from ..fem import assembly, forms
from ..fem.bc import combine_bcs
from ..mesh3d import _device
from ..solvers import krylov
from .boxfast import StepStats
from .pressure_correction import CONV_RULE, NSContext

__all__ = ["FastStepper"]

_TODO = "not ported (ROADMAP queue 1 item 5: navier_stokes/fast.py)"
_THETA = {
    "backward euler": (0.0, 1.0),
    "bdf2": (0.0, 1.0),
    "crank-nicolson": (0.5, 0.5),
}
# 2 n_V + n_Q from which the JAX stepper's packed="auto" takes the
# lane-packed layout in 2-D (flow_tpu/navier_stokes/fast.py:420-451)
PACKED_MIN_DOFS = 3000000


class FastStepper:
    """Projection stepper bound to (spaces, BCs, material constants).

    step(U, P, dt)     -> (U1, P1, StepStats), one theta-method step
    run(U, P, dt0, n)  -> (U, P, dt, telemetry), n steps with the CFL
                          controller on the device; BDF2 returns
                          (..., (Um1, dtp)) as well

    U is [n_V, dim] and P [n_Q] in the spaces' numbering, in `dtype` on
    `device` (defaults: the mesh's), on a triangle or a tet mesh. Set
    `pressure_precond` (a callable r -> z, e.g. P1Hierarchy.v_cycle in 2-D,
    StructuredHierarchy.v_cycle on a box mesh) before stepping, or leave it
    None for Jacobi CG. forces_probe: a callable (U1, P1) -> [2], or with
    needs_history (U1, P1, U0, dt) -> [2] (navier_stokes/forces.py), whose
    values run() reports as telemetry["forces"]. winkernel selects the
    route (module header); K_Q is the pressure operator, an ELLMatrix on the
    einsum route and a WindowStiffnessOperator on the window route.
    tangent_mode ("linearize" or "jvp", the JAX package's
    FLOW_TANGENT_MODE) sets whether the einsum Newton tangent keeps the
    state's quadrature-point tables for a Newton iteration or recomputes
    them in every matvec.
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
        divergence_probe=False,
        assembled_jacobian="auto",
        momentum_precond=None,
        packed="auto",
        convection="newton",
        momentum_solver="bicgstab",
        patches=None,
        winkernel=False,
        winkernel_S=None,
        tangent_mode="linearize",
        device=None,
        dtype=None,
    ):
        if convection not in ("newton", "lagged"):
            raise ValueError(f"FastStepper: unknown convection {convection!r}")
        if tangent_mode not in ("linearize", "jvp"):
            raise ValueError(f"FastStepper: unknown tangent_mode {tangent_mode!r}")
        if time_step_method not in _THETA:
            raise NotImplementedError(
                f"FastStepper: time_step_method {time_step_method!r} is {_TODO}"
            )
        if momentum_solver != "bicgstab":
            raise NotImplementedError(f"FastStepper: GMRES momentum is {_TODO}")
        if assembled_jacobian not in ("auto", False):
            raise NotImplementedError(
                f"FastStepper: the assembled-ELL momentum Jacobian is {_TODO}"
            )
        if momentum_precond is not None:
            raise NotImplementedError(
                f"FastStepper: the vertex momentum preconditioner is {_TODO}"
            )
        if patches is not None:
            raise NotImplementedError(f"FastStepper: patch mode (patches=) is {_TODO}")
        if divergence_probe:
            raise NotImplementedError(f"FastStepper: the divergence probe is {_TODO}")
        mesh = V.mesh
        # packed="auto" as the JAX stepper resolves it: the lane-packed
        # layout for 2-D Taylor-Hood from PACKED_MIN_DOFS, never with the
        # window kernels
        can_pack = getattr(mesh, "dim", 2) == 2 and V.degree == 2 and Q.degree == 1
        if packed is True and not can_pack:
            raise ValueError("FastStepper: packed mode unavailable for this "
                             "configuration")
        big = (2 * V.n_dofs + Q.n_dofs >= PACKED_MIN_DOFS) and not winkernel
        if (can_pack and big) if packed == "auto" else packed:
            raise NotImplementedError(
                "FastStepper: the lane-packed layout (packed=True, or "
                f"packed='auto' from {PACKED_MIN_DOFS} DoF on the einsum route) "
                "is not ported (ROADMAP queue 1 item 5: fem/packed.py)"
            )
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
        self.winkernel = winkernel
        self.tangent_mode = tangent_mode

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

        if not winkernel:
            from ..fem.ell import ell_stiffness

            self.K_Q = ell_stiffness(Q, assembly.geometry(mesh), dtype=dtype,
                                     device=self.device)
            if self.lagged:
                # EMA tables: the constant scalar stiffness tensor and the
                # reference mass matrix
                self._ema_kscal = forms.stiffness_scalar_loc(V, ctx.geom)
                self._ema_mref = dev(assembly.ref_mass(V.degree, assembly._dim(V)))
            return

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
            torch.zeros((self.V.n_dofs, self.V.n_components), dtype=self.dtype,
                        device=self.device),
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

    # -- substep 1: tentative velocity -----------------------------------------
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

        if self.winkernel:
            solve_lagged, solve_newton = self._window_solves(s, diag)
        else:
            solve_lagged, solve_newton = self._einsum_solves(dt, diag)
        if self.lagged:
            # transport with x0 (u^n for the theta methods, the BDF2
            # extrapolation): the residual is affine in x, so one linear
            # solve to the Newton target is the step
            dx, sinfo = solve_lagged(x0, res_bc(x0, transport=x0))
            Ui = x0 + dx
            niters, nres, lin, mconv = 1, sinfo.resnorm, sinfo.iters, sinfo.converged
        else:
            Ui, niters, nres, lin, mconv = self._newton(res_bc, x0, solve_newton)
        P1, pinfo = self._pressure_solve(Ui, P, dt)
        if self.winkernel:
            U1, cinfo = self._correction(Ui, P1, P, dt)
        else:
            U1, cinfo = ctx.velocity_correction(
                Ui, P1, P, rho, mu, dt, mask, val, self.correction_rtol,
                rotational=self.rotational,
            )
        stats = StepStats(niters, nres, lin, pinfo.iters, cinfo.iters,
                          pinfo.converged, cinfo.converged, mconv)
        return U1, P1, stats

    def _bicgstab(self, Jv, b, M, rtol):
        return krylov.bicgstab(Jv, b, M=M, rtol=rtol,
                               atol=0.05 * self.newton_tol, maxiter=300)

    def _bnd_tangent(self, x, vtab=None):
        """v -> the dof-level tangent at x of the x-dependent ds-terms: the
        stress term mu (grad v)^T n is linear; the do-nothing term
        -(rho/2)(T.n)+ v is linear with T = x frozen (lagged), and
        differentiates into -(rho/2)[(x.n)+ v + H(x.n)(v.n) x] with T = x
        (Newton). x is in the spaces' numbering; v is read through the
        facet tables vtab (default: the context's; the window route passes
        its permuted ones, so v and the result are in permuted rows)."""
        bt, rho, mu = self.ctx.btab, self.rho, self.mu
        vtab = bt if vtab is None else vtab
        tb = bt.values(x)
        tn = torch.einsum("bqm,bm->bq", tb, bt.normals)
        tnp = torch.clamp(tn, min=0.0)
        pos = None if self.lagged else (tn > 0.0).to(tb.dtype)

        def bnd(v):
            val_b = mu * torch.einsum("bqma,bm->bqa", vtab.grads(v), bt.normals)
            wb = vtab.values(v)
            t = tnp[:, :, None] * wb
            if pos is not None:
                wn = torch.einsum("bqm,bm->bq", wb, bt.normals)
                t = t + (pos * wn)[:, :, None] * tb
            return vtab.integrate_rhs(val_b - 0.5 * rho * t)

        return bnd

    def _ema_S(self, x0, dt):
        """The lagged tangent's scalar element tensor [nc, nl, nl] at the
        frozen transport x0: mass + viscous (component-diagonal half) +
        lagged skew convection, built once per step."""
        V, geom = self.V, self.ctx.geom
        s = (dt / self.rho) * self.theta[1]
        conv = forms.conv_lagged_jacobian_loc(V, geom, V.gather(x0),
                                              rule_degree=CONV_RULE)
        return (geom.detJ[:, None, None] * self._ema_mref
                + (s * self.mu) * self._ema_kscal + (s * self.rho) * conv)

    def _ema_Jv(self, S, x0, dt):
        """The lagged residual's tangent v -> J v (BC rows included) through
        the element matrices S (_ema_S): one gather, one [nl, nl] product per
        cell, the factored stress coupling, one dof sum, and the ds-term
        tangents with the transport x0."""
        V, geom, mu = self.V, self.ctx.geom, self.mu
        mask, free = self.mask_u, 1.0 - self.mask_u
        s = (dt / self.rho) * self.theta[1]
        bnd = self._bnd_tangent(x0)

        def Jv(v):
            vloc = V.gather(v)
            loc = torch.einsum("eij,eja->eia", S, vloc)
            loc = loc + (s * mu) * forms.sym_grad_transpose_loc(V, geom, vloc)
            av = V.dof_sum(loc) - s * bnd(v)
            return free * av + mask * v

        return Jv

    def _newton_Jv(self, x, dt):
        """The Newton residual's exact tangent at x, v -> J v (BC rows
        included): mass + s [rho (c(x; v) + c(v; x)) + stress] minus the
        ds-term tangents. tangent_mode "linearize" keeps x's quadrature-point
        values and gradients for every matvec; "jvp" recomputes them."""
        V, geom, rho, mu = self.V, self.ctx.geom, self.rho, self.mu
        mask, free = self.mask_u, 1.0 - self.mask_u
        s = (dt / rho) * self.theta[1]
        bnd = self._bnd_tangent(x)
        tab = assembly.tabulation(V, CONV_RULE).on(x.dtype, x.device)

        def state_qp():
            xloc = V.gather(x)
            return (assembly.values_at_qp(tab, xloc),
                    assembly.grads_at_qp(tab, geom, xloc))

        cached = state_qp() if self.tangent_mode == "linearize" else None

        def Jv(v):
            Xq, gX = state_qp() if cached is None else cached
            vloc = V.gather(v)
            conv = forms.skew_convection_tangent_loc(V, geom, vloc, Xq, gX,
                                                     rule_degree=CONV_RULE)
            loc = forms.mass_loc(V, geom, vloc)
            loc = loc + s * (rho * conv + forms.sym_grad_loc(V, geom, vloc, mu))
            av = V.dof_sum(loc) - s * bnd(v)
            return free * av + mask * v

        return Jv

    def _einsum_solves(self, dt, diag):
        """The einsum route's momentum solves: (x0, r0) -> (dx, info) with
        the EMA tangent at the frozen transport x0 (lagged), and (x, r, eta)
        -> (dx, info) with the exact Newton tangent at x."""

        def M(t):
            return t / diag

        def solve_lagged(x0, r0):
            Jv = self._ema_Jv(self._ema_S(x0, dt), x0, dt)
            return self._bicgstab(Jv, -r0, M, self.newton_rtol)

        def solve_newton(x, r, eta):
            return self._bicgstab(self._newton_Jv(x, dt), -r, M, eta)

        return solve_lagged, solve_newton

    def _window_solves(self, s, diag):
        """The window route's momentum solves (see _einsum_solves), in the
        layout's permuted rows: K3 lagged, or K3 in Newton mode, plus the
        ds-term tangents on the permuted facet tables."""
        rho, mu = self.rho, self.mu
        op = self.winmom
        perm, inv = op.perm, op.inv
        maskp = self.mask_up
        freep = 1.0 - maskp
        diagp = diag[perm]

        def solve(x, r, rtol, Tq, Uq=None, Gu=None):
            bnd = self._bnd_tangent(x, self.btab_perm)

            def Jv_p(vp):
                av = op.apply_perm_rows(vp, Tq, 1.0, s * rho, s * mu, Uq, Gu)
                return freep * (av - s * bnd(vp)) + maskp * vp

            dxp, sinfo = self._bicgstab(Jv_p, -r[perm], lambda t: t / diagp, rtol)
            return dxp[inv], sinfo

        def solve_lagged(x0, r0):
            return solve(x0, r0, self.newton_rtol, op.transport_qp(x0))

        def solve_newton(x, r, eta):
            return solve(x, r, eta, *op.state_qp(x))

        return solve_lagged, solve_newton

    def _newton(self, res_bc, x, solve):
        """Newton on res_bc from x: each iteration one BiCGStab solve
        solve(x, r, eta) with the exact tangent to the inner rtol eta
        (linear_rtol, or Eisenstat-Walker). Stops on |r| <= max(newton_tol,
        newton_rtol |r0|) or newton_maxiter iterations -> (x, iterations,
        |r|, linear iterations, converged)."""
        r = res_bc(x)
        rnorm = torch.sqrt(torch.sum(r * r))
        target = torch.clamp(self.newton_rtol * rnorm, min=self.newton_tol)
        eta = self._scalar(self.linear_rtol)
        k = lin = 0
        while k < self.newton_maxiter and bool(rnorm > target):
            dx, sinfo = solve(x, r, eta)
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
