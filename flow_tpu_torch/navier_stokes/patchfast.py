# The packed-patch projection stepper: the Karman benchmark's main path.
# Port of flow_tpu/navier_stokes/patchfast.py (PackedPatchStepper).
#
# Lagged (semi-implicit) convection, backward Euler or variable-step BDF2
# (as backward Euler from u_hat, fast.py's lineage), rotational incremental
# pressure correction in increment form, every operator from the packed
# patch layouts of fem/patchpack.py:
#   1. tentative velocity: one affine momentum solve (picard_maxiter > 1:
#      refreeze the transport until the momentum residual <= picard_tol),
#      GMRES in the sqrt-weight-conjugated metric or BiCGStab in the
#      weighted one, Jacobi-preconditioned; the matvec is the EMA tangent
#      (PackedPatch.ema_S once per solve, ema_volume_apply per matvec) plus
#      the ds-term tangents (PackedBoundary);
#   2. pressure Poisson: CG on the packed P1 stiffness, preconditioned by
#      the PackedPatchP1Hierarchy V-cycle;
#   3. velocity correction: Jacobi CG on the packed P2 vector mass.
# The JAX package's lax.scan and lax.while_loop are Python loops here; the
# time step and the CFL controller stay on the device as 0-d tensors. The
# momentum solver is a constructor argument (the JAX package's
# FLOW_MOM_SOLVER environment variable is not read), and there is no
# hoisting of constants (the JAX package's TPU-only FLOW_NO_HOIST path).
from __future__ import annotations

import time

import torch

from ..fem import assembly
from ..fem.assembly import BoundaryTab, geometry
from ..fem.bc import combine_bcs
from ..fem.patch import PatchInfo
from ..fem.patchpack import PackedBoundary, PackedPatch, PackedPatchP1Hierarchy
from ..solvers import krylov
from .boxfast import StepStats

__all__ = ["PackedPatchStepper"]


class PackedPatchStepper:
    """Projection stepper on the packed patch layouts of `info`'s hierarchy
    (fem/patch.build_patch_info of the problem's refine_uniform chain), for
    the P2/P1 pair (V, Q) on its finest mesh.

    step(Uf, Pf, dt)        -> (U1f, P1f, StepStats), one step
    run(Uf, Pf, dt0, n)     -> (Uf, Pf, dt, telemetry), n steps with the CFL
                               controller; BDF2 also returns (Um1, dtp)

    State is packed: Uf [2 * n2] (component-major), Pf [n1];
    to_packed_state/from_packed_state convert from/to the global layout
    (U [n_V, 2], P [n_Q]). Tables and state live on `device` in `dtype`
    (defaults: the finest mesh's). The pressure preconditioner is
    `hierarchy.v_cycle` (pressure_precond). forces_probe: a callable
    (U1, P1) -> [2] on the global layout, or with needs_history
    (U1, P1, U0, dt) -> [2] (navier_stokes/forces.py). setup_seconds holds
    the host seconds of building the PackedPatch and the hierarchy.
    """

    def __init__(
        self,
        V,
        Q,
        u_bcs,
        p_bcs,
        rho,
        mu,
        info: PatchInfo,
        time_step_method="backward euler",
        newton_tol=0.0,
        newton_rtol=1.0e-2,
        linear_rtol=1.0e-1,
        pressure_rtol=3.0e-4,
        pressure_maxiter=600,
        correction_rtol=1.0e-4,
        cfl_target=1.0,
        dt_max=1.0,
        momentum_solver="gmres",
        gmres_restart=32,
        mg_smoother_degree=3,
        forces_probe=None,
        rotational_form=True,
        picard_maxiter=1,
        picard_tol=0.0,
        device=None,
        dtype=None,
    ):
        if time_step_method not in ("backward euler", "bdf2"):
            raise ValueError(f"PackedPatchStepper: unknown time_step_method "
                             f"{time_step_method!r}")
        if momentum_solver not in ("gmres", "bicgstab"):
            raise ValueError(f"PackedPatchStepper: unknown momentum_solver "
                             f"{momentum_solver!r}")
        self.bdf2 = time_step_method == "bdf2"
        self.rotational = bool(rotational_form)
        # picard_maxiter > 1: refreeze the lagged transport at each iterate
        # until the momentum residual <= picard_tol (the lagged residual at
        # T = x is the nonlinear residual)
        self.picard_maxiter = int(picard_maxiter)
        self.picard_tol = float(picard_tol)
        self.V_real, self.Q_real = V, Q
        mesh = V.mesh
        t0 = time.perf_counter()
        self.pp = pp = PackedPatch(info, dtype=dtype, device=device)
        self.setup_seconds = {"PackedPatch": time.perf_counter() - t0}
        self.device = pp.device
        self.dtype = dtype = pp.dtype
        self.rho, self.mu = float(rho), float(mu)
        self.hmax = mesh.hmax
        self.newton_tol = newton_tol
        self.newton_rtol = newton_rtol
        self.linear_rtol = linear_rtol
        self.pressure_rtol = pressure_rtol
        self.pressure_maxiter = pressure_maxiter
        self.correction_rtol = correction_rtol
        self.cfl_target = cfl_target
        self.dt_max = dt_max
        self.mom_solver = momentum_solver
        self.gmres_restart = gmres_restart
        self.forces_probe = forces_probe

        # BC masks/values -> packed, the padding pinned as Dirichlet-0 rows
        mask_u, val_u = combine_bcs(V, u_bcs)
        self.has_p_bcs = bool(p_bcs)
        self.mask_u = self.pack_vec(mask_u, pad_val=1.0)
        self.val_u = self.pack_vec(val_u)
        pad1 = 1.0 - pp.lay1.valid_t
        if self.has_p_bcs:
            mask_p, val_p = combine_bcs(Q, p_bcs)
            self.mask_p = pp.lay1.to_packed(mask_p) + pad1
            self.val_p = pp.lay1.to_packed(val_p)
        else:
            self.mask_p = pad1
            self.val_p = torch.zeros(pp.n1, dtype=dtype, device=self.device)

        # Jacobi diagonals (global -> packed; exact one-time setup)
        geom = geometry(mesh)
        md = pp.lay2.to_packed(assembly.mass_diag(V, geom))
        sd = pp.lay2.to_packed(assembly.stiffness_diag(V, geom))
        self.mass_diag = torch.cat([md, md])
        self.stiff_diag = torch.cat([sd, sd])

        # boundary tabulations (ds-terms; O(surface))
        self.bt = PackedBoundary(BoundaryTab(V, rule_degree=6, dtype=dtype,
                                             device=self.device), pp.lay2)
        self.btQ = PackedBoundary(BoundaryTab(Q, rule_degree=6, dtype=dtype,
                                              device=self.device), pp.lay1)

        t0 = time.perf_counter()
        self.hierarchy = PackedPatchP1Hierarchy(
            info, bc_mask=self.mask_p if self.has_p_bcs else None,
            smoother_degree=mg_smoother_degree, dtype=dtype, device=self.device,
        )
        self.setup_seconds["hierarchy"] = time.perf_counter() - t0
        self.pressure_precond = self.hierarchy.v_cycle

        # the replicated layout's metric
        w2 = pp.lay2.weight_t
        self.wvec = torch.cat([w2, w2])
        self._sqrtw = torch.sqrt(torch.where(self.wvec > 0, self.wvec,
                                             torch.ones_like(self.wvec)))
        self.w1 = pp.lay1.weight_t

    # -- inner products --------------------------------------------------------
    def dotv(self, x, y):
        return torch.sum(self.wvec * x * y)

    def dotp(self, x, y):
        return torch.sum(self.w1 * x * y)

    # -- state conversions -----------------------------------------------------
    def pack_vec(self, x, pad_val=0.0):
        """Global [n_V, 2] (tensor or numpy) -> packed flat [2 * n2];
        pad_val on the padding slots."""
        lay = self.pp.lay2
        x = torch.as_tensor(x, dtype=self.dtype, device=self.device)
        out = torch.cat([lay.to_packed(x[:, 0]), lay.to_packed(x[:, 1])])
        if pad_val:
            out = out + pad_val * torch.cat([1.0 - lay.valid_t] * 2)
        return out

    def to_packed_state(self, U, P):
        return self.pack_vec(U), self.pp.lay1.to_packed(P)

    def from_packed_state(self, Uf, Pf):
        lay = self.pp.lay2
        U = Uf.view(2, lay.n_flat)[:, lay.slot_of_dof_t].T.contiguous()
        return U, self.pp.lay1.from_packed(Pf)

    def zeros(self):
        pp = self.pp
        return (
            torch.zeros(2 * pp.n2, dtype=self.dtype, device=self.device),
            torch.zeros(pp.n1, dtype=self.dtype, device=self.device),
        )

    def _scalar(self, v):
        return torch.as_tensor(v, dtype=self.dtype, device=self.device)

    def step(self, Uf, Pf, dt):
        """One projection step -> (U1f, P1f, StepStats)."""
        return self._step_impl(Uf, Pf, self._scalar(dt))

    def step_api(self, Uf, Pf, dt, Ff=None):
        """One step, optionally with a packed nodal body force Ff [2 * n2]."""
        return self._step_impl(Uf, Pf, self._scalar(dt), Ff=Ff)

    # -- momentum operator (lagged, affine) ------------------------------------
    def _mom_operator(self, Tf, dt):
        """x -> A x: the lagged tangent at the frozen transport Tf (volume
        EMA + ds tangents)."""
        pp, bt = self.pp, self.bt
        rho, mu = self.rho, self.mu
        s = dt / rho
        S = pp.ema_S(Tf, s * mu, s * rho)
        tn = torch.einsum("bqm,bm->bq", bt.values_vec(Tf), bt.normals)
        tnp = torch.clamp(tn, min=0.0)[:, :, None]

        def A(xf):
            av = pp.ema_volume_apply(S, xf, s * mu)
            # ds tangents: mu (grad x)^T n (linear) and the directional
            # do-nothing term -(rho/2)(T.n)+ x (frozen transport)
            val = mu * torch.einsum("bqma,bm->bqa", bt.grads_vec(xf), bt.normals)
            val = val - 0.5 * rho * tnp * bt.values_vec(xf)
            return av - s * bt.integrate_rhs_vec(val)

        return A

    def _mom_rhs(self, Uf, Pf, dt, Ff=None):
        """M u0 + s [pg(P) + bnd_P(P) + F] with s = dt / rho; Ff is the
        nodal P2 body force (packed), whose functional is M Ff."""
        pp, bt = self.pp, self.bt
        s = dt / self.rho
        r = pp.mass_apply_vec(Uf if Ff is None else Uf + s * Ff)
        r = r + s * pp.pressure_grad_rhs(Pf)
        val = -self.btQ.values_scalar(Pf)[:, :, None] * bt.normals[:, None, :]
        return r + s * bt.integrate_rhs_vec(val)

    def _mom_krylov(self, A, b, M, rtol, atol):
        if self.mom_solver == "gmres":
            # GMRES's projections are plain sums: solve in the sqrt(w)
            # conjugated variables, whose plain metric is the weighted one
            sw = self._sqrtw

            def A2(v):
                return sw * A(v / sw)

            def M2(v):
                return sw * M(v / sw)

            x2, sinfo = krylov.gmres(A2, sw * b, M=M2, rtol=rtol, atol=atol,
                                     maxiter=300, restart=self.gmres_restart)
            return x2 / sw, sinfo
        return krylov.bicgstab(A, b, M=M, rtol=rtol, atol=atol, maxiter=300,
                               dot=self.dotv)

    # -- BDF2 as backward Euler from a modified state --------------------------
    @staticmethod
    def _bdf2_hat(U, Um1, dt, dtp):
        r = dt / dtp
        uhat = ((1.0 + r) ** 2 * U - r * r * Um1) / (1.0 + 2.0 * r)
        dt_eff = dt * (1.0 + r) / (1.0 + 2.0 * r)
        return uhat, dt_eff, r

    def _step_impl_bdf2(self, Uf, Um1, Pf, dt, dtp, Ff=None):
        uhat, dt_eff, r = self._bdf2_hat(Uf, Um1, dt, dtp)
        # the second-order extrapolated transport
        x0 = (1.0 + r) * Uf - r * Um1
        return self._step_impl(uhat, Pf, dt_eff, transport=x0, Ff=Ff)

    # -- one projection step ---------------------------------------------------
    def _step_impl(self, Uf, Pf, dt, transport=None, Ff=None):
        rho, mu = self.rho, self.mu
        mask, val = self.mask_u, self.val_u
        free = 1.0 - mask
        x0 = free * (Uf if transport is None else transport) + mask * val
        rhs = self._mom_rhs(Uf, Pf, dt, Ff=Ff)
        diag = self.mass_diag + (dt / rho) * (2.0 * mu) * self.stiff_diag
        diag = free * diag + mask

        def residual(A_raw, x):
            return free * (A_raw(x) - rhs) + mask * (x - val)

        def residual_and_solve(x, rtol, atol):
            A_raw = self._mom_operator(x, dt)

            def A_bc(v):
                return free * A_raw(v) + mask * v

            dx, sinfo = self._mom_krylov(A_bc, -residual(A_raw, x),
                                         lambda t: t / diag, rtol, atol)
            return x + dx, sinfo

        if self.picard_maxiter <= 1:
            # the bench path: one affine (lagged) solve
            Ui, sinfo = residual_and_solve(
                x0, self.newton_rtol,
                0.05 * self.newton_tol if self.newton_tol else 0.0,
            )
            nres, n_nonlin, lin_iters = sinfo.resnorm, 1, sinfo.iters
            mconv = sinfo.converged
        else:
            tol = self.picard_tol

            def res_norm(x):
                r = residual(self._mom_operator(x, dt), x)
                return torch.sqrt(self.dotv(r, r))

            Ui, nres, n_nonlin, lin_iters = x0, res_norm(x0), 0, 0
            while bool(nres > tol) and n_nonlin < self.picard_maxiter:
                Ui, sinfo = residual_and_solve(Ui, self.linear_rtol, 0.05 * tol)
                nres = res_norm(Ui)
                n_nonlin += 1
                lin_iters += sinfo.iters
            mconv = nres <= tol

        P1, pinfo = self._pressure_solve(Ui, Pf, dt)
        U1, cinfo = self._correction(Ui, P1, Pf, dt)
        return U1, P1, StepStats(n_nonlin, nres, lin_iters, pinfo.iters,
                                 cinfo.iters, pinfo.converged, cinfo.converged,
                                 mconv)

    # -- substep 2: pressure Poisson (increment form; rotational opt.) --------
    def _pressure_solve(self, Ui, Pf, dt):
        pp = self.pp
        L2 = -(self.rho / dt) * pp.div_rhs(Ui)
        if self.rotational:
            L2 = L2 - self.mu * pp.grad_div_rhs(Ui)
        K = pp.p1_stiffness_apply
        if self.has_p_bcs:
            mask = self.mask_p
            free = 1.0 - mask

            def K_bc(p):
                return free * K(free * p) + mask * p

            pin = mask * (self.val_p - Pf)
            rhs = free * (L2 - K(pin)) + pin
            phi, sinfo = krylov.cg(
                K_bc, rhs, M=self.pressure_precond, rtol=self.pressure_rtol,
                maxiter=self.pressure_maxiter, dot=self.dotp,
            )
        else:
            phi, sinfo = krylov.cg(
                K, L2, M=self.pressure_precond, rtol=self.pressure_rtol,
                maxiter=self.pressure_maxiter, nullspace=[pp.lay1.valid_t],
                dot=self.dotp,
            )
        return Pf + phi, sinfo

    def _pressure_solve_mg(self, Ui, Pf, dt):
        """The pressure substep -> (P1, iterations): the bench's Poisson
        axis."""
        P1, sinfo = self._pressure_solve(Ui, Pf, dt)
        return P1, sinfo.iters

    def bench_residual(self, x, Uf, Pf, dt):
        """One full momentum residual evaluation (operator and right-hand
        side): the bench's assembly axis."""
        dt = self._scalar(dt)
        free = 1.0 - self.mask_u
        A_raw = self._mom_operator(x, dt)
        rhs = self._mom_rhs(Uf, Pf, dt)
        return free * (A_raw(x) - rhs) + self.mask_u * (x - self.val_u)

    # -- substep 3: velocity correction (increment form; rotational opt.) -----
    def _correction(self, Ui, P1, Pf, dt):
        pp = self.pp
        mask, free = self.mask_u, 1.0 - self.mask_u
        div_part = pp.grad_div_cell(Ui) if self.rotational else None

        def M_bc(u):
            return free * pp.mass_apply_vec(free * u) + mask * u

        diag = free * self.mass_diag + mask
        L3 = -(dt / self.rho) * pp.grad_phi_rhs(P1 - Pf, div_part=div_part,
                                                 mu=self.mu)
        dmask = mask * (self.val_u - Ui)
        rhs = free * (L3 - pp.mass_apply_vec(dmask)) + dmask
        d, sinfo = krylov.cg(M_bc, rhs, M=lambda r: r / diag,
                             rtol=self.correction_rtol, maxiter=500,
                             dot=self.dotv)
        return Ui + d, sinfo

    # -- time loop with the CFL controller -------------------------------------
    def _next_dt(self, U1, dt, dt_cap, cfl):
        a, b = self.pp.comps(U1)
        umax = torch.sqrt(torch.max(a * a + b * b))
        target_dt = cfl * self.hmax / torch.clamp(umax, min=1e-30)
        return torch.minimum(
            dt_cap,
            dt * torch.clamp(1.0 + 0.5 * (target_dt - dt) / dt, max=2.0),
        )

    def run(self, Uf, Pf, dt0, n_steps, Um1=None, dtp0=None, dt_max=None,
            cfl_target=None):
        """n_steps steps with the CFL controller -> (Uf, Pf, dt, telemetry);
        BDF2 also returns (Um1, dtp), which continue a run at full order
        when passed back (the defaults Um1 = Uf, dtp = dt0 start it).
        dt_max and cfl_target override the constructor's for this run.

        telemetry maps t, dt, the per-step iteration counts (the JAX
        stepper's keys), the convergence flags of the three solves and,
        with a forces probe, forces [n_steps, 2] to tensors."""
        dt_cap = self._scalar(self.dt_max if dt_max is None else dt_max)
        cfl = self._scalar(self.cfl_target if cfl_target is None else cfl_target)
        dt = self._scalar(dt0)
        t = self._scalar(0.0)
        if self.bdf2:
            Um1 = Uf if Um1 is None else Um1
            dtp = dt if dtp0 is None else self._scalar(dtp0)
        probe = self.forces_probe
        history = getattr(probe, "needs_history", False)
        rows = []
        for _ in range(n_steps):
            if self.bdf2:
                U1, P1, stats = self._step_impl_bdf2(Uf, Um1, Pf, dt, dtp)
            else:
                U1, P1, stats = self._step_impl(Uf, Pf, dt)
            t = t + dt
            forces = None
            if probe is not None:
                Ug, Pg = self.from_packed_state(U1, P1)
                if history:
                    # (u_hat, dt_eff) for BDF2: (U1 - u_hat) / dt_eff is the
                    # variable-step BDF2 derivative
                    U0, dt0_ = (self._bdf2_hat(Uf, Um1, dt, dtp)[:2]
                                if self.bdf2 else (Uf, dt))
                    forces = probe(Ug, Pg, self.from_packed_state(U0, Pf)[0], dt0_)
                else:
                    forces = probe(Ug, Pg)
            rows.append((t, dt, stats, forces))
            dt_new = self._next_dt(U1, dt, dt_cap, cfl)
            if self.bdf2:
                Um1, dtp = Uf, dt
            Uf, Pf, dt = U1, P1, dt_new
        telemetry = {
            "t": torch.stack([r[0] for r in rows]),
            "dt": torch.stack([r[1] for r in rows]),
        }
        if probe is not None:
            telemetry["forces"] = torch.stack([r[3] for r in rows])
        for key in ("momentum_converged", "pressure_converged",
                    "correction_converged"):
            telemetry[key] = torch.stack([torch.as_tensor(getattr(r[2], key))
                                          for r in rows])
        for key in ("newton_iters", "linear_iters", "pressure_iters",
                    "correction_iters"):
            telemetry[key] = torch.tensor([getattr(r[2], key) for r in rows],
                                          dtype=torch.int64)
        if self.bdf2:
            return Uf, Pf, dt, telemetry, (Um1, dtp)
        return Uf, Pf, dt, telemetry
