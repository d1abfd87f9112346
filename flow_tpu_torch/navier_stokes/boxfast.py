# Box-packed 3-D projection stepper: the cavity3d hot path. Port of
# flow_tpu/navier_stokes/boxfast.py.
#
# Lagged BE/BDF2 rotational increment-form projection on the structured
# lattice operators of fem/boxpack.py: one BiCGStab momentum solve, a
# pressure Poisson CG on ops/structured.StructuredLaplacian preconditioned by
# the solvers/structured_mg V-cycle, and a mass-matrix CG velocity
# correction. The JAX package's lax.scan loops are Python loops here; the
# time step and the CFL controller stay on the device as 0-d tensors. Under
# torch.profiler each step shows as message.span ranges: flow.step holding
# flow.momentum, flow.pressure (one flow.vcycle a preconditioner call),
# flow.correction and flow.cfl, and each transfer that the host waits for
# as flow.sync.<site> (the Krylov and Picard stopping tests, run's host
# numbers).
from __future__ import annotations

from typing import NamedTuple

import torch

from ..fem import assembly
from ..fem.assembly import geometry
from ..fem.bc import combine_bcs
from ..fem.boxpack import BoxPack
from ..message import host_read, span, spanned
from ..solvers import krylov
from ..solvers.structured_mg import StructuredHierarchy
from ..utils.profiling import setup_phase

__all__ = ["BoxPackedStepper", "StepStats"]


class StepStats(NamedTuple):
    newton_iters: int
    newton_res: torch.Tensor
    linear_iters: int
    pressure_iters: int
    correction_iters: int
    pressure_converged: torch.Tensor
    correction_converged: torch.Tensor
    momentum_converged: torch.Tensor = None  # set by navier_stokes/fast.py


class BoxPackedStepper:
    """Projection stepper on a box_mesh P2/P1 pair (V, Q). Tables and state
    live on `device` in `dtype` (defaults: the mesh's); all setup runs in
    numpy on the host and its tables move to the device once. setup_seconds
    holds the seconds of building the BoxPack and the hierarchy (its
    lambda_max included), host clock between device syncs."""

    def __init__(
        self,
        V,
        Q,
        u_bcs,
        p_bcs,
        rho,
        mu,
        time_step_method="backward euler",
        newton_tol=0.0,
        newton_rtol=1.0e-2,
        linear_rtol=1.0e-1,
        pressure_rtol=1.0e-4,
        pressure_maxiter=600,
        correction_rtol=1.0e-5,
        cfl_target=1.0,
        dt_max=0.1,
        mg_smoother_degree=3,
        picard_maxiter=1,
        picard_tol=0.0,
        device=None,
        dtype=None,
    ):
        assert time_step_method in ("backward euler", "bdf2")
        assert not p_bcs, "box stepper: pure-Neumann pressure (cavity walls)"
        self.bdf2 = time_step_method == "bdf2"
        # picard>1: the Newton-contract mode (the lagged residual at T=x IS
        # the nonlinear residual)
        self.picard_maxiter = int(picard_maxiter)
        self.picard_tol = float(picard_tol)
        self.V_real, self.Q_real = V, Q
        mesh = V.mesh
        self.setup_seconds = {}
        with setup_phase(self.setup_seconds, "BoxPack"):
            self.bp = bp = BoxPack(mesh, dtype=dtype, device=device)
        self.device = bp.device
        self.dtype = dtype = bp.dtype
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

        # BC masks/values -> packed (pure permutation; no padding slots)
        mask_u, val_u = combine_bcs(V, u_bcs)
        self.mask_u = self.pack_vec(mask_u)
        self.val_u = self.pack_vec(val_u)

        geom = geometry(mesh)
        md = bp.to_packed(assembly.mass_diag(V, geom))
        sd = bp.to_packed(assembly.stiffness_diag(V, geom))
        self.mass_diag = torch.cat([md] * 3)
        self.stiff_diag = torch.cat([sd] * 3)

        # pressure operator/preconditioner on the standard P1 grid vector;
        # the Neumann hierarchy's finest operator is the pressure operator
        with setup_phase(self.setup_seconds, "hierarchy"):
            self.hierarchy = StructuredHierarchy(
                mesh, smoother_degree=mg_smoother_degree, device=self.device,
                dtype=dtype,
            )
        self.K1 = self.hierarchy.levels[-1].K
        self.pressure_precond = self.hierarchy.v_cycle
        self.ones_p = torch.ones(bp.n1, dtype=dtype, device=self.device)

    # -- state conversions -----------------------------------------------------
    def pack_vec(self, x):
        """Standard-order [n_dofs, 3] -> packed flat [3*n2]."""
        x = torch.as_tensor(x, dtype=self.dtype, device=self.device)
        return torch.cat([self.bp.to_packed(x[:, c]) for c in range(3)])

    def to_packed_state(self, U, P):
        return self.pack_vec(U), torch.as_tensor(P, dtype=self.dtype,
                                                 device=self.device)

    def from_packed_state(self, Uf, Pf):
        bp = self.bp
        U = torch.stack([bp.from_packed(c) for c in bp.comps(Uf)], dim=-1)
        return U, Pf

    def zeros(self):
        bp = self.bp
        return (
            torch.zeros(3 * bp.n2, dtype=self.dtype, device=self.device),
            torch.zeros(bp.n1, dtype=self.dtype, device=self.device),
        )

    def _scalar(self, v):
        """v as a 0-d tensor on the device. A host number (or host tensor)
        gets there by a copy that the host waits for on a card: a
        flow.sync.scalar read (run makes three a call: dt_max, the CFL
        target and t = 0)."""
        if torch.is_tensor(v) and v.device.type != "cpu":
            return torch.as_tensor(v, dtype=self.dtype, device=self.device)
        return host_read("scalar", torch.as_tensor, v, dtype=self.dtype,
                         device=self.device)

    def step(self, Uf, Pf, dt):
        """One projection step -> (U1, P1, StepStats)."""
        return self._step_impl(Uf, Pf, self._scalar(dt))

    def step_api(self, Uf, Pf, dt, Ff=None):
        """One step, optionally with a packed nodal body force."""
        return self._step_impl(Uf, Pf, self._scalar(dt), Ff=Ff)

    # -- inner products (no replication -> plain sums) --------------------------
    @staticmethod
    def dotv(x, y):
        return torch.dot(x, y)

    # -- momentum --------------------------------------------------------------
    def _mom_operator(self, Tf, dt):
        s = dt / self.rho
        return self.bp.momentum_operator(Tf, s * self.mu, s * self.rho)

    def _mom_rhs(self, Uf, Pf, dt, Ff=None):
        bp = self.bp
        s = dt / self.rho
        r = bp.mass_apply_vec(Uf if Ff is None else Uf + s * Ff)
        return r + s * bp.pressure_grad_rhs(Pf)

    def _mom_krylov(self, A, b, M, rtol, atol):
        return krylov.bicgstab(
            A, b, M=M, rtol=rtol, atol=atol, maxiter=300, dot=self.dotv
        )

    # -- BDF2 via the u_hat trick ----------------------------------------------
    @staticmethod
    def _bdf2_hat(U, Um1, dt, dtp):
        r = dt / dtp
        uhat = ((1.0 + r) ** 2 * U - r * r * Um1) / (1.0 + 2.0 * r)
        dt_eff = dt * (1.0 + r) / (1.0 + 2.0 * r)
        return uhat, dt_eff, r

    def _step_impl_bdf2(self, Uf, Um1, Pf, dt, dtp, Ff=None):
        uhat, dt_eff, r = self._bdf2_hat(Uf, Um1, dt, dtp)
        x0 = (1.0 + r) * Uf - r * Um1
        return self._step_impl(uhat, Pf, dt_eff, transport=x0, Ff=Ff)

    # -- one projection step ----------------------------------------------------
    def _step_impl(self, Uf, Pf, dt, transport=None, Ff=None):
        with span("flow.momentum"):
            Ui, nres, n_nonlin, lin_iters = self._momentum(Uf, Pf, dt,
                                                           transport, Ff)
        P1, pinfo = self._pressure_solve(Ui, Pf, dt)
        U1, cinfo = self._correction(Ui, P1, Pf, dt)
        return U1, P1, StepStats(
            n_nonlin, nres, lin_iters, pinfo.iters,
            cinfo.iters, pinfo.converged, cinfo.converged,
        )

    # -- substep 1: tentative velocity ------------------------------------------
    def _momentum(self, Uf, Pf, dt, transport, Ff):
        """-> (Ui, residual norm, nonlinear iterations, Krylov
        iterations)."""
        rho, mu = self.rho, self.mu
        free = 1.0 - self.mask_u
        x0 = free * (Uf if transport is None else transport) \
            + self.mask_u * self.val_u
        rhs = self._mom_rhs(Uf, Pf, dt, Ff=Ff)
        diag = self.mass_diag + (dt / rho) * (2.0 * mu) * self.stiff_diag
        diag = free * diag + self.mask_u

        def residual_and_solve(x, rtol, atol):
            A_raw = self._mom_operator(x, dt)

            def A_bc(v):
                return free * A_raw(v) + self.mask_u * v

            r = free * (A_raw(x) - rhs) + self.mask_u * (x - self.val_u)
            dx, sinfo = self._mom_krylov(
                A_bc, -r, lambda t: t / diag, rtol, atol
            )
            return x + dx, sinfo

        if self.picard_maxiter <= 1:
            Ui, sinfo = residual_and_solve(
                x0, self.newton_rtol,
                0.05 * self.newton_tol if self.newton_tol else 0.0,
            )
            nres = sinfo.resnorm
            n_nonlin = 1
            lin_iters = sinfo.iters
        else:
            tol = self.picard_tol

            def res_norm(x):
                A_raw = self._mom_operator(x, dt)
                r = free * (A_raw(x) - rhs) + self.mask_u * (x - self.val_u)
                return torch.sqrt(self.dotv(r, r))

            Ui, nres, n_nonlin, lin_iters = x0, res_norm(x0), 0, 0
            while (host_read("picard", bool, nres > tol)
                   and n_nonlin < self.picard_maxiter):
                Ui, sinfo = residual_and_solve(Ui, self.linear_rtol, 0.05 * tol)
                nres = res_norm(Ui)
                n_nonlin += 1
                lin_iters += sinfo.iters
        return Ui, nres, n_nonlin, lin_iters

    # -- substep 2: pressure Poisson (increment form, rotational) ---------------
    @spanned("flow.pressure")
    def _pressure_solve(self, Ui, Pf, dt):
        bp = self.bp
        L2 = -(self.rho / dt) * bp.div_rhs(Ui) - self.mu * bp.grad_div_rhs(Ui)
        phi, sinfo = krylov.cg(
            self.K1, L2, M=self.pressure_precond,
            rtol=self.pressure_rtol, maxiter=self.pressure_maxiter,
            nullspace=[self.ones_p], dot=self.dotv,
        )
        return Pf + phi, sinfo

    # -- substep 3: velocity correction (increment form, rotational) ------------
    @spanned("flow.correction")
    def _correction(self, Ui, P1, Pf, dt):
        bp = self.bp
        phi = P1 - Pf
        div_part = bp.grad_div_cell(Ui)
        free = 1.0 - self.mask_u

        def M_bc(u):
            return free * bp.mass_apply_vec(free * u) + self.mask_u * u

        diag = free * self.mass_diag + self.mask_u
        L3 = -(dt / self.rho) * bp.grad_phi_rhs(
            phi, div_part=div_part, mu=self.mu
        )
        dmask = self.mask_u * (self.val_u - Ui)
        rhs = free * (L3 - bp.mass_apply_vec(dmask)) + dmask
        d, sinfo = krylov.cg(
            M_bc, rhs, M=lambda r: r / diag, rtol=self.correction_rtol,
            maxiter=500, dot=self.dotv,
        )
        return Ui + d, sinfo

    # -- time loop with the CFL controller -------------------------------------
    def _next_dt(self, U1, dt, dt_cap, cfl):
        cs = self.bp.comps(U1)
        umax = torch.sqrt(torch.max(cs[0] ** 2 + cs[1] ** 2 + cs[2] ** 2))
        target_dt = cfl * self.hmax / torch.clamp(umax, min=1e-30)
        return torch.minimum(
            dt_cap,
            dt * torch.clamp(1.0 + 0.5 * (target_dt - dt) / dt, max=2.0),
        )

    def run(self, Uf, Pf, dt0, n_steps, Um1=None, dtp0=None):
        """n_steps steps with the CFL controller -> (Uf, Pf, dt, telemetry);
        telemetry maps t, dt and the per-step iteration counts to [n_steps]
        tensors. BDF2 starts from Um1 (default Uf) and dtp0 (default dt0)."""
        dt_cap = self._scalar(self.dt_max)
        cfl = self._scalar(self.cfl_target)
        dt = self._scalar(dt0)
        t = self._scalar(0.0)
        if self.bdf2:
            Um1 = Uf if Um1 is None else Um1
            dtp = dt if dtp0 is None else self._scalar(dtp0)
        rows = []
        for _ in range(n_steps):
            with span("flow.step"):
                if self.bdf2:
                    U1, P1, stats = self._step_impl_bdf2(Uf, Um1, Pf, dt, dtp)
                    Um1, dtp = Uf, dt
                else:
                    U1, P1, stats = self._step_impl(Uf, Pf, dt)
                with span("flow.cfl"):
                    t = t + dt
                    rows.append((t, dt, stats))
                    dt = self._next_dt(U1, dt, dt_cap, cfl)
                Uf, Pf = U1, P1
        telemetry = {
            "t": torch.stack([r[0] for r in rows]),
            "dt": torch.stack([r[1] for r in rows]),
        }
        for key in ("newton_iters", "linear_iters", "pressure_iters",
                    "correction_iters"):
            telemetry[key] = torch.tensor(
                [getattr(r[2], key) for r in rows], dtype=torch.int64
            )
        return Uf, Pf, dt, telemetry
