# The projection stepper of the Karman benchmark path and of the 3-D cavity
# driver, on triangles or tets. Port of
# flow_tpu/navier_stokes/fast.py::FastStepper.
#
# Routes and layouts:
# - the einsum route (winkernel=False, the JAX package's default), in the
#   spaces' layout (U [n_V, dim]):
#   1. tentative velocity:
#      - Newton (the default): a Newton loop on the nonlinear residual; each
#        iteration one Krylov solve whose matvec is the exact tangent,
#        written out (mass, c(x; v) + c(v; x), stress, ds-terms) in place of
#        jax.linearize / jax.jvp: tangent_mode="linearize" keeps x's
#        quadrature-point values and gradients for the whole iteration,
#        "jvp" recomputes them in every matvec; or, with
#        assembled_jacobian=True, the block-ELL Jacobian (fem/ell.ELLGraph)
#        rebuilt once a Newton iteration (it leaves out the do-nothing
#        term's Jacobian, as the JAX one does);
#      - lagged: the transport frozen at the initial guess; one Krylov solve
#        whose matvec is the element-matrix (EMA) tangent, a scalar
#        [nc, nl, nl] tensor (mass + viscous + lagged convection) built once
#        per step plus the factored stress coupling and the ds-terms, or,
#        with lagged_ell=True (the JAX package's FLOW_LAGGED_ELL=1), the
#        exact assembled-ELL operator;
#   2. pressure Poisson in increment form: CG on the assembled ELL
#      stiffness (fem/ell.py, the P1/P2 kernels of csrc/ell.cu on the card);
#   3. velocity correction, Jacobi CG on the consistent vector mass;
# - the lane-packed layout (packed=True, or packed="auto" from
#   PACKED_MIN_DOFS on 2-D Taylor-Hood without the divergence probe, as
#   the JAX package resolves it): the same step on the flat component-major
#   state [2 n_V] through fem/packed.PackedContext, whose dof sums read
#   member tables; step/run take and return the spaces' layout. Its
#   residual, as the JAX package's, carries no explicit (w_ex) terms;
# - patch mode (patches=PatchInfo): the einsum route over the patch layout
#   (navier_stokes/patchctx.PatchNSContext): replicated flat states, window
#   gathers and overlap-add dof sums, the Krylov solves in the
#   replica-weighted inner product (GMRES by sqrt(weight) conjugation), the
#   pressure operator the factored stiffness apply; pair it with
#   solvers/patch_mg.PatchP1Hierarchy. step/run take either layout;
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
# The momentum solve is BiCGStab or GMRES(gmres_restart) with an optional
# reduced-precision basis (momentum_solver, gmres_restart, gmres_basis:
# the JAX package's FLOW_MOM_SOLVER, FLOW_GMRES_RESTART and
# FLOW_GMRES_BASIS), preconditioned by Jacobi or by the vertex correction
# (momentum_precond="vertex", 2-D P2, the einsum route in either layout).
# The pressure solve on any route is preconditioned by the caller's
# V-cycle, or, without one, is Jacobi CG on the exact stiffness.
#
# Time schemes: forward Euler, backward Euler, Crank-Nicolson and
# variable-step BDF2, which runs as a backward-Euler step from u_hat =
# ((1+r)^2 u_n - r^2 u_{n-1}) / (1+2r) with dt* = dt (1+r)/(1+2r),
# r = dt_n/dt_{n-1}, and the extrapolated initial guess (1+r) u_n - r u_{n-1}.
# divergence_probe=True adds ||div u||_L2 of every step to run()'s telemetry.
#
# The JAX package's lax.scan and lax.while_loop are Python loops here
# (run, the Newton loop): the Newton loop reads one boolean from the device
# per iteration; the time step and the CFL controller stay on the device as
# 0-d tensors. The JAX environment knobs are constructor arguments. Not
# ported: step_granular/run_granular and the hoisted-constant run
# (utils/hoist.py), TPU workarounds, and the JAX package's opt-in A/B knobs
# FLOW_MOM_WARMSTART, FLOW_ABS_SOLVES and FLOW_LAGGED_EMA=0.
from __future__ import annotations

import numpy as np
import torch

from ..fem import assembly, forms
from ..fem.bc import combine_bcs
from ..fem.gathersum import gather_sum_of
from ..mesh3d import _device
from ..solvers import krylov
from .boxfast import StepStats
from .pressure_correction import CONV_RULE, NSContext

__all__ = ["FastStepper", "PACKED_MIN_DOFS"]

_THETA = {
    "forward euler": (1.0, 0.0),
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
    `device` (defaults: the mesh's), on a triangle or a tet mesh (patch
    mode also takes and returns the patch layout). Set `pressure_precond`
    (a callable r -> z: P1Hierarchy.v_cycle in 2-D,
    StructuredHierarchy.v_cycle on a box mesh, PatchP1Hierarchy.v_cycle in
    patch mode) before stepping, or leave it None for Jacobi CG.
    forces_probe: a callable (U1, P1) -> [2], or with needs_history
    (U1, P1, U0, dt) -> [2] (navier_stokes/forces.py), whose values run()
    reports as telemetry["forces"]. winkernel, packed and patches select
    the route and layout (module header); K_Q is the pressure operator (an
    ELLMatrix on the einsum route, a WindowStiffnessOperator on the window
    route, None in patch mode). tangent_mode ("linearize" or "jvp", the
    JAX package's FLOW_TANGENT_MODE) sets whether the Newton tangent keeps
    the state's quadrature-point tables for a Newton iteration or
    recomputes them in every matvec. lagged_ell, ema_bf16, gmres_restart
    and gmres_basis are the JAX package's FLOW_LAGGED_ELL=1,
    FLOW_EMA_PREC=bf16, FLOW_GMRES_RESTART and FLOW_GMRES_BASIS=bf16
    (gmres_basis: a torch dtype or None). ema_bf16 keeps the JAX einsum
    layout's arithmetic in both layouts: S, v and the stress coupling's
    Kref in bfloat16, their products exact at the state's precision (the
    JAX packed layout multiplies S and v in bfloat16).
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
        lagged_ell=False,
        ema_bf16=False,
        gmres_restart=32,
        gmres_basis=None,
        device=None,
        dtype=None,
    ):
        if convection not in ("newton", "lagged"):
            raise ValueError(f"FastStepper: unknown convection {convection!r}")
        if tangent_mode not in ("linearize", "jvp"):
            raise ValueError(f"FastStepper: unknown tangent_mode {tangent_mode!r}")
        if time_step_method not in _THETA:
            raise ValueError(f"FastStepper: unknown time_step_method {time_step_method!r}")
        if momentum_solver not in ("bicgstab", "gmres"):
            raise ValueError(f"FastStepper: unknown momentum_solver {momentum_solver!r}")
        if momentum_precond not in (None, "vertex"):
            raise ValueError(f"FastStepper: unknown momentum_precond {momentum_precond!r}")
        mesh = V.mesh
        self.device = device = mesh.device if device is None else _device(device)
        self.dtype = dtype = mesh.dtype if dtype is None else dtype
        self.V_real, self.Q_real = V, Q
        self.patch = patches is not None
        if self.patch:
            from .patchctx import PatchNSContext

            if winkernel:
                raise ValueError("FastStepper: patch mode supersedes winkernel")
            if momentum_precond is not None:
                raise ValueError("FastStepper: patch mode has no vertex "
                                 "momentum preconditioner")
            if assembled_jacobian is True:
                raise ValueError("FastStepper: patch mode has no ELL Jacobian")
            self.ctx = ctx = PatchNSContext(patches, V, Q, dtype, device)
            V, Q = ctx.V, ctx.Q
            packed = False
        else:
            self.ctx = ctx = NSContext(V, Q, dtype, device)
        self.V, self.Q = V, Q
        self._pdot = ctx.dot if self.patch else None
        self._sqrtw_V = None
        if self.patch:
            # sqrt of the replica weight (1 on padding): conjugating the
            # momentum operator by it makes plain GMRES the weighted one
            w = V._weight
            self._sqrtw_V = torch.sqrt(torch.where(w > 0, w, torch.ones_like(w)))[:, None]
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
        self.divergence_probe = divergence_probe
        self.hmax = mesh.hmax
        self.winkernel = winkernel
        self.tangent_mode = tangent_mode
        self.mom_solver = momentum_solver
        self.gmres_restart = int(gmres_restart)
        self.gmres_basis = gmres_basis
        self.momentum_precond = momentum_precond

        def dev(a):
            return torch.as_tensor(a, dtype=dtype, device=device)

        mask_u, val_u = combine_bcs(self.V_real, u_bcs)
        self.mask_u, self.val_u = dev(mask_u), dev(val_u)
        self.has_p_bcs = bool(p_bcs)
        if self.has_p_bcs:
            mask_p, val_p = combine_bcs(self.Q_real, p_bcs)
            self.mask_p, self.val_p = dev(mask_p), dev(val_p)
        else:
            self.mask_p = torch.zeros(self.Q_real.n_dofs, dtype=dtype, device=device)
            self.val_p = self.mask_p
        if self.patch:
            # the patch layout, its padding slots pinned as Dirichlet-0 rows
            self.mask_u, self.val_u = ctx.mask_to_patch(V, self.mask_u, self.val_u)
            self.mask_p, self.val_p = ctx.mask_to_patch(Q, self.mask_p, self.val_p)

        # the pressure operator
        self.K_Q = None
        if self.patch:
            self._KQ_apply = lambda p: assembly.stiffness_apply(self.Q, ctx.geom, p)
        elif not winkernel:
            from ..fem.ell import ell_stiffness

            self.K_Q = ell_stiffness(Q, assembly.geometry(mesh), dtype=dtype, device=device)
            self._KQ_apply = self.K_Q.apply
        else:
            from ..attic.winkernel import WindowStiffnessOperator
            from ..attic.winmom import WindowLaggedMomentum

            # S=None sizes the windows from the RCM bandwidth
            self.winmom = op = WindowLaggedMomentum(V, S=winkernel_S, device=device)
            # the solve lives in the layout's permuted rows: BC rows and the
            # boundary facet tables are permuted once here
            self.mask_up = self.mask_u[op.perm]
            self.btab_perm = ctx.btab.permuted(op.wl.inv)
            self.Tq_zero = op.zero_transport()
            self.K_Q = WindowStiffnessOperator(Q, device=device)
            self._KQ_apply = self.K_Q.apply

        # the assembled block-ELL Newton Jacobian ("auto" resolves off, as
        # in the JAX package)
        self._mom_graph = None
        if assembled_jacobian is True and not winkernel:
            from ..fem.ell import ELLGraph, momentum_bnd_stress_ell_vals, momentum_const_ell

            hgeom = assembly.geometry(mesh)
            g = ELLGraph(V, device=device)
            mass_v, visc1_v, visc2_v = momentum_const_ell(V, hgeom, g)
            # the linear mu (grad u)^T n ds-term folds into the constant
            # viscous block (the residual subtracts it)
            visc2_v = visc2_v - momentum_bnd_stress_ell_vals(V, hgeom, ctx.btab, g)
            self._mom_graph = g
            self._mom_mass, self._mom_visc1, self._mom_visc2 = (
                dev(mass_v), dev(visc1_v), dev(visc2_v))

        # the exact assembled-ELL lagged operator (lagged_ell=True)
        self._lagmom_graph = None
        if self.lagged and not winkernel and not self.patch and lagged_ell:
            from ..fem.ell import (ELLGraph, FacetMassELL, momentum_bnd_stress_ell_vals,
                                   momentum_const_ell)

            hgeom = assembly.geometry(mesh)
            g = self._mom_graph if self._mom_graph is not None else ELLGraph(V, device=device)
            mass_v, visc1_v, visc2_v = momentum_const_ell(V, hgeom, g)
            visc2B = visc2_v - momentum_bnd_stress_ell_vals(V, hgeom, ctx.btab, g)
            self._lagmom_graph = g
            self._lagmom_mass, self._lagmom_visc1 = dev(mass_v), dev(visc1_v)
            self._lagmom_visc2 = dev(visc2B)
            eye_nw = (g.cols_np == np.arange(g.n)[:, None]) & g.valid_np
            dblk = (visc2B * eye_nw[:, :, None, None]).sum(axis=1)
            self._lagmom_dvisc2 = dev(np.einsum("naa->na", dblk))
            self._lagmom_fm = FacetMassELL(g, ctx.btab, dtype)

        self._lagged_ema = self.lagged and not winkernel and self._lagmom_graph is None
        self._ema_bf16 = self._lagged_ema and bool(ema_bf16)

        # packed="auto" as the JAX stepper resolves it: the lane-packed
        # layout for 2-D Taylor-Hood without the divergence probe from
        # PACKED_MIN_DOFS, never with the window kernels
        can_pack = (getattr(mesh, "dim", 2) == 2 and V.degree == 2 and Q.degree == 1
                    and not divergence_probe and not self.patch)
        if packed is True and not can_pack:
            raise ValueError("FastStepper: packed mode unavailable for this "
                             "configuration")
        big = 2 * V.n_dofs + Q.n_dofs >= PACKED_MIN_DOFS and not winkernel
        self.packed = bool((can_pack and big) if packed == "auto" else (packed and can_pack))
        if self.packed:
            from ..fem.packed import PackedContext

            self.pctx = pc = PackedContext(V, Q, conv_rule=CONV_RULE, dtype=dtype,
                                           device=device)
            self.mask_uf, self.val_uf = pc.pack(self.mask_u), pc.pack(self.val_u)
            self.mass_diag_f = pc.pack(ctx.mass_diag_V)
            self.stiff_diag_f = pc.pack(ctx.stiff_diag_V)
            if self._lagged_ema:
                self._ema_kscal_pk = pc.stiffness_scalar_pairs()
        elif self._lagged_ema:
            # the dense EMA tables: the constant scalar stiffness tensor and
            # the reference mass matrix
            self._ema_kscal = forms.stiffness_scalar_loc(V, ctx.geom)
            self._ema_mref = dev(assembly.ref_mass(V.degree, assembly._dim(V)))
        if momentum_precond == "vertex":
            self._build_vertex_precond()

    def zeros(self):
        """A zero state in the spaces' layout."""
        return (
            torch.zeros((self.V_real.n_dofs, self.V_real.n_components),
                        dtype=self.dtype, device=self.device),
            torch.zeros(self.Q_real.n_dofs, dtype=self.dtype, device=self.device),
        )

    def _scalar(self, v):
        return torch.as_tensor(v, dtype=self.dtype, device=self.device)

    def _ssq(self, r):
        """The squared residual norm (replica-weighted in patch mode)."""
        return self._pdot(r, r) if self._pdot is not None else torch.sum(r * r)

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

    def _step_impl(self, U, P, dt, x0=None):
        if self.patch and U.shape[0] == self.V_real.n_dofs:
            # the spaces' layout: convert at the seam
            Vp, Qp = self.V, self.Q
            U1, P1, stats = self._step_impl_dense(
                Vp.to_patch(U), Qp.to_patch(P), dt, None if x0 is None else Vp.to_patch(x0))
            return Vp.from_patch(U1), Qp.from_patch(P1), stats
        if self.packed:
            if U.dim() == 2:  # the public [n, 2] layout
                pc = self.pctx
                U1f, P1, stats = self._step_impl_pk(
                    pc.pack(U), P, dt, None if x0 is None else pc.pack(x0))
                return pc.unpack(U1f), P1, stats
            return self._step_impl_pk(U, P, dt, x0)
        return self._step_impl_dense(U, P, dt, x0)

    # -- the momentum Krylov solve ------------------------------------------------
    def _mom_krylov(self, A, b, M, rtol, maxiter=300):
        atol = 0.05 * self.newton_tol
        if self.mom_solver == "gmres":
            restart = min(self.gmres_restart, maxiter)
            if self._sqrtw_V is not None:
                # the weighted-metric GMRES by sqrt(W) conjugation: plain
                # inner products then reproduce the un-replicated iteration
                sw = self._sqrtw_V
                x2, sinfo = krylov.gmres(
                    lambda v: sw * A(v / sw), sw * b, M=lambda v: sw * M(v / sw),
                    rtol=rtol, atol=atol, maxiter=maxiter, restart=restart,
                    basis_dtype=self.gmres_basis,
                )
                return x2 / sw, sinfo
            return krylov.gmres(A, b, M=M, rtol=rtol, atol=atol, maxiter=maxiter,
                                restart=restart, basis_dtype=self.gmres_basis,
                                dot=self._pdot)
        return krylov.bicgstab(A, b, M=M, rtol=rtol, atol=atol, maxiter=maxiter,
                               dot=self._pdot)

    # -- substep 1, the spaces' (or the patch) layout --------------------------
    def _step_impl_dense(self, U, P, dt, x0=None):
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
            if self.momentum_precond == "vertex":
                M_mom = self._vertex_precond_M(U, dt, free, diag)
            else:
                def M_mom(t):
                    return t / diag
            solve_lagged, solve_newton = self._einsum_solves(dt, M_mom)
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
        lagged skew convection, built once per step (ema_bf16: stored in
        bfloat16)."""
        V, geom = self.V, self.ctx.geom
        s = (dt / self.rho) * self.theta[1]
        conv = forms.conv_lagged_jacobian_loc(V, geom, V.gather(x0),
                                              rule_degree=CONV_RULE)
        S = (geom.detJ[:, None, None] * self._ema_mref
             + (s * self.mu) * self._ema_kscal + (s * self.rho) * conv)
        return S.to(torch.bfloat16) if self._ema_bf16 else S

    def _ema_Jv(self, S, x0, dt):
        """The lagged residual's tangent v -> J v (BC rows included) through
        the element matrices S (_ema_S): one gather, one [nl, nl] product per
        cell, the factored stress coupling, one dof sum, and the ds-term
        tangents with the transport x0."""
        V, geom, mu = self.V, self.ctx.geom, self.mu
        mask, free = self.mask_u, 1.0 - self.mask_u
        s = (dt / self.rho) * self.theta[1]
        bnd = self._bnd_tangent(x0)
        kd = S.dtype if self._ema_bf16 else None

        def Jv(v):
            vloc = V.gather(v)
            if self._ema_bf16:
                # v and the stress coupling's Kref rounded to S's precision,
                # the products exact in v's
                vloc = vloc.to(S.dtype).to(v.dtype)
            loc = torch.einsum("eij,eja->eia", S.to(v.dtype), vloc)
            loc = loc + (s * mu) * forms.sym_grad_transpose_loc(V, geom, vloc, kref_dtype=kd)
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

    def _assembled_Jv(self, x, dt):
        """The block-ELL Newton Jacobian at x (assembled_jacobian=True):
        the convection element Jacobian assembled once per Newton iteration
        on top of the constant mass, viscous and stress-ds blocks; each
        matvec one row gather (the do-nothing term's Jacobian is left out,
        as in the JAX package)."""
        V, g = self.V, self._mom_graph
        s = (dt / self.rho) * self.theta[1]
        conv_el = forms.conv_jacobian_loc(V, self.ctx.geom, V.gather(x),
                                          rule_degree=CONV_RULE)
        vals = (s * self.rho) * g.assemble(conv_el) + (s * self.mu) * self._mom_visc2
        sc = self._mom_mass + (s * self.mu) * self._mom_visc1
        vals = vals + sc[:, :, None, None] * torch.eye(vals.shape[-1], dtype=vals.dtype,
                                                       device=vals.device)
        free = 1.0 - self.mask_u

        def Jv(v):
            return free * g.apply(vals, v) + self.mask_u * v

        return Jv

    def _lagged_ell_Jv(self, x0, dt):
        """The exact assembled-ELL lagged operator at the transport x0
        (lagged_ell=True): the scalar part (mass, viscous, lagged skew
        convection, the do-nothing facet mass) rebuilt once per step, the
        constant grad-transpose and stress block kept apart. -> (Jv, its
        diagonal)."""
        ctx, g = self.ctx, self._lagmom_graph
        rho, mu = self.rho, self.mu
        s = (dt / rho) * self.theta[1]
        conv_el = forms.conv_lagged_jacobian_loc(self.V, ctx.geom, self.V.gather(x0),
                                                 rule_degree=CONV_RULE)
        scal = (self._lagmom_mass + (s * mu) * self._lagmom_visc1
                + (s * rho) * g.assemble(conv_el))
        tn = torch.einsum("bqm,bm->bq", ctx.btab.values(x0), ctx.btab.normals)
        scal = scal + (s * 0.5 * rho) * self._lagmom_fm.assemble(torch.clamp(tn, min=0.0))
        visc2B = self._lagmom_visc2
        smu = s * mu
        nv, we, W = g.n_vert, g.w_edge, g.width
        free = 1.0 - self.mask_u

        def _av(sc, bl, cols, v):
            xg = v[cols]
            return (torch.einsum("nk,nkm->nm", sc, xg)
                    + smu * torch.einsum("nkab,nkb->na", bl, xg))

        def Jv(v):
            if 0 < we < W and nv < g.n:
                av = torch.cat([_av(scal[:nv], visc2B[:nv], g.cols[:nv], v),
                                _av(scal[nv:, :we], visc2B[nv:, :we], g.cols[nv:, :we], v)])
            else:
                av = _av(scal, visc2B, g.cols, v)
            return free * av + self.mask_u * v

        dex = g.diag(scal)[:, None] + smu * self._lagmom_dvisc2
        return Jv, free * dex + self.mask_u

    def _einsum_solves(self, dt, M):
        """The einsum route's momentum solves: (x0, r0) -> (dx, info) with
        the lagged tangent at the frozen transport x0, and (x, r, eta) ->
        (dx, info) with the Newton tangent at x; M the preconditioner."""

        def solve_lagged(x0, r0):
            if self._lagmom_graph is not None:
                Jv, dex = self._lagged_ell_Jv(x0, dt)
                return self._mom_krylov(Jv, -r0, lambda t: t / dex, self.newton_rtol)
            Jv = self._ema_Jv(self._ema_S(x0, dt), x0, dt)
            return self._mom_krylov(Jv, -r0, M, self.newton_rtol)

        def solve_newton(x, r, eta):
            if self._mom_graph is not None:
                return self._mom_krylov(self._assembled_Jv(x, dt), -r, M, eta)
            return self._mom_krylov(self._newton_Jv(x, dt), -r, M, eta)

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

            dxp, sinfo = self._mom_krylov(Jv_p, -r[perm], lambda t: t / diagp, rtol)
            return dxp[inv], sinfo

        def solve_lagged(x0, r0):
            return solve(x0, r0, self.newton_rtol, op.transport_qp(x0))

        def solve_newton(x, r, eta):
            return solve(x, r, eta, *op.state_qp(x))

        return solve_lagged, solve_newton

    def _newton(self, res_bc, x, solve):
        """Newton on res_bc from x: each iteration one Krylov solve
        solve(x, r, eta) with the tangent to the inner rtol eta
        (linear_rtol, or Eisenstat-Walker). Stops on |r| <= max(newton_tol,
        newton_rtol |r0|) or newton_maxiter iterations -> (x, iterations,
        |r|, linear iterations, converged)."""
        r = res_bc(x)
        rnorm = torch.sqrt(self._ssq(r))
        target = torch.clamp(self.newton_rtol * rnorm, min=self.newton_tol)
        eta = self._scalar(self.linear_rtol)
        k = lin = 0
        while k < self.newton_maxiter and bool(rnorm > target):
            dx, sinfo = solve(x, r, eta)
            x = x + dx
            r = res_bc(x)
            rnorm_new = torch.sqrt(self._ssq(r))
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

    # -- the vertex momentum preconditioner ---------------------------------------
    def _build_vertex_precond(self):
        """Tables of momentum_precond="vertex": the additive two-level
        M(r) = D^-1 r + P [R r / d1], R/P the exact P2 <-> P1 transfer on the
        same mesh (the P2 dofs are [vertices; edges]) and d1 the P1 diagonal
        of mass + s (rho conv + 2 mu stiff) plus an SUPG streamline term
        tau (u.grad phi)^2, tau = h / (2 |u|). Restriction by a padded
        vertex -> incident-edge gather table, no scatter."""
        from ..fem.spaces import FunctionSpace

        V, mesh = self.V, self.V.mesh
        if getattr(mesh, "dim", 2) != 2 or V.degree != 2:
            raise ValueError("vertex momentum preconditioner: 2-D P2 only")
        assert V.n_dofs == mesh.n_points + mesh.n_edges
        dtype, device = self.dtype, self.device

        def dev(a, dt=dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)

        S1 = FunctionSpace(mesh, 1)
        hgeom = assembly.geometry(mesh)
        geom = self.ctx.geom
        self._vp_npts = mesh.n_points
        self._vp_sum1 = gather_sum_of(S1, device)
        self._vp_mass_diag = dev(S1.dof_sum(np.einsum("eii->ei", assembly.mass_local(S1, hgeom))))
        self._vp_stiff_diag = dev(S1.dof_sum(
            np.einsum("eii->ei", assembly.stiffness_local(S1, hgeom))))
        tab1 = assembly.tabulation(S1, CONV_RULE).on(dtype, device)
        self._vp_phi1 = tab1.phi
        self._vp_gph1 = torch.einsum("qjk,edk->eqjd", tab1.dphi, geom.G)
        self._vp_wd1 = tab1.w[None, :] * geom.detJ[:, None]
        self._vp_hel = torch.sqrt(2.0 * torch.abs(geom.detJ))
        self._vp_tabV = assembly.tabulation(V, CONV_RULE).on(dtype, device)
        e = mesh.edges_np
        n_edges, n_pts = len(e), mesh.n_points
        vv = np.concatenate([e[:, 0], e[:, 1]])
        ee = np.concatenate([np.arange(n_edges), np.arange(n_edges)])
        cnt = np.bincount(vv, minlength=n_pts)
        tabv = np.full((n_pts, int(cnt.max())), n_edges, dtype=np.int64)
        order = np.argsort(vv, kind="stable")
        vv_s, ee_s = vv[order], ee[order]
        starts = np.concatenate([[0], np.cumsum(cnt)])
        tabv[vv_s, np.arange(len(vv_s)) - starts[vv_s]] = ee_s
        self._vp_v2e = dev(tabv, torch.int64)
        self._vp_edges = dev(e, torch.int64)

    def _vertex_precond_M(self, U, dt, free, diag):
        """The vertex-correction preconditioner at (U, dt): one quadrature
        pass a step; each application two small gathers. U in either layout
        ([n, 2], or flat [2n] on the packed layout); M matches it."""
        V = self.V
        s = (dt / self.rho) * self.theta[1]
        pk = U.dim() == 1
        U2 = self.pctx.unpack(U) if pk else U
        Wq = assembly.values_at_qp(self._vp_tabV, V.gather(U2))  # [e,q,2]
        ugph = torch.einsum("eqd,eqjd->eqj", Wq, self._vp_gph1)
        conv_d = torch.einsum("eq,qj,eqj->ej", self._vp_wd1, self._vp_phi1, ugph)
        umag = torch.sqrt(torch.sum(Wq * Wq, dim=-1))
        tau = self._vp_hel[:, None] / (2.0 * torch.clamp(umag, min=1e-10))
        supg_d = torch.einsum("eq,eq,eqj,eqj->ej", self._vp_wd1, tau, ugph, ugph)
        d1 = (self._vp_mass_diag + s * (2.0 * self.mu) * self._vp_stiff_diag
              + s * self.rho * self._vp_sum1(conv_d + supg_d))
        n_pts = self._vp_npts
        vmask = self.mask_u[:n_pts]
        dd = (1.0 - vmask) * d1[:, None] + vmask  # [n_pts, 2]
        edges, v2e = self._vp_edges, self._vp_v2e

        def correct(rf):
            """[n, m] -> the coarse correction [n, m]."""
            rv, rm = rf[:n_pts], rf[n_pts:]
            rmp = torch.cat([rm, rm.new_zeros((1,) + rm.shape[1:])])
            z = (rv + 0.5 * rmp[v2e].sum(dim=1)) / dd
            zm = 0.5 * (z[edges[:, 0]] + z[edges[:, 1]])
            return torch.cat([z, zm])

        if not pk:
            def M_dense(r):
                return r / diag + free * correct(free * r)

            return M_dense
        n = V.n_dofs

        def M_packed(r):
            z = correct((free * r).view(2, n).t())  # [n, 2]
            return r / diag + free * z.t().reshape(-1)

        return M_packed

    # -- the packed layout (flat [2n] velocity state) -----------------------------
    def _step_impl_pk(self, Uf, Pf, dt, x0=None):
        pc, ctx = self.pctx, self.ctx
        rho, mu = self.rho, self.mu
        w_im = self.theta[1]
        s = (dt / rho) * w_im
        mask, val = self.mask_uf, self.val_uf
        free = 1.0 - mask

        def res_bc(x, T=None):
            r = pc.residual_volume(x, Uf, Pf, rho, mu, dt, w_im, Tf=T)
            r = r - s * pc.boundary_rhs(ctx.btab, ctx.btabQ, x, Pf, rho, mu, Tf=T)
            return free * r + mask * (x - val)

        diag = self.mass_diag_f + s * (2.0 * mu) * self.stiff_diag_f
        diag = free * diag + mask
        if self.momentum_precond == "vertex":
            M_mom = self._vertex_precond_M(Uf, dt, free, diag)
        else:
            def M_mom(t):
                return t / diag
        x0 = free * (Uf if x0 is None else x0) + mask * val

        if self.lagged:
            # affine residual with the transport x0: one solve
            r0 = res_bc(x0, T=x0)
            if self._lagged_ema:
                Jv = self._ema_Jv_pk(self._ema_S_pk(x0, dt), x0, dt)
            else:
                Jv = self._lagged_Jv_pk(x0, dt)
            dx, sinfo = self._mom_krylov(Jv, -r0, M_mom, self.newton_rtol)
            Uif = x0 + dx
            niters, nres, lin, mconv = 1, sinfo.resnorm, sinfo.iters, sinfo.converged
        else:
            def solve(x, r, eta):
                return self._mom_krylov(self._newton_Jv_pk(x, dt), -r, M_mom, eta)

            Uif, niters, nres, lin, mconv = self._newton(res_bc, x0, solve)
        P1, pinfo = self._pressure_solve_pk(Uif, Pf, dt)
        U1f, cinfo = self._correction_pk(Uif, P1, Pf, dt)
        stats = StepStats(niters, nres, lin, pinfo.iters, cinfo.iters,
                          pinfo.converged, cinfo.converged, mconv)
        return U1f, P1, stats

    def _ema_S_pk(self, x0f, dt):
        """The packed EMA scalar tensor [nl, nl, nc] at the transport x0f."""
        pc = self.pctx
        s = (dt / self.rho) * self.theta[1]
        Tl = pc.gatherV(pc.comps(x0f))
        S = pc.lagged_scalar_tensor(Tl, 1.0, s * self.mu, s * self.rho, self._ema_kscal_pk)
        return S.to(torch.bfloat16) if self._ema_bf16 else S

    def _ema_Jv_pk(self, S, x0f, dt):
        """The packed lagged tangent through the EMA tensor S (_ema_S_pk)."""
        pc = self.pctx
        s = (dt / self.rho) * self.theta[1]
        bnd = pc.boundary_tangent(self.ctx.btab, self.rho, self.mu, x0f, newton=False)
        free = 1.0 - self.mask_uf
        kd = S.dtype if self._ema_bf16 else None

        def Jv(vf):
            Vl = pc.gatherV(pc.comps(vf))
            if self._ema_bf16:
                Vl = Vl.to(S.dtype).to(vf.dtype)
            loc = pc.ema_scalar_apply(pc._zero_loc(vf), S, Vl)
            loc = pc.sym_grad_transpose_loc_acc(loc, Vl, mu=s * self.mu, kref_dtype=kd)
            av = pc.dof_sum_V2(loc) - s * bnd(vf)
            return free * av + self.mask_uf * vf

        return Jv

    def _lagged_Jv_pk(self, x0f, dt):
        """The packed lagged tangent by quadrature (the lagged residual's
        linear part), where the EMA is off (lagged_ell=True)."""
        pc = self.pctx
        s = (dt / self.rho) * self.theta[1]
        Tl = pc.gatherV(pc.comps(x0f))
        bnd = pc.boundary_tangent(self.ctx.btab, self.rho, self.mu, x0f, newton=False)
        free = 1.0 - self.mask_uf

        def Jv(vf):
            Vl = pc.gatherV(pc.comps(vf))
            loc = pc.mass_loc_acc(pc._zero_loc(vf), Vl)
            loc = pc.skew_conv_lagged_loc_acc(loc, Tl, Vl, scale=s * self.rho)
            loc = pc.sym_grad_loc_acc(loc, Vl, mu=s * self.mu)
            av = pc.dof_sum_V2(loc) - s * bnd(vf)
            return free * av + self.mask_uf * vf

        return Jv

    def _newton_Jv_pk(self, xf, dt):
        """The packed Newton residual's exact tangent at xf (see
        _newton_Jv): mass + s [rho (c(x; v) + c(v; x)) + stress] - s ds."""
        pc = self.pctx
        s = (dt / self.rho) * self.theta[1]
        bnd = pc.boundary_tangent(self.ctx.btab, self.rho, self.mu, xf, newton=True)
        free = 1.0 - self.mask_uf

        def state():
            return pc._qp(pc.gatherV(pc.comps(xf)))

        cached = state() if self.tangent_mode == "linearize" else None

        def Jv(vf):
            st = state() if cached is None else cached
            Vl = pc.gatherV(pc.comps(vf))
            loc = pc.mass_loc_acc(pc._zero_loc(vf), Vl)
            loc = pc.skew_conv_tangent_loc_acc(loc, st, Vl, scale=s * self.rho)
            loc = pc.sym_grad_loc_acc(loc, Vl, mu=s * self.mu)
            av = pc.dof_sum_V2(loc) - s * bnd(vf)
            return free * av + self.mask_uf * vf

        return Jv

    def _pressure_solve_pk(self, Uif, Pf, dt):
        pc, ctx = self.pctx, self.ctx
        L2 = -(self.rho / dt) * pc.div_rhs(Uif)
        if self.rotational:
            L2 = L2 - self.mu * pc.grad_div_rhs(Uif)
        sd = ctx.stiff_diag_Q
        diagq = torch.where(sd > 0, sd, torch.ones_like(sd))
        M = self.pressure_precond or (lambda r: r / diagq)
        K = self._KQ_apply
        if not self.has_p_bcs:
            phi, sinfo = krylov.cg(K, L2, M=M, rtol=self.pressure_rtol,
                                   maxiter=self.pressure_maxiter, nullspace=[ctx.ones_Q])
            return Pf + phi, sinfo
        mask = self.mask_p
        free = 1.0 - mask

        def K_bc(p):
            return free * K(free * p) + mask * p

        pin = mask * (self.val_p - Pf)
        rhs = free * (L2 - K(pin)) + pin
        phi, sinfo = krylov.cg(K_bc, rhs, M=M, rtol=self.pressure_rtol,
                               maxiter=self.pressure_maxiter)
        return Pf + phi, sinfo

    def _correction_pk(self, Uif, P1, Pf, dt):
        pc = self.pctx
        div_part = self.mu * pc.grad_div_cell(Uif) if self.rotational else None
        mask = self.mask_uf
        free = 1.0 - mask

        def M_bc(u):
            return free * pc.mass_apply(free * u) + mask * u

        diag = free * self.mass_diag_f + mask
        L3 = -(dt / self.rho) * pc.grad_phi_rhs(P1 - Pf, div_part=div_part)
        dmask = mask * (self.val_uf - Uif)
        rhs = free * (L3 - pc.mass_apply(dmask)) + dmask
        d, sinfo = krylov.cg(M_bc, rhs, M=lambda r: r / diag, rtol=self.correction_rtol,
                             maxiter=500)
        return Uif + d, sinfo

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
        K = self._KQ_apply
        L2 = -(self.rho / dt) * forms.div_rhs(V, Q, geom, Ui)
        if self.rotational:
            L2 = L2 - self.mu * forms.grad_div_ustar_rhs(V, Q, geom, Ui)
        if not self.has_p_bcs:
            phi, sinfo = krylov.cg(
                K, L2, M=self.pressure_precond, rtol=self.pressure_rtol,
                maxiter=self.pressure_maxiter, nullspace=[self.ctx.ones_Q],
                dot=self._pdot,
            )
            return P + phi, sinfo
        mask, free = self.mask_p, 1.0 - self.mask_p

        def K_bc(p):
            return free * K(free * p) + mask * p

        pin = mask * (self.val_p - P)
        rhs = free * (L2 - K(pin)) + pin
        phi, sinfo = krylov.cg(
            K_bc, rhs, M=self.pressure_precond, rtol=self.pressure_rtol,
            maxiter=self.pressure_maxiter, dot=self._pdot,
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
    def _div_norm(self, U1):
        """||div u||_L2, the projection's splitting-error monitor."""
        V, geom = self.V, self.ctx.geom
        tab = assembly.tabulation(V, 2 * V.degree).on(U1.dtype, U1.device)
        gU = assembly.grads_at_qp(tab, geom, V.gather(U1))
        divq = torch.diagonal(gU, dim1=2, dim2=3).sum(dim=-1)
        return torch.sqrt(torch.einsum("eq,q,e->", divq * divq, tab.w, geom.detJ))

    def run(self, U, P, dt0, n_steps, Um1=None, dtp0=None, dt_max=None):
        """n_steps steps with the CFL controller -> (U, P, dt, telemetry);
        BDF2 also returns (Um1, dtp), the previous velocity and step, which
        continue a run at full order when passed back (the defaults Um1=U,
        dtp=dt0 make the first step a backward-Euler-like start). dt_max
        overrides the constructor's cap for this run. The packed layout
        packs U once and unpacks the result; patch mode takes the spaces'
        layout (converted once each way) or its own.

        telemetry maps t, dt, the per-step iteration counts (the JAX
        stepper's keys), the convergence flags of the three solves, with a
        forces probe forces [n_steps, 2], and with the divergence probe
        div_norm [n_steps], to tensors."""
        if self.patch and U.shape[0] == self.V_real.n_dofs:
            Vp, Qp = self.V, self.Q
            out = self.run(Vp.to_patch(U), Qp.to_patch(P), dt0, n_steps,
                           None if Um1 is None else Vp.to_patch(Um1), dtp0, dt_max)
            return (Vp.from_patch(out[0]), Qp.from_patch(out[1])) + tuple(out[2:])
        dt_cap = self._scalar(self.dt_max if dt_max is None else dt_max)
        cfl = self._scalar(self.cfl_target)
        dt = self._scalar(dt0)
        t = self._scalar(0.0)
        pk = self.packed
        if self.bdf2:
            Um1 = U if Um1 is None else Um1
            dtp = dt if dtp0 is None else self._scalar(dtp0)
        if pk:
            U = self.pctx.pack(U)
            if self.bdf2:
                Um1 = self.pctx.pack(Um1)
        probe = self.forces_probe
        history = getattr(probe, "needs_history", False)

        def public(X):
            if pk:
                return self.pctx.unpack(X)
            return self.V.from_patch(X) if self.patch else X

        rows = []
        for _ in range(n_steps):
            if self.bdf2:
                U1, P1, stats = self._step_impl_bdf2(U, Um1, P, dt, dtp)
            else:
                U1, P1, stats = self._step_impl(U, P, dt)
            t = t + dt
            forces = None
            if probe is not None:
                P1p = self.Q.from_patch(P1) if self.patch else P1
                if not history:
                    forces = probe(public(U1), P1p)
                else:
                    # the scheme's own time derivative: for BDF2, (U1 - u_hat)
                    # / dt_eff is exactly the variable-step BDF2 derivative
                    U0, dt0_ = self._bdf2_hat(U, Um1, dt, dtp)[:2] if self.bdf2 else (U, dt)
                    forces = probe(public(U1), P1p, public(U0), dt0_)
            div = self._div_norm(U1) if self.divergence_probe else None
            rows.append((t, dt, stats, forces, div))
            # smooth CFL-style controller, on the device
            umax2 = (torch.max(torch.sum(self.pctx.comps(U1) ** 2, dim=0)) if pk
                     else torch.max(torch.sum(U1 * U1, dim=1)))
            target_dt = cfl * self.hmax / torch.clamp(torch.sqrt(umax2), min=1e-30)
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
        if self.divergence_probe:
            telemetry["div_norm"] = torch.stack([r[4] for r in rows])
        for key in ("momentum_converged", "pressure_converged",
                    "correction_converged"):
            telemetry[key] = torch.stack([getattr(r[2], key) for r in rows])
        for key in ("newton_iters", "linear_iters", "pressure_iters",
                    "correction_iters"):
            telemetry[key] = torch.tensor(
                [getattr(r[2], key) for r in rows], dtype=torch.int64
            )
        if pk:
            U = self.pctx.unpack(U)
            if self.bdf2:
                Um1 = self.pctx.unpack(Um1)
        if self.bdf2:
            return U, P, dt, telemetry, (Um1, dtp)
        return U, P, dt, telemetry
