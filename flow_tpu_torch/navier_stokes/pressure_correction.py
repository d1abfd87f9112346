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
from ..fem.assembly import BoundaryFaceTab, BoundaryTab, geometry_on, tabulation
from ..fem.bc import combine_bcs
from ..fem.interpolate import eval_callable
from ..fem.spaces import Function
from ..message import Message, info
from ..solvers import krylov

__all__ = ["NSContext", "CONV_RULE", "F_RULE", "Chorin", "IPCS", "Rotational"]

CONV_RULE = assembly.CONV_RULE
F_RULE = 6  # quadrature degree of the body-force integrals


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

    def _rhs_weak_loc(self, Wloc, rho, mu, Ploc, Tloc, Fq=None):
        """Local (pre-dof-sum) rhs_weak volume contributions [nc, nl, m]
        with the convection transported by Tloc and the body force Fq at
        the F_RULE quadrature points."""
        V, Q, geom = self.V, self.Q, self.geom
        loc = -rho * forms.skew_convection_lagged_loc(
            V, geom, Tloc, Wloc, rule_degree=CONV_RULE
        )
        loc = loc - forms.sym_grad_loc(V, geom, Wloc, mu)
        loc = loc + forms.pressure_grad_loc(V, Q, geom, Ploc)
        if Fq is not None:
            loc = loc + forms.body_force_loc(V, geom, Fq, rule_degree=F_RULE)
        return loc

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
                 transport=None, Fq_expl=None, Fq_impl=None):
        """F1(ui) with the theta weights (w_ex, w_im), one gather per field
        and one dof sum. The explicit terms transport with u0; the implicit
        ones with `transport`, or with ui itself when it is None (the
        Newton residual). Fq_expl/Fq_impl: the body force of each term at
        the F_RULE quadrature points (None: no force)."""
        V, Q = self.V, self.Q
        w_ex, w_im = theta
        Uiloc = V.gather(Ui)
        U0loc = V.gather(U0)
        Ploc = Q.gather(P0)
        Tloc = Uiloc if transport is None else V.gather(transport)
        loc = forms.mass_loc(V, self.geom, Uiloc - U0loc)
        if w_ex:
            loc = loc - (dt / rho) * w_ex * self._rhs_weak_loc(
                U0loc, rho, mu, Ploc, U0loc, Fq=Fq_expl)
        if w_im:
            loc = loc - (dt / rho) * w_im * self._rhs_weak_loc(
                Uiloc, rho, mu, Ploc, Tloc, Fq=Fq_impl)
        r = V.dof_sum(loc)
        bnd = None
        if w_ex:
            bnd = (dt / rho) * w_ex * self._rhs_weak_bnd(U0, P0, rho, mu, T=U0)
        if w_im:
            T = Ui if transport is None else transport
            b = (dt / rho) * w_im * self._rhs_weak_bnd(Ui, P0, rho, mu, T=T)
            bnd = b if bnd is None else bnd + b
        return r if bnd is None else r - bnd

    def tentative_newton(self, U0, Fq_expl, Fq_impl, P0, rho, mu, dt, mask,
                         gvals, theta, tol, maxiter=10):
        """The tentative velocity: Newton on the BC-applied residual from
        u0 with the BCs applied, each step a Jacobi-preconditioned BiCGStab
        solve (rtol 1e-7, atol 0.05 tol, 400 iterations) with the tangent
        of that residual (torch.func.jvp at the Newton iterate). Stops when the residual
        2-norm is <= tol or after maxiter steps. Returns (ui, |r|, steps)."""
        free = 1.0 - mask

        def res_bc(x):
            r = self.residual(x, U0, P0, rho, mu, dt, theta,
                              Fq_expl=Fq_expl, Fq_impl=Fq_impl)
            return free * r + mask * (x - gvals)

        # Jacobi preconditioner from the mass + viscous diagonal
        w_im = theta[1]
        diag = self.mass_diag_V + (dt / rho) * w_im * (2.0 * mu) * self.stiff_diag_V
        diag = free * diag + mask

        x = free * U0 + mask * gvals
        r = res_bc(x)
        rnorm = torch.sqrt(torch.sum(r * r))
        k = 0
        while k < maxiter and bool(rnorm > tol):

            def Jv(v, x=x):
                return torch.func.jvp(res_bc, (x,), (v,))[1]

            dx, _ = krylov.bicgstab(Jv, -r, M=lambda t: t / diag, rtol=1e-7,
                                    atol=0.05 * tol, maxiter=400)
            x = x + dx
            r = res_bc(x)
            rnorm = torch.sqrt(torch.sum(r * r))
            k += 1
        return x, rnorm, k

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


def _get_ctx(V, Q):
    """The NSContext of (V, Q) on V's mesh device and dtype, cached on V."""
    ctx = getattr(V, "_ns_ctx", None)
    if ctx is None or ctx.Q is not Q:
        ctx = NSContext(V, Q, V.mesh.dtype, V.mesh.device)
        V._ns_ctx = ctx
    return ctx


def _eval_f_at_qp(ctx, f):
    """A body force (callable, tuple, scalar or Function) at the F_RULE
    quadrature points -> [nc, nq, dim]."""
    if isinstance(f, Function):
        t = tabulation(f.space, F_RULE).on(ctx.dtype, ctx.device)
        return assembly.values_at_qp(t, f.space.gather(f.vector))
    ftab = tabulation(ctx.V, F_RULE)
    xq = assembly.geometry(ctx.V.mesh).physical_points(ftab.ref_pts)
    return eval_callable(f, torch.as_tensor(xq, dtype=ctx.dtype, device=ctx.device))


def _step(
    dt,
    u,
    p0,
    u_bcs,
    p_bcs,
    rho,
    mu,
    time_step_method,
    f,
    rotational_form=False,
    verbose=True,
    tol=1.0e-10,
    scheme_config=None,
    stats=None,
):
    """One projection step.

    u: {0: u0} or {-1: u_1, 0: u0} (dict of Functions); p0: Function;
    f: {0: f0, 1: f1}. Returns (u1, p1) Functions. scheme_config: a
    utils.config.SchemeConfig with the Newton tolerance and iteration cap.
    stats (a dict): filled with the step's Newton, pressure and correction
    iterations and the Newton residual."""
    from ..utils.config import SchemeConfig

    cfg = scheme_config or SchemeConfig()
    dt = float(dt)
    rho = float(rho)
    mu = float(mu)
    assert dt > 0.0
    assert mu > 0.0

    u0 = u[0]
    V = u0.space
    Q = p0.space
    ctx = _get_ctx(V, Q)

    # BDF2: with constant dt, (3 u1 - 4 u0 + u_{-1})/(2 dt) = rhs(u1) is a
    # backward-Euler step from u_hat = (4 u0 - u_{-1})/3 with dt* = 2 dt/3;
    # backward Euler when there is no u[-1] yet
    if time_step_method == "bdf2":
        if -1 in u:
            u0 = Function(V, (4.0 * u[0].vector - u[-1].vector) / 3.0)
            dt = 2.0 * dt / 3.0
        time_step_method = "backward euler"

    def dev(a):
        return torch.as_tensor(a, dtype=ctx.dtype, device=ctx.device)

    mask_u, val_u = (dev(a) for a in combine_bcs(V, u_bcs))
    has_p_bcs = bool(p_bcs)
    if has_p_bcs:
        mask_p, val_p = (dev(a) for a in combine_bcs(Q, p_bcs))
    else:
        mask_p = torch.zeros(Q.n_dofs, dtype=ctx.dtype, device=ctx.device)
        val_p = mask_p

    if time_step_method == "forward euler":
        theta = (1.0, 0.0)
    elif time_step_method == "backward euler":
        theta = (0.0, 1.0)
    else:
        assert time_step_method == "crank-nicolson"
        theta = (0.5, 0.5)
    alpha = 1.0

    Fq0 = _eval_f_at_qp(ctx, f[0]) if theta[0] else None
    Fq1 = _eval_f_at_qp(ctx, f[1]) if theta[1] else None

    with Message("Computing tentative velocity"):
        Ui, rnorm, n_newton = ctx.tentative_newton(
            u0.vector, Fq0, Fq1, p0.vector, rho, mu, dt, mask_u, val_u,
            theta, tol=cfg.newton_tol, maxiter=cfg.newton_maxiter,
        )
        rnorm = float(rnorm)
        if verbose:
            info("newton: iters=%d, |r|=%.3e", n_newton, rnorm)
        # absolute tolerance with error-on-nonconvergence semantics; small
        # roundoff slack
        if rnorm > 10.0 * cfg.newton_tol:
            raise RuntimeError(
                f"Newton solver did not converge (residual {rnorm:.3e})"
            )

    with Message("Computing pressure"):
        P1, pinfo = ctx.pressure_solve(
            Ui, p0.vector, alpha, rho, dt, mu, mask_p, val_p, tol,
            neumann=not has_p_bcs, rotational=rotational_form,
        )
        if verbose:
            info("pressure cg: iters=%d", pinfo.iters)
        if not bool(pinfo.converged):
            raise RuntimeError("Pressure Poisson solve did not converge")

    with Message("Computing velocity correction"):
        U1, cinfo = ctx.velocity_correction(
            Ui, P1, p0.vector, rho, mu, dt, mask_u, val_u, tol,
            rotational=rotational_form,
        )
        if verbose:
            info("mass cg: iters=%d", cinfo.iters)
        if not bool(cinfo.converged):
            raise RuntimeError("Velocity correction solve did not converge")

    if stats is not None:
        stats.update(newton_iters=n_newton, newton_res=rnorm,
                     pressure_iters=pinfo.iters, correction_iters=cinfo.iters)
    return Function(V, U1), Function(Q, P1)


class Chorin:
    """Non-incremental scheme (discards p0). last_stats: the iterations of
    the last step."""

    order = {"velocity": 1.0, "pressure": 0.5}

    def __init__(self, scheme_config=None):
        self.scheme_config = scheme_config
        self.last_stats = {}

    def step(self, dt, u, p0, u_bcs, p_bcs, rho, mu, f, verbose=True, tol=1.0e-10):
        zero_p = Function(p0.space)
        self.last_stats = {}
        return _step(
            dt, u, zero_p, u_bcs, p_bcs, rho, mu, "backward euler", f,
            verbose=verbose, tol=tol, scheme_config=self.scheme_config,
            stats=self.last_stats,
        )


class _Incremental:
    """Shared step of IPCS and Rotational. backend: None (einsum context) |
    "packed" (the packed-patch stepper; needs a refine_uniform-built mesh,
    raises where the step is not representable) | "auto" (packed where
    possible, else einsum); see navier_stokes/packedapi.py."""

    rotational = False

    def __init__(self, time_step_method="backward euler", scheme_config=None,
                 backend=None):
        self.time_step_method = time_step_method
        self.scheme_config = scheme_config
        self.backend = backend
        self.last_stats = {}

    def step(self, dt, u, p0, u_bcs, p_bcs, rho, mu, f, verbose=True, tol=1.0e-10):
        self.last_stats = {}
        if self.backend in ("packed", "auto"):
            from .packedapi import try_packed_step
            from ..utils.config import SchemeConfig

            out = try_packed_step(
                dt, u, p0, u_bcs, p_bcs, rho, mu, self.time_step_method, f,
                self.rotational, tol, self.scheme_config or SchemeConfig(),
                verbose=verbose, strict=self.backend == "packed",
                stats=self.last_stats,
            )
            if out is not None:
                return out
        return _step(
            dt, u, p0, u_bcs, p_bcs, rho, mu, self.time_step_method, f,
            rotational_form=self.rotational, verbose=verbose, tol=tol,
            scheme_config=self.scheme_config, stats=self.last_stats,
        )


class IPCS(_Incremental):
    """Incremental pressure-correction scheme."""

    order = {"velocity": 2.0, "pressure": 1.0}


class Rotational(_Incremental):
    """Incremental scheme in rotational form."""

    order = {"velocity": 2.0, "pressure": 1.5}
    rotational = True
