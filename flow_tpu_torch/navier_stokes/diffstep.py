# A reverse-mode differentiable projection step. Port of
# flow_tpu/navier_stokes/diffstep.py::DiffStepper.
#
# The step is FastStepper's lagged einsum step (semi-implicit momentum,
# pressure Poisson and velocity correction, in increment form), with every
# linear solve a torch.autograd.Function (linear_solve below) where the JAX
# package uses lax.custom_linear_solve: the forward pass runs the Krylov
# solve without a tape, and the backward pass solves the transposed system
# with the same Krylov method (implicit differentiation), so
#   * memory stays O(state) per step and no Krylov iteration is taped,
#   * the gradients are exact to the solver tolerance,
#   * torch.autograd.grad works through a chain of steps.
# Differentiable inputs: U, P, dt, mu and rho (tensors that require grad);
# the mesh, the BCs and the tolerances are fixed.
from __future__ import annotations

import torch

from ..fem import assembly, forms
from ..solvers import krylov
from .fast import FastStepper

__all__ = ["DiffStepper", "linear_solve"]


class _LinearSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, b, spec, *params):
        with torch.no_grad():
            x = spec["solve"](lambda v: spec["matvec"](v, *params), b)
        ctx.spec = spec
        ctx.save_for_backward(x, *params)
        return x

    @staticmethod
    def backward(ctx, g):
        x, *params = ctx.saved_tensors
        spec = ctx.spec
        matvec = spec["matvec"]
        consts = [p.detach() for p in params]
        if spec["symmetric"]:
            def AT(w):
                return matvec(w, *consts)
        else:
            def AT(w):
                # A^T w by a vector-Jacobian product of the linear v -> A v
                with torch.enable_grad():
                    v = torch.zeros_like(w, requires_grad=True)
                    return torch.autograd.grad(matvec(v, *consts), v, w)[0]
        with torch.no_grad():
            lam = spec["transpose_solve"](AT, g)
        grads = [None] * len(params)
        need = ctx.needs_input_grad[2:]
        if any(need):
            # d(A(theta) x)/d theta, contracted with -lambda
            with torch.enable_grad():
                ps = [p.detach().requires_grad_(n) for p, n in zip(params, need)]
                y = matvec(x.detach(), *ps)
                live = [p for p, n in zip(ps, need) if n]
                gs = iter(torch.autograd.grad(y, live, -lam, allow_unused=True))
            grads = [next(gs) if n else None for n in need]
        return (lam, None, *grads)


def linear_solve(matvec, b, solve, transpose_solve=None, params=(), symmetric=False):
    """x = A^{-1} b with A v = matvec(v, *params), differentiable in b and
    in the tensors `params`: solve(A, b) runs forward, transpose_solve
    (default: solve) on A^T in the backward pass."""
    spec = {"matvec": matvec, "solve": solve, "symmetric": symmetric,
            "transpose_solve": solve if transpose_solve is None else transpose_solve}
    return _LinearSolve.apply(b, spec, *params)


class DiffStepper:
    """The differentiable counterpart of a lagged-convection FastStepper on
    the einsum route: `stepper` (or one built from V, Q, ...) supplies the
    context, BC masks, diagonals and theta weights; step(U, P, dt, mu=,
    rho=) -> (U1, P1) is differentiable in (U, P, dt, mu, rho). Its forward
    pass is FastStepper(convection="lagged")'s increment-form step."""

    def __init__(self, V=None, Q=None, u_bcs=None, p_bcs=None, rho=1.0, mu=1.0,
                 rotational_form=False, stepper=None, momentum_rtol=1.0e-10,
                 pressure_rtol=1.0e-10, correction_rtol=1.0e-10, maxiter=1000,
                 device=None, dtype=None):
        if stepper is None:
            stepper = FastStepper(V, Q, u_bcs, p_bcs, rho=rho, mu=mu,
                                  rotational_form=rotational_form, convection="lagged",
                                  packed=False, device=device, dtype=dtype)
        if not stepper.lagged:
            raise ValueError("DiffStepper needs a lagged-convection stepper")
        if stepper.winkernel or stepper.packed or stepper.patch:
            raise ValueError("DiffStepper runs the einsum route in the spaces' layout")
        self.st = stepper
        self.ctx = stepper.ctx
        self.rho, self.mu = stepper.rho, stepper.mu
        self.rotational = stepper.rotational
        self.momentum_rtol = momentum_rtol
        self.pressure_rtol = pressure_rtol
        self.correction_rtol = correction_rtol
        self.maxiter = maxiter

    # the preconditioners change iteration counts, never the solution: they
    # are detached
    def _bicgstab_solve(self, diag, rtol):
        diag = diag.detach()

        def solve(A, b):
            return krylov.bicgstab(A, b, M=lambda t: t / diag, rtol=rtol,
                                   maxiter=self.maxiter)[0]

        return solve

    def _cg_solve(self, diag, rtol):
        diag = diag.detach()

        def solve(A, b):
            return krylov.cg(A, b, M=lambda r: r / diag, rtol=rtol,
                             maxiter=self.maxiter)[0]

        return solve

    def rollout(self, U, P, dt, n_steps, mu=None, rho=None):
        """n_steps differentiable steps -> (U, P)."""
        for _ in range(n_steps):
            U, P = self.step(U, P, dt, mu=mu, rho=rho)
        return U, P

    def step(self, U, P, dt, mu=None, rho=None, x0=None):
        """One increment-form projection step -> (U1, P1). mu/rho default to
        the stepper's constants; x0 is the lagged transport and initial
        guess (default U)."""
        st, ctx = self.st, self.ctx
        mu = st._scalar(st.mu) if mu is None else mu
        rho = st._scalar(st.rho) if rho is None else rho
        dt = st._scalar(dt) if not isinstance(dt, torch.Tensor) else dt
        V, Q, geom = st.V, st.Q, ctx.geom
        mask_u, val_u = st.mask_u, st.val_u
        free_u = 1.0 - mask_u
        w_im = st.theta[1]
        x0 = free_u * (U if x0 is None else x0) + mask_u * val_u

        # substep 1: the lagged momentum solve for d = x - x0 (the residual
        # is affine in x; its linear part is the residual with zero U and P)
        def res_lag(x):
            r = ctx.residual(x, U, P, rho, mu, dt, st.theta, transport=x0)
            return free_u * r + mask_u * (x - val_u)

        zU, zP = torch.zeros_like(U), torch.zeros_like(P)

        def mom_matvec(v, x0_, mu_, rho_, dt_):
            r = ctx.residual(v, zU, zP, rho_, mu_, dt_, st.theta, transport=x0_)
            return free_u * r + mask_u * v

        diag_m = ctx.mass_diag_V + (dt / rho) * w_im * (2.0 * mu) * ctx.stiff_diag_V
        diag_m = free_u * diag_m + mask_u
        solve_m = self._bicgstab_solve(diag_m, self.momentum_rtol)
        d = linear_solve(mom_matvec, -res_lag(x0), solve_m, params=(x0, mu, rho, dt))
        Ui = x0 + d

        # substep 2: pressure Poisson, increment form (phi = p1 - p0)
        L2 = -(rho / dt) * forms.div_rhs(V, Q, geom, Ui)
        if self.rotational:
            L2 = L2 - mu * forms.grad_div_ustar_rhs(V, Q, geom, Ui)
        sd = ctx.stiff_diag_Q
        diag_q = torch.where(sd > 0, sd, torch.ones_like(sd))
        if not st.has_p_bcs:
            # pure Neumann: the rank-one-completed SPD system
            # (K + u u^T) phi = (I - u u^T) rhs, u the normalised ones, whose
            # solution is the zero-mean one
            uQ = ctx.ones_Q / torch.linalg.norm(ctx.ones_Q)

            def K_reg(p):
                return assembly.stiffness_apply(Q, geom, p) + uQ * torch.dot(uQ, p)

            rhs = L2 - uQ * torch.dot(uQ, L2)
            phi = linear_solve(lambda p: K_reg(p), rhs,
                               self._cg_solve(diag_q, self.pressure_rtol), symmetric=True)
        else:
            mask_p, val_p = st.mask_p, st.val_p
            free_p = 1.0 - mask_p

            def K_bc(p):
                return free_p * assembly.stiffness_apply(Q, geom, free_p * p) + mask_p * p

            pin = mask_p * (val_p - P)
            rhs = free_p * (L2 - assembly.stiffness_apply(Q, geom, pin)) + pin
            phi = linear_solve(lambda p: K_bc(p), rhs,
                               self._cg_solve(free_p * diag_q + mask_p, self.pressure_rtol),
                               symmetric=True)
        P1 = P + phi

        # substep 3: velocity correction, increment form (d = u1 - u*)
        div_part = mu * forms.grad_div_ustar(V, geom, Ui) if self.rotational else None

        def M_bc(u):
            return free_u * assembly.mass_apply(V, geom, free_u * u) + mask_u * u

        diag_c = free_u * ctx.mass_diag_V + mask_u
        L3 = -(dt / rho) * forms.grad_phi_rhs(V, Q, geom, phi, div_part=div_part,
                                              rule_degree=4)
        dmask = mask_u * (val_u - Ui)
        rhs_c = free_u * (L3 - assembly.mass_apply(V, geom, dmask)) + dmask
        dc = linear_solve(lambda u: M_bc(u), rhs_c,
                          self._cg_solve(diag_c, self.correction_rtol), symmetric=True)
        return Ui + dc, P1
