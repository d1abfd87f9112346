"""The comparison that decides `correct`: a projection step of the program,
judged on the reference's own operators.

A checked step is what the program's run produced from a state (U0, P0)
at a time step dt: the tentative velocity Ui (the momentum solve's answer),
the new pressure P1 (the Poisson solve's), the new velocity U1 (the mass
solve's) and the next time step (the CFL controller's). Each is read in
the program's global layout (its from_packed_state), mapped onto the
reference's dofs by coordinates, and judged in float64 by the true relative
residual of the linear system that the program says it solved:

  momentum_res    |free (A(x0) Ui - b) + mask D (Ui - g)| / |free (A(x0) x0 - b)|,
                  x0 = free U0 + mask g (the lagged transport is x0)
  pressure_res    |K_bc phi - rhs_p| / |rhs_p|, phi = P1 - P0
  correction_res  |free (M d - L3) + mask D (U1 - g)| / |free L3|, d = U1 - Ui
  dt_gap          |dt_next - dt_ref| / dt_ref, the controller's rule on U1
  u0_gap          max |U0 - U0_ref| / max |U0_ref|: the seeded start

The Dirichlet rows (g the boundary values) are scaled by D, the mass
matrix's diagonal, as the free rows are by the mass matrix: the program's
own rows x - g, unscaled, would let the rounding of g to float32 (~1e-9)
outweigh every free row, whose scale is the cells' area (~1e-7 at 10M
dofs).

The reference follows the program one step from the program's own state:
its loose momentum tolerance makes two trajectories part after a few steps.
The start is checked by itself (u0_gap). A run checks two steps, the first
of the warm-up (at dt0, near rest) and the one after the window; each
step's numbers are held to limits of their own (first_*, last_*), since
the two read far apart. The control is this reference put in the program's
place in CONTROL_DTYPE (control_step).
"""
from __future__ import annotations

import copy
import importlib
import math

import numpy as np
import torch

from .fem import SimplexP2, match_dofs

STEP_NAMES = ("momentum_res", "pressure_res", "correction_res", "dt_gap")
# the compared numbers of a run, in the order they print
NAMES = ("u0_gap",) + tuple(f"{when}_{k}" for when in ("first", "last") for k in STEP_NAMES)
# the control's precision: the rung below the float32 (TF32 off) the
# configurations state, after TF32 itself
CONTROL_DTYPE = torch.bfloat16


def problem_module(kind):
    return importlib.import_module(f"flowbench.reference.{kind}")


def initial_velocity(points, seed, scale, n_modes=4, amplitude=1e-2):
    """The seeded start: amplitude * scale times a sum of n_modes sine modes
    a component over the points' bounding box, with phases drawn from the
    seed (every seed has the same modes and amplitudes). points [n, dim]
    float64 tensor -> [n, dim] float64."""
    rng = np.random.default_rng(int(seed) % (1 << 64))
    dim = points.shape[1]
    lo = points.min(0).values
    ext = points.max(0).values - lo
    y = (points - lo) / ext
    U = torch.zeros_like(points)
    for a in range(dim):
        phases = rng.uniform(0.0, 2.0 * math.pi, size=n_modes)
        for m in range(n_modes):
            k = torch.tensor([(m + a + d) % 3 + 1 for d in range(dim)],
                             dtype=points.dtype, device=points.device)
            U[:, a] += torch.sin(2.0 * math.pi * (y * k).sum(1) + float(phases[m]))
    return (amplitude * scale / n_modes) * U


def verdict(checks, limits):
    """`correct`: every number of NAMES finite and at or under its limit."""
    return all(math.isfinite(checks.get(k, math.nan)) and checks[k] <= limits[k]
               for k in NAMES)


def _norm(x):
    return float(torch.linalg.vector_norm(x.to(torch.float64)))


class Reference:
    """The reference of one configuration on `device`: its mesh, dofs,
    boundary conditions and operators (float64)."""

    def __init__(self, cfg, device):
        self.cfg = cfg
        self.kind = problem_module(cfg["problem"])
        points, cells = self.kind.mesh(cfg)
        self.fe = SimplexP2(points, cells, device, torch.float64)
        self.dim = points.shape[1]
        self.mask, self.val, self.pin = self.kind.boundary_conditions(self.fe, cfg)
        self.rho, self.mu = float(cfg["rho"]), float(cfg["mu"])
        self.prog_of_ref = None

    def attach(self, prog_dof_points):
        """Map the program's P2 dofs (their coordinates) onto the
        reference's; False where the two meshes differ."""
        self.prog_of_ref = match_dofs(self.fe.dof_points, prog_dof_points)
        if self.prog_of_ref is None:
            return False
        # the program numbers its vertices first, as the P1 dofs
        return bool((self.prog_of_ref[: self.fe.nv] < self.fe.nv).all())

    def velocity(self, U):
        """A program velocity [n2, dim] (global layout) in reference order."""
        return torch.as_tensor(U, device=self.fe.device).to(torch.float64)[self.prog_of_ref]

    def pressure(self, P):
        return torch.as_tensor(P, device=self.fe.device).to(torch.float64)[
            self.prog_of_ref[: self.fe.nv]]

    # -- the step's systems, on a FE object of any dtype -------------------------
    @staticmethod
    def systems(fe, mask, val, U0, P0, dt, rho, mu, has_ds):
        """Operators and right-hand sides of one projection step from (U0,
        P0) at dt, as the program states them, in fe's dtype."""
        free = 1.0 - mask
        x0 = free * U0 + mask * val
        s = dt / rho
        b = fe.mass(U0) + s * fe.pressure_grad(P0)
        if has_ds:
            b = b + fe.boundary_pressure(P0, dt, rho)

        def A_raw(x):
            y = fe.momentum(x0, x, dt, rho, mu)
            if has_ds:
                y = y + fe.boundary_momentum(x0, x, dt, rho, mu)
            return y

        def res(x):
            return free * (A_raw(x) - b) + mask * (x - val)

        def A_bc(v):
            return free * A_raw(v) + mask * v

        return x0, res, A_bc

    def judge(self, U0_prog, seed, first, last, settings):
        """The numbers of NAMES of a run: its start (program global layout)
        from `seed`, and its two checked steps (see readings)."""
        out = {"u0_gap": self.u0_gap(U0_prog, seed)}
        for when, step in (("first", first), ("last", last)):
            out.update({f"{when}_{k}": v for k, v in self.readings(step, settings).items()})
        return out

    def readings(self, step, settings):
        """The numbers of STEP_NAMES for one checked step: `step`
        holds U0, P0, Ui, P1, U1 (program global layout), dt and dt_next
        (floats); `settings` the stepper's cfl_target and dt_max."""
        fe, rho, mu = self.fe, self.rho, self.mu
        U0, P0 = self.velocity(step["U0"]), self.pressure(step["P0"])
        Ui, U1 = self.velocity(step["Ui"]), self.velocity(step["U1"])
        P1 = self.pressure(step["P1"])
        dt = float(step["dt"])
        out = {}
        x0, res, _ = self.systems(fe, self.mask, self.val, U0, P0, dt, rho, mu,
                                  self.kind.HAS_DS)
        free, mask = 1.0 - self.mask, self.mask
        D = fe.mass_diag()[:, None]
        r_m = free * res(Ui) + mask * D * (Ui - self.val)
        out["momentum_res"] = _norm(r_m) / max(_norm(free * res(x0)), 1e-300)
        # pressure Poisson (increment form, rotational)
        phi = P1 - P0
        L2 = -(rho / dt) * fe.div1(Ui) - mu * fe.grad_div1(Ui)
        if self.pin is not None:
            pin, freep = self.pin, 1.0 - self.pin
            pv = pin * (0.0 - P0)
            rhs = freep * (L2 - fe.stiffness1(pv)) + pv
            r = freep * fe.stiffness1(freep * phi) + pin * phi - rhs
        else:
            rhs = L2 - L2.mean()
            r = fe.stiffness1(phi) - rhs
            r = r - r.mean()
        out["pressure_res"] = _norm(r) / max(_norm(rhs), 1e-300)
        # velocity correction on the mass matrix
        L3 = -(dt / rho) * fe.correction_rhs(phi, Ui, mu)
        r_c = free * (fe.mass(U1 - Ui) - L3) + mask * D * (U1 - self.val)
        out["correction_res"] = _norm(r_c) / max(_norm(free * L3), 1e-300)
        dt_ref = next_dt(U1, dt, fe.hmax, settings)
        out["dt_gap"] = abs(float(step["dt_next"]) - dt_ref) / dt_ref
        return out

    def u0_gap(self, U0_prog, seed):
        ref = initial_velocity(self.fe.dof_points, seed, self.kind.velocity_scale(self.cfg))
        return _norm_max(self.velocity(U0_prog) - ref) / _norm_max(ref)

    # -- the control: this reference in the program's place ---------------------
    def control_step(self, U0_prog, P0_prog, dt, settings):
        """One projection step computed by the reference in CONTROL_DTYPE
        from the program's state, with the program's stated tolerances and
        iteration caps (plain Krylov solvers, stopped at the tolerance, the
        cap or a stall) -> the `step` dict that readings() judges (reference
        order mapped back to program order)."""
        dtype = CONTROL_DTYPE
        fe = copy.copy(self.fe)
        fe.dtype = dtype
        lp = lambda t: t.to(dtype)  # noqa: E731
        U0, P0 = lp(self.velocity(U0_prog)), lp(self.pressure(P0_prog))
        mask, val = lp(self.mask), lp(self.val)
        rho, mu = self.rho, self.mu
        x0, res, A_bc = self.systems(fe, mask, val, U0, P0, dt, rho, mu,
                                     self.kind.HAS_DS)
        dx = bicgstab(A_bc, -res(x0), settings["momentum_rtol"], 300)
        Ui = x0 + dx
        L2 = -(rho / dt) * fe.div1(Ui) - mu * fe.grad_div1(Ui)
        if self.pin is not None:
            pin = lp(self.pin)
            freep = 1.0 - pin
            pv = pin * (0.0 - P0)
            rhs = freep * (L2 - fe.stiffness1(pv)) + pv
            phi = cg(lambda p: freep * fe.stiffness1(freep * p) + pin * p, rhs,
                     settings["pressure_rtol"], settings["pressure_maxiter"])
        else:
            phi = cg(lambda p: fe.stiffness1(p), L2 - L2.mean(),
                     settings["pressure_rtol"], settings["pressure_maxiter"], mean_free=True)
        P1 = P0 + phi
        free = 1.0 - mask
        dmask = mask * (val - Ui)
        L3 = -(dt / rho) * fe.correction_rhs(phi, Ui, mu)
        rhs_c = free * (L3 - fe.mass(dmask)) + dmask
        d = cg(lambda u: free * fe.mass(free * u) + mask * u, rhs_c,
               settings["correction_rtol"], 500)
        U1 = Ui + d
        dt_next = next_dt(U1, torch.tensor(dt, dtype=dtype), fe.hmax, settings)
        back = torch.empty_like(self.prog_of_ref)
        back[self.prog_of_ref] = torch.arange(len(back), device=back.device)
        nv = self.fe.nv
        pv_back = torch.empty(nv, dtype=torch.int64, device=back.device)
        pv_back[self.prog_of_ref[:nv]] = torch.arange(nv, device=back.device)
        up = lambda t: t.to(torch.float64)  # noqa: E731
        return {"U0": U0_prog, "P0": P0_prog, "dt": dt, "dt_next": float(dt_next),
                "Ui": up(Ui)[back], "U1": up(U1)[back], "P1": up(P1)[pv_back]}


def _norm_max(x):
    return float(x.abs().max())


def next_dt(U1, dt, hmax, settings):
    """The CFL controller: dt moves half way to cfl h_max / max|u|, at
    most doubling, capped at dt_max; in U1's dtype."""
    umax = torch.sqrt(torch.max((U1 * U1).sum(1)))
    dt = torch.as_tensor(dt, dtype=U1.dtype, device=U1.device)
    target = settings["cfl_target"] * hmax / torch.clamp(umax, min=1e-30)
    new = dt * torch.clamp(1.0 + 0.5 * (target - dt) / dt, max=2.0)
    return float(torch.clamp(new, max=settings["dt_max"]))


def _stalled(hist, window=30):
    """No 1% gain on the best residual in the last `window` iterations."""
    return len(hist) > window and min(hist[-window:]) > 0.99 * min(hist[:-window])


def cg(A, b, rtol, maxiter, mean_free=False):
    """Plain conjugate gradients from 0 (constants projected out with
    mean_free); stops at rtol |b|, maxiter or a stall."""
    proj = (lambda v: v - v.mean()) if mean_free else (lambda v: v)  # noqa: E731
    x = torch.zeros_like(b)
    r = proj(b)
    p = r.clone()
    rr = torch.sum(r.double() * r.double())
    target = rtol * math.sqrt(float(rr))
    hist = []
    for _ in range(maxiter):
        hist.append(math.sqrt(float(rr)))
        if hist[-1] <= target or _stalled(hist):
            break
        Ap = proj(A(p))
        alpha = (rr / torch.sum(p.double() * Ap.double())).to(b.dtype)
        x = x + alpha * p
        r = r - alpha * Ap
        rr_new = torch.sum(r.double() * r.double())
        p = r + (rr_new / rr).to(b.dtype) * p
        rr = rr_new
    return x


def bicgstab(A, b, rtol, maxiter):
    """Plain BiCGStab from 0; stops at rtol |b|, maxiter or a stall."""
    dot = lambda u, v: torch.sum(u.double() * v.double())  # noqa: E731
    x = torch.zeros_like(b)
    r = b.clone()
    rhat = r.clone()
    target = rtol * math.sqrt(float(dot(b, b)))
    rho = alpha = omega = torch.ones((), dtype=torch.float64, device=b.device)
    v = torch.zeros_like(b)
    p = torch.zeros_like(b)
    hist = []
    for _ in range(maxiter):
        hist.append(math.sqrt(float(dot(r, r))))
        if hist[-1] <= target or _stalled(hist) or not math.isfinite(hist[-1]):
            break
        rho_new = dot(rhat, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta.to(b.dtype) * (p - omega.to(b.dtype) * v)
        v = A(p)
        alpha = rho_new / dot(rhat, v)
        s = r - alpha.to(b.dtype) * v
        t = A(s)
        omega = dot(t, s) / dot(t, t)
        x = x + alpha.to(b.dtype) * p + omega.to(b.dtype) * s
        r = s - omega.to(b.dtype) * t
        rho = rho_new
    return x
