# Karman vortex street: flow past a cylinder in a channel, the benchmark
# problem of the repository (Re=100 on the BASELINE metric). Port of
# flow_tpu/models/karman.py: KarmanProblem (the geometry, the refine_uniform
# mesh hierarchy for multigrid, the P2/P1 spaces, the boundary conditions,
# the drag/lift probes), schafer_turek_problem, strouhal_number and the
# high-throughput driver run_karman_fast on FastStepper's einsum route (the
# JAX driver's) or its window route, or on PackedPatchStepper
# (backend="packed", the bench's default path). The Stokes bootstrap and
# the host-stepped run_karman are not ported.
from __future__ import annotations

import os
import time

import numpy as np
import torch

from .. import materials
from ..fem.assembly import BoundaryTab
from ..fem.bc import DirichletBC
from ..fem.spaces import FunctionSpace, VectorFunctionSpace
from ..mesh import rectangle_with_hole_mesh, refine_uniform

__all__ = ["KarmanProblem", "schafer_turek_problem", "run_karman_fast",
           "strouhal_number"]

X0, X1 = 0.0, 0.6
Y0, Y1 = -0.07, 0.07
OBSTACLE_DIAMETER = 0.04
OBSTACLE_CENTER = (0.1, 0.01)
ENTRANCE_VELOCITY = 0.01
MESH_EPS = 1.0e-12


class KarmanProblem:
    """Flow past a cylinder in a channel; the defaults are the JAX package's
    (its reference geometry). `dtype` and `device` are those of the meshes
    and the defaults of a stepper built on them (device None: the card)."""

    def __init__(
        self,
        lcar=0.1,
        n_refine=0,
        mu=0.002,
        rho=None,
        dtype=None,
        device=None,
        x0=X0,
        x1=X1,
        y0=Y0,
        y1=Y1,
        center=OBSTACLE_CENTER,
        diameter=OBSTACLE_DIAMETER,
        u_in=ENTRANCE_VELOCITY,
        u_ref=None,
        outflow_velocity_bc=True,
        snap=True,
    ):
        self.x0, self.x1, self.y0, self.y1 = x0, x1, y0, y1
        self.center = center
        self.diameter = diameter
        self.u_in = u_in
        # reference velocity for force coefficients (DFG convention: the
        # mean inflow velocity)
        self.u_ref = u_ref if u_ref is not None else u_in
        cx, cy = center
        r = 0.5 * diameter
        mesh = rectangle_with_hole_mesh(
            x0, x1, y0, y1, cx=cx, cy=cy, r=r, lcar=lcar, dtype=dtype,
            device=device,
        )

        def snap_fn(p):
            th = np.arctan2(p[:, 1] - cy, p[:, 0] - cx)
            d = np.linalg.norm(p - [cx, cy], axis=1)
            on_circ = np.abs(d - r) < 0.3 * r
            out = p.copy()
            out[on_circ] = np.stack(
                [cx + r * np.cos(th[on_circ]), cy + r * np.sin(th[on_circ])], 1
            )
            return out

        self.mesh_hierarchy = [mesh]
        for _ in range(n_refine):
            mesh = refine_uniform(mesh, snap_boundary=snap_fn if snap else None)
            self.mesh_hierarchy.append(mesh)

        self.mesh = mesh
        self.mu = mu
        self.rho = rho if rho is not None else float(materials.water.density(T=293.0))
        self.V = VectorFunctionSpace(mesh, 2)
        self.Q = FunctionSpace(mesh, 1)

        left = lambda x: x[:, 0] < x0 + MESH_EPS
        right = lambda x: x[:, 0] > x1 - MESH_EPS
        lower = lambda x: x[:, 1] < y0 + MESH_EPS
        upper = lambda x: x[:, 1] > y1 - MESH_EPS
        obstacle = lambda x: (
            (x[:, 0] > x0 + MESH_EPS)
            & (x[:, 0] < x1 - MESH_EPS)
            & (x[:, 1] > y0 + MESH_EPS)
            & (x[:, 1] < y1 - MESH_EPS)
        )

        # parabolic in/outflow; u_in is the peak value
        def profile(x):
            return (
                u_in * (y1 - x[:, 1]) * (x[:, 1] - y0) / (0.5 * (y1 - y0)) ** 2
            )

        V = self.V
        self.u_bcs = [
            DirichletBC(V, (0.0, 0.0), upper),
            DirichletBC(V, (0.0, 0.0), lower),
            DirichletBC(V, (0.0, 0.0), obstacle),
            DirichletBC(V.sub(0), profile, left),
        ]
        if outflow_velocity_bc:
            # the parabolic profile at the outlet too (the reference's
            # semantics); the DFG benchmark uses an open outflow
            self.u_bcs.append(DirichletBC(V.sub(0), profile, right))
        # outlet pressure pin for the projection steps
        self.p_bcs = [DirichletBC(self.Q, 0.0, right)]

        # probe machinery: obstacle facets of the boundary tabulations
        self.obstacle_predicate = obstacle
        self.btabV = BoundaryTab(self.V, rule_degree=4)
        self.btabQ = BoundaryTab(self.Q, rule_degree=4)
        mids = self.btabV.x_np.mean(axis=1)  # [nb, 2] facet qp centroid
        self.obstacle_facets = torch.as_tensor(
            np.asarray(obstacle(mids), dtype=np.float64), dtype=mesh.dtype,
            device=mesh.device,
        )
        self.reynolds = self.u_ref * diameter * self.rho / mu

    @property
    def n_dofs(self):
        """Velocity and pressure unknowns: 2 n_V + n_Q."""
        return 2 * self.V.n_dofs + self.Q.n_dofs

    def traction_force(self, U, P):
        """The boundary traction integral on the cylinder,
        F = oint [-p I + mu (grad u + grad u^T)] n ds with n the body-outward
        normal, as a [2] tensor (drag, lift)."""
        bt = self.btabV
        gu = bt.grads(U)  # [nb, q, m, d]
        pb = self.btabQ.values(P)  # [nb, q]
        n = -bt.normals  # body-outward [nb, 2]
        sig = self.mu * (gu + gu.transpose(2, 3))
        tvec = torch.einsum("bqij,bj->bqi", sig, n) - pb[:, :, None] * n[:, None, :]
        return torch.einsum("bqi,bq,b->i", tvec, bt.wl, self.obstacle_facets)

    def forces(self, U, P):
        """Drag and lift (F_x, F_y) as floats, from the traction integral."""
        F = self.traction_force(U, P)
        return float(F[0]), float(F[1])

    def consistent_force_probe(self, rule_degree=5):
        """The variationally consistent (residual-functional) force probe on
        the cylinder: superconvergent and float32-robust, unlike the
        traction integral, whose gradients cancel at this geometry's
        velocities of ~0.01."""
        from ..navier_stokes.forces import ConsistentForceProbe

        return ConsistentForceProbe(
            self.V, self.Q, self.obstacle_predicate, self.rho, self.mu,
            rule_degree=rule_degree,
        )

    def drag_lift_coefficients(self, U, P):
        fx, fy = self.forces(U, P)
        return fx / self.force_scale, fy / self.force_scale

    @property
    def force_scale(self):
        return 0.5 * self.rho * self.u_ref**2 * self.diameter


def schafer_turek_problem(lcar=0.03, n_refine=2, dtype=None, snap=True,
                          device=None):
    """DFG 2D-2 benchmark (Schaefer & Turek 1996): channel 2.2 x 0.41,
    cylinder d=0.1 at (0.2, 0.2), parabolic inflow Um=1.5 (mean 1.0),
    mu=0.001, rho=1 -> Re=100, open outflow (pressure pinned at the
    outlet). Published values: St ~ 0.300, Cd ~ 3.22-3.24, Cl amplitude
    ~ 1.0."""
    Um = 1.5
    return KarmanProblem(
        lcar=lcar, n_refine=n_refine, mu=0.001, rho=1.0, dtype=dtype,
        device=device, x0=0.0, x1=2.2, y0=0.0, y1=0.41, center=(0.2, 0.2),
        diameter=0.1, u_in=Um, u_ref=2.0 * Um / 3.0, outflow_velocity_bc=False,
        snap=snap,
    )


def run_karman_fast(
    num_steps=100,
    lcar=0.02,
    n_refine=2,
    mu=0.002,
    dt0=1.0e-4,
    dt_max=1.0,
    cfl_target=1.0,
    use_multigrid=True,
    newton_rtol=1.0e-3,
    newton_maxiter=3,
    linear_rtol=1.0e-4,
    ew_forcing=False,
    pressure_rtol=1.0e-4,
    correction_rtol=1.0e-5,
    from_rest=True,
    chunk_size=100,
    checkpoint_path=None,
    resume=False,
    progress=False,
    problem=None,
    initial_state=None,
    time_step_method="backward euler",
    force_probe="consistent",
    convection="newton",
    backend="fast",
    winkernel=False,
    winkernel_S=None,
    tangent_mode="linearize",
    lmax=None,
    device=None,
    dtype=None,
):
    """The high-throughput Karman driver: the stepper runs chunks of
    `chunk_size` steps with the CFL controller on the device, multigrid-
    preconditioned pressure solves and per-step drag/lift telemetry, and
    writes (U, P, dt) (BDF2: also Um1, dtp) to `checkpoint_path` after
    every chunk; resume=True continues from it. The checkpoint is the JAX
    package's npz format in the global layout, so a JAX-written one (or one
    of another backend) resumes here.

    backend="fast" (the default) runs FastStepper. winkernel=False is its
    einsum route with the assembled-ELL pressure operator, which is what the
    JAX driver runs (it never sets FLOW_WINKERNEL), so the two drivers take
    the same steps; winkernel=True is the window-kernel route (winkernel_S
    pins the window stride). tangent_mode is the einsum Newton tangent's
    ("linearize" or "jvp", FastStepper).

    backend="packed" runs PackedPatchStepper (navier_stokes/patchfast.py)
    on the packed patch layouts of the problem's refinement hierarchy, with
    its own PackedPatchP1Hierarchy and the stepper's default GMRES momentum
    solve: lagged convection only, and n_refine >= 1 (anything else raises
    ValueError). The state stays packed for the whole run; a global-layout
    initial_state or checkpoint is packed once, checkpoints are written in
    the global layout, and the returned u/p are global.

    lmax: the pressure multigrid hierarchy's per-level lambda_max (coarse to
    fine), e.g. the JAX package's, instead of the power iteration's
    estimate. `device` and `dtype` are those of the problem built here
    (defaults: the card, torch's default dtype); a given `problem` brings
    its own. Pass problem= (e.g. schafer_turek_problem(...)) for another
    channel. Returns the state as tensors (u [n_V, 2], p [n_Q]), the last
    dt, the telemetry as numpy arrays (t rebuilt from the dt series) and the
    host seconds of each chunk."""
    from ..io import load_checkpoint, save_checkpoint

    if backend not in ("fast", "packed"):
        raise ValueError(f"run_karman_fast: unknown backend {backend!r}")
    packed = backend == "packed"
    if packed and convection != "lagged":
        raise ValueError("run_karman_fast: the packed backend is lagged-only "
                         f"(convection={convection!r})")
    if initial_state is None and not from_rest:
        raise NotImplementedError(
            "run_karman_fast: the Stokes bootstrap (from_rest=False) is not "
            "ported (ROADMAP queue 1 item 3: stokes.py)"
        )
    if problem is None:
        problem = KarmanProblem(lcar=lcar, n_refine=n_refine, mu=mu,
                                dtype=dtype, device=device)
    if packed and len(problem.mesh_hierarchy) < 2:
        raise ValueError("run_karman_fast: the packed backend needs a refined "
                         "hierarchy (n_refine >= 1)")

    if force_probe == "consistent":
        forces_probe = problem.consistent_force_probe()
    elif force_probe == "traction":
        forces_probe = problem.traction_force
    else:
        raise ValueError(f"run_karman_fast: unknown force_probe {force_probe!r}")

    if packed:
        from ..fem.patch import build_patch_info
        from ..navier_stokes.patchfast import PackedPatchStepper

        stepper = PackedPatchStepper(
            problem.V, problem.Q, problem.u_bcs, problem.p_bcs, problem.rho,
            problem.mu, build_patch_info(problem.mesh_hierarchy),
            time_step_method=time_step_method, newton_tol=0.0,
            newton_rtol=newton_rtol, linear_rtol=linear_rtol,
            pressure_rtol=pressure_rtol, correction_rtol=correction_rtol,
            cfl_target=cfl_target, dt_max=dt_max, forces_probe=forces_probe,
        )
        hier = stepper.hierarchy
    else:
        from ..navier_stokes.fast import FastStepper

        stepper = FastStepper(
            problem.V, problem.Q, problem.u_bcs, problem.p_bcs, problem.rho,
            problem.mu, time_step_method=time_step_method, rotational_form=True,
            convection=convection, newton_tol=0.0, newton_rtol=newton_rtol,
            newton_maxiter=newton_maxiter, linear_rtol=linear_rtol,
            ew_forcing=ew_forcing, pressure_rtol=pressure_rtol,
            correction_rtol=correction_rtol, cfl_target=cfl_target, dt_max=dt_max,
            forces_probe=forces_probe, winkernel=winkernel, winkernel_S=winkernel_S,
            tangent_mode=tangent_mode,
        )
        hier = None
        if use_multigrid and n_refine > 0:
            from ..solvers.multigrid import P1Hierarchy

            # every level ELL on the einsum route; the window route's finest
            # level reuses the pressure operator
            hier = P1Hierarchy(problem.mesh_hierarchy, bc_mask=stepper.mask_p,
                               smoother_degree=3, winkernel=winkernel,
                               fine_window=stepper.K_Q if winkernel else None)
            stepper.pressure_precond = hier.v_cycle
    if lmax is not None and hier is not None:
        from ..interop import load_hierarchy_lmax

        load_hierarchy_lmax(hier, lmax)

    def on_device(a):
        return torch.as_tensor(a, dtype=stepper.dtype, device=stepper.device)

    def to_run_layout(U, P, Um1=None):
        """A global-layout state -> the packed one on the packed backend."""
        U, P = on_device(U), on_device(P)
        Um1 = None if Um1 is None else on_device(Um1)
        if packed and U.dim() == 2:
            U, P = stepper.to_packed_state(U, P)
            Um1 = None if Um1 is None else stepper.pack_vec(Um1)
        return U, P, Um1

    if initial_state is not None:
        U, P, _ = to_run_layout(*initial_state)  # e.g. a perturbed state
    else:
        U, P = stepper.zeros()

    # checkpoint/resume of (U, P, dt); BDF2 also carries (Um1, dtp) so
    # chained runs stay second order
    Um1, dtp = None, None
    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        arrays, scalars = load_checkpoint(checkpoint_path)
        has_um1 = stepper.bdf2 and "Um1" in arrays
        U, P, Um1 = to_run_layout(arrays["U"], arrays["P"],
                                  arrays["Um1"] if has_um1 else None)
        dt0 = scalars["dt"]
        if has_um1:
            dtp = scalars["dtp"]

    def global_state(U, P):
        return stepper.from_packed_state(U, P) if packed else (U, P)

    chunk = min(num_steps, chunk_size)
    n_chunks, rem = divmod(num_steps, chunk)
    dt = dt0
    tels = []

    def save():
        if checkpoint_path:
            Ug, Pg = global_state(U, P)
            arrays, scalars = {"U": Ug, "P": Pg}, {"dt": float(dt)}
            if stepper.bdf2 and Um1 is not None:
                arrays["Um1"] = global_state(Um1, P)[0]
                scalars["dtp"] = float(dtp)
            save_checkpoint(checkpoint_path, arrays, scalars)

    chunk_seconds = []
    t0 = time.perf_counter()
    for ci in range(n_chunks + (1 if rem else 0)):
        n = chunk if ci < n_chunks else rem
        tc = time.perf_counter()
        if stepper.bdf2:
            U, P, dt, tel, (Um1, dtp) = stepper.run(U, P, dt, n, Um1=Um1,
                                                    dtp0=dtp, dt_max=dt_max)
        else:
            U, P, dt, tel = stepper.run(U, P, dt, n, dt_max=dt_max)
        # the copy to the host waits for the chunk's device work
        tels.append({k: v.cpu().numpy() for k, v in tel.items()})
        chunk_seconds.append(time.perf_counter() - tc)
        save()
        if progress and ci < n_chunks:
            done = (ci + 1) * chunk
            print(f"  chunk {ci + 1}/{n_chunks}: {done} steps, "
                  f"{done / (time.perf_counter() - t0):.2f} steps/s, "
                  f"dt={float(dt):.4f}", flush=True)
    telemetry = {k: np.concatenate([t[k] for t in tels]) for k in tels[0]}
    # each chunk's time axis restarts at 0: rebuild it from the dt series
    telemetry["t"] = np.cumsum(telemetry["dt"])
    U, P = global_state(U, P)
    return {
        "problem": problem,
        "stepper": stepper,
        "u": U,
        "p": P,
        "dt": float(dt),
        "t": telemetry["t"],
        "forces": telemetry["forces"],
        "telemetry": telemetry,
        "chunk_seconds": chunk_seconds,
    }


def strouhal_number(t, lift, min_periods=3, diameter=OBSTACLE_DIAMETER,
                    u_ref=ENTRANCE_VELOCITY):
    """St = f d / U from a lift time series (uniformly resampled, dominant
    FFT frequency), or None when the series covers fewer than min_periods
    periods. diameter/u_ref default to the reference geometry; pass
    problem.diameter/problem.u_ref for other channels."""
    t = np.asarray(t, dtype=float)
    lift = np.asarray(lift, dtype=float)
    tu = np.linspace(t[0], t[-1], 4 * len(t))
    lu = np.interp(tu, t, lift - lift.mean())
    freqs = np.fft.rfftfreq(len(tu), d=tu[1] - tu[0])
    amp = np.abs(np.fft.rfft(lu))
    amp[0] = 0.0
    f = freqs[int(np.argmax(amp))]
    if f * (t[-1] - t[0]) < min_periods:
        return None
    return f * diameter / u_ref
