# Coupled Navier-Stokes + heat (Boussinesq) driver. Port of
# flow_tpu/models/boussinesq.py: a rectangle-with-hole water tank, a heater
# ramp on the hole's boundary, a Banach fixed-point iteration over the
# velocity/temperature coupling, exception-driven dt backoff, and the
# Banach-step-count dt controller. The time loop advances t by the
# proposed next dt, as the JAX driver does.
from __future__ import annotations

import time

import numpy as np
import torch

from .. import heat, materials, navier_stokes, parabolic
from ..fem.bc import DirichletBC
from ..fem.interpolate import project
from ..fem.spaces import Function, FunctionSpace, VectorFunctionSpace
from ..mesh import rectangle_with_hole_mesh, refine_uniform
from ..message import Message, begin, end, info
from ..utils.timestep import AdaptiveTimeController

__all__ = ["compute_boussinesq", "rho_of_theta", "buoyancy_function", "buoyancy"]

X0, X1 = 0.0, 0.1
Y0, Y1 = 0.0, 0.2
CX, CY, R = 0.05, 0.05, 0.02
MESH_EPS = 1.0e-9


def _hot(x):
    # the interior (hole) boundary
    return (
        (x[:, 0] > X0 + MESH_EPS)
        & (x[:, 0] < X1 - MESH_EPS)
        & (x[:, 1] > Y0 + MESH_EPS)
        & (x[:, 1] < Y1 - MESH_EPS)
    )


def _cool(x):
    return (
        (x[:, 0] < X0 + MESH_EPS)
        | (x[:, 0] > X1 - MESH_EPS)
        | (x[:, 1] < Y0 + MESH_EPS)
        | (x[:, 1] > Y1 - MESH_EPS)
    )


def _clock(device, telemetry):
    """Synchronised host seconds where telemetry is kept, else None (no
    device sync on a run that keeps none)."""
    if telemetry is None:
        return None
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def compute_boussinesq(
    target_time,
    lcar,
    supg=False,
    dt0=1.0e-2,
    dt_max=1.0,
    verbose=False,
    writer=None,
    n_refine=0,
    backend=None,
    dtype=torch.float64,
    device=None,
    telemetry=None,
):
    """Run the coupled simulation to `target_time`; returns (u1, p1, theta1).

    n_refine > 0 builds the mesh as coarse(lcar) + refine_uniform^n; the
    chain then feeds the on-device multigrid heat solve (above
    heat.DENSE_THRESHOLD dofs) instead of the host sparse LU.
    backend: None (einsum context) | "packed"/"auto": the Navier-Stokes
    step through the packed-patch stepper (needs n_refine > 0; the
    buoyancy is then its nodal vector field). dtype: float64 by default
    (the driver's absolute tolerances are float64 ones); device None: the
    card.

    telemetry (a list, optional): one dict per Banach sweep is appended:
    the step's index, t and dt, the sweep, the heat solver and its
    iterations, the Navier-Stokes step's iteration counts, the Banach
    residuals, and the synchronised seconds of the heat and NS parts; a
    sweep that fails (an unconverged NS step, or the Banach iteration's
    cap) appends {"step", "t", "dt", "sweep", "failed"} before the dt
    backoff."""
    mesh = rectangle_with_hole_mesh(X0, X1, Y0, Y1, cx=CX, cy=CY, r=R, lcar=lcar,
                                    dtype=dtype, device=device)
    mesh_hierarchy = [mesh]
    for _ in range(n_refine):
        mesh = refine_uniform(mesh)
        mesh_hierarchy.append(mesh)
    heat_hierarchy = mesh_hierarchy if n_refine > 0 else None
    device = mesh.device

    room_temp = 293.0
    max_heater_temp = 320.0
    g_const = -9.81

    rho = materials.water.density
    mu = float(materials.water.dynamic_viscosity(room_temp))
    cp = materials.water.specific_heat_capacity
    kappa = materials.water.thermal_conductivity

    V = VectorFunctionSpace(mesh, 2)
    P = FunctionSpace(mesh, 1)
    Q = FunctionSpace(mesh, 2)  # temperature space, P2

    theta0 = project(room_temp, Q).rename("temperature")
    u0 = project((0.0, 0.0), V).rename("velocity")
    rho_room = float(rho(room_temp))
    p0 = project(lambda x: rho_room * g_const * x[..., 1], P).rename("pressure")

    u_bcs = [DirichletBC(V, (0.0, 0.0), "on_boundary")]
    p_bcs = []

    t = 0.0
    step_index = 0
    ctrl = AdaptiveTimeController(dt0, dt_max=dt_max, alpha=0.5, growth=2.0)
    u1, p1, theta1 = u0, p0, theta0

    while t < target_time + 1.0e-14:
        dt = ctrl.dt
        begin("Time step %e -> %e..." % (t, t + dt))
        # heater ramp room -> max over 30 s
        t1 = 30.0
        heater_temp = room_temp + min(1.0, t / t1) * (max_heater_temp - room_temp)

        u_prev = u0.copy()
        theta_prev = theta0.copy()
        is_banach_converged = False
        banach_tol = 1.0e-1
        max_banach_steps = 10
        target_banach_steps = 5
        banach_step = 0
        failed = False
        while not is_banach_converged:
            banach_step += 1
            if banach_step > max_banach_steps:
                if telemetry is not None:
                    telemetry.append({"step": step_index, "t": t, "dt": dt,
                                      "sweep": banach_step, "failed": "banach"})
                info(
                    "Banach solver failed to converge. Decrease time step "
                    "from %e to %e and try again." % (dt, 0.25 * dt)
                )
                ctrl.backoff(0.25)
                failed = True
                end()
                break
            begin("Banach step %d:" % banach_step)

            t_heat = _clock(device, telemetry)
            with Message("Computing heat..."):
                heat_bcs = [
                    DirichletBC(Q, heater_temp, _hot),
                    DirichletBC(Q, room_temp, _cool),
                ]
                # all coefficients at room temperature
                op = heat.Heat(
                    Q,
                    u_prev,
                    float(kappa(room_temp)),
                    float(rho(room_temp)),
                    float(cp(room_temp)),
                    heat_bcs,
                    0.0,
                    supg_stabilization=supg,
                    mesh_hierarchy=heat_hierarchy,
                )
                theta1 = parabolic.ImplicitEuler(op).step(theta0, t, dt)
            t_ns = _clock(device, telemetry)

            begin("Computing flux and pressure...")
            use_packed = backend in ("packed", "auto") and n_refine > 0
            stepper = navier_stokes.Rotational(
                backend="packed" if use_packed else None
            )
            # Boussinesq buoyancy: f = rho(theta_prev) * g
            rho_theta = rho_of_theta(theta_prev, rho)
            if use_packed:
                # the nodal vector field rho(theta) g on V: the packed mass
                # integrates its interpolant exactly, as the einsum path's
                # quadrature integrates the same interpolant
                fb = buoyancy_function(rho_theta, g_const, V)
            else:
                fb = buoyancy(rho_theta, g_const)
            try:
                u1, p1 = stepper.step(
                    dt,
                    {0: u0},
                    p0,
                    u_bcs,
                    p_bcs,
                    float(rho(room_temp)),
                    mu,
                    f={0: fb, 1: fb},
                    verbose=False,
                    tol=1.0e-10,
                )
            except RuntimeError:
                if telemetry is not None:
                    telemetry.append({"step": step_index, "t": t, "dt": dt,
                                      "sweep": banach_step,
                                      "failed": "navier-stokes"})
                info(
                    "Navier-Stokes solver failed to converge. Decrease time "
                    "step from %e to %e and try again." % (dt, 0.5 * dt)
                )
                ctrl.backoff(0.5)
                failed = True
                end()
                end()
                end()
                break
            end()

            u_diff_norm = float(
                torch.max(torch.sum(torch.abs(u1.vector - u_prev.vector), dim=1))
            )
            theta_diff_norm = float(
                torch.max(torch.abs(theta1.vector - theta_prev.vector)))
            t_end = _clock(device, telemetry)
            info("Banach residuals:")
            info("   ||u - u_prev||         = %e" % u_diff_norm)
            info("   ||theta - theta_prev|| = %e" % theta_diff_norm)
            if telemetry is not None:
                telemetry.append({
                    "step": step_index, "t": t, "dt": dt, "sweep": banach_step,
                    "heat_solver": op.last_solve["solver"],
                    "heat_iters": op.last_solve["iters"],
                    **{k: v for k, v in stepper.last_stats.items()},
                    "u_diff": u_diff_norm, "theta_diff": theta_diff_norm,
                    "heat_seconds": t_ns - t_heat, "ns_seconds": t_end - t_ns,
                })

            is_banach_converged = (
                u_diff_norm < banach_tol and theta_diff_norm < banach_tol
            )
            u_prev = u1.copy()
            theta_prev = theta1.copy()
            end()

        if failed:
            continue

        theta0, u0, p0 = theta1, u1, p1
        step_index += 1
        if writer is not None:
            writer.write(theta0, t)
            writer.write(u0, t)
            writer.write(p0, t)
        end()

        begin("Step size adaptation...")
        # the Banach-step-count smooth controller
        target_dt = dt * target_banach_steps / banach_step
        info("current dt: %e" % dt)
        info("target dt:  %e" % target_dt)
        dt = ctrl.propose(target_dt)
        info("next dt:    %e" % dt)
        t += dt
        end()

    return u1, p1, theta1


def rho_of_theta(theta: Function, rho_fn):
    """The temperature-dependent density as a Function on theta's space
    (rho_fn evaluated on the host in numpy, as the JAX package does)."""
    v = theta.vector
    vals = np.asarray(rho_fn(v.detach().cpu().numpy()))
    return Function(theta.space, torch.as_tensor(vals, dtype=v.dtype, device=v.device))


def _vertical(vals, g_const, dim):
    """rho g along the last axis of a dim-vector field: (0, ..., 0, rho g)."""
    zero = torch.zeros_like(vals)
    return torch.stack([zero] * (dim - 1) + [vals * g_const], dim=-1)


def buoyancy_function(rho_theta: Function, g_const, V):
    """f = rho(theta) * (0, ..., g) as a nodal vector Function on V (the
    packed routes' representation; theta's P2 space shares V's scalar dof
    numbering)."""
    vals = rho_theta.vector
    assert vals.shape[0] == V.n_dofs, "temperature space must match V's P2"
    return Function(V, _vertical(vals, g_const, V.n_components))


def buoyancy(rho_theta: Function, g_const):
    """f = rho(theta) * (0, ..., g) as a callable of the force rule's
    quadrature points (the density through its own basis there), in 2-D or
    3-D."""
    space = rho_theta.space

    def f(x):
        from ..fem import assembly
        from ..navier_stokes.pressure_correction import F_RULE

        v = rho_theta.vector
        tab = assembly.tabulation(space, F_RULE).on(v.dtype, v.device)
        vals = assembly.values_at_qp(tab, space.gather(v))
        return _vertical(vals, g_const, getattr(space.mesh, "dim", 2))

    return f
