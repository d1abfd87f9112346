# 3-D buoyancy-driven cavity: a box heated on a patch of its floor and
# cooled at its top. Port of flow_tpu/models/boussinesq3d.py (the target
# of BASELINE configs[4] at a toy size). The coupling is the 2-D driver's
# (models/boussinesq.py): a Banach fixed-point iteration over (u, theta),
# dt backoff on a solver failure, the Banach-count dt controller.
#
# Two Navier-Stokes routes: backend=None steps Rotational on the tets with
# the buoyancy rho(theta) g as a callable of the body-force quadrature
# points; backend="packed" steps BoxPackedStepper (navier_stokes/boxfast.py:
# Picard to the public Newton contract, the nodal buoyancy; its pressure
# operator and multigrid levels are StructuredLaplacian stencils, K1 on the
# card) on the box grid itself. The heat solve is heat.Heat's: dense up to
# heat.DENSE_THRESHOLD dofs, the shifted-multigrid GMRES where n_refine > 0
# gives it a hierarchy, else the host scipy splu (rebuilt every sweep with
# the Heat operator, as in the JAX package).
from __future__ import annotations

import numpy as np
import torch

from .. import heat, materials, navier_stokes, parabolic
from ..fem.bc import DirichletBC
from ..fem.interpolate import project
from ..fem.spaces import Function, FunctionSpace, VectorFunctionSpace
from ..mesh3d import box_mesh, refine_uniform_tet
from ..message import Message, begin, end, info
from ..utils.timestep import AdaptiveTimeController
from .boussinesq import _clock, buoyancy, buoyancy_function, rho_of_theta

__all__ = ["compute_boussinesq_3d"]

X1, Y1, Z1 = 0.1, 0.1, 0.2
MESH_EPS = 1.0e-9


def _hot(x):
    # heated floor patch (the center half of the bottom face)
    return (
        (x[:, 2] < MESH_EPS)
        & (np.abs(x[:, 0] - 0.5 * X1) < 0.25 * X1)
        & (np.abs(x[:, 1] - 0.5 * Y1) < 0.25 * Y1)
    )


def _cool(x):
    return x[:, 2] > Z1 - MESH_EPS


def compute_boussinesq_3d(
    target_time=0.1,
    n=(8, 8, 16),
    supg=False,
    dt0=1.0e-2,
    dt_max=1.0,
    heat_degree=2,
    n_refine=0,
    backend=None,
    dtype=torch.float64,
    device=None,
    telemetry=None,
):
    """Run the coupled 3-D simulation to `target_time`; returns (u1, p1,
    theta1).

    n: the box_mesh cell counts. n_refine > 0 refines the box that many
    times (refine_uniform_tet) and hands the chain to the heat solve, whose
    multigrid then runs above heat.DENSE_THRESHOLD dofs. backend="packed"
    ("auto" where n_refine is 0) steps BoxPackedStepper on the box grid;
    it needs n_refine=0 and heat_degree=2 (the buoyancy lives on V's scalar
    P2 numbering; ValueError otherwise). dtype: float64 by default (the
    driver's absolute tolerances are float64 ones); device None: the card.

    telemetry (a list, optional): one dict a Banach sweep, as in the 2-D
    driver: the step's index, t and dt, the sweep, the heat solver, its
    iterations (and on the splu path its factor seconds), the NS step's
    counts and Newton residual, the Banach residuals, the synchronised
    seconds of the heat and NS parts; a failed sweep appends {"step", "t",
    "dt", "sweep", "failed"} before the dt backoff."""
    if backend == "packed" and (n_refine != 0 or heat_degree != 2):
        raise ValueError("compute_boussinesq_3d: the box-packed backend needs "
                         "n_refine=0 (the structured grid) and heat_degree=2")
    use_packed = backend in ("packed", "auto") and n_refine == 0
    mesh = box_mesh((0.0, 0.0, 0.0), (X1, Y1, Z1), *n, dtype=dtype, device=device)
    mesh_hierarchy = [mesh]
    for _ in range(n_refine):
        mesh = refine_uniform_tet(mesh)
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
    rho_room = float(rho(room_temp))

    V = VectorFunctionSpace(mesh, 2, n_components=3)
    P = FunctionSpace(mesh, 1)
    Q = FunctionSpace(mesh, heat_degree)

    theta0 = project(room_temp, Q).rename("temperature")
    u0 = project((0.0, 0.0, 0.0), V).rename("velocity")
    p0 = project(lambda x: rho_room * g_const * x[..., 2], P).rename("pressure")

    u_bcs = [DirichletBC(V, (0.0, 0.0, 0.0), "on_boundary")]
    p_bcs = []

    t = 0.0
    step_index = 0
    ctrl = AdaptiveTimeController(dt0, dt_max=dt_max, alpha=0.5, growth=2.0)
    u1, p1, theta1 = u0, p0, theta0

    while t < target_time + 1.0e-14:
        dt = ctrl.dt
        begin("3D time step %e -> %e..." % (t, t + dt))
        t1 = 30.0
        heater_temp = room_temp + min(1.0, t / t1) * (max_heater_temp - room_temp)

        u_prev = u0.copy()
        theta_prev = theta0.copy()
        banach_step = 0
        failed = False
        while True:
            banach_step += 1
            if banach_step > 10:
                if telemetry is not None:
                    telemetry.append({"step": step_index, "t": t, "dt": dt,
                                      "sweep": banach_step, "failed": "banach"})
                info("Banach failed; dt %e -> %e" % (dt, 0.25 * dt))
                ctrl.backoff(0.25)
                failed = True
                break
            t_heat = _clock(device, telemetry)
            with Message("heat step"):
                heat_bcs = [
                    DirichletBC(Q, heater_temp, _hot),
                    DirichletBC(Q, room_temp, _cool),
                ]
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

            with Message("navier-stokes step"):
                rho_theta = rho_of_theta(theta_prev, rho)
                try:
                    if use_packed:
                        u1, p1, stats = _packed_ns_step(
                            V, P, u_bcs, rho_room, mu, dt, u0, p0, rho_theta,
                            g_const,
                        )
                    else:
                        stepper = navier_stokes.Rotational()
                        fb = buoyancy(rho_theta, g_const)
                        u1, p1 = stepper.step(
                            dt, {0: u0}, p0, u_bcs, p_bcs, rho_room, mu,
                            f={0: fb, 1: fb}, verbose=False, tol=1.0e-10,
                        )
                        stats = dict(stepper.last_stats)
                except RuntimeError:
                    if telemetry is not None:
                        telemetry.append({"step": step_index, "t": t, "dt": dt,
                                          "sweep": banach_step,
                                          "failed": "navier-stokes"})
                    info("NS failed; dt %e -> %e" % (dt, 0.5 * dt))
                    ctrl.backoff(0.5)
                    failed = True
                    break

            u_diff = float(torch.max(torch.sum(torch.abs(u1.vector - u_prev.vector),
                                               dim=1)))
            th_diff = float(torch.max(torch.abs(theta1.vector - theta_prev.vector)))
            t_end = _clock(device, telemetry)
            if telemetry is not None:
                row = {"step": step_index, "t": t, "dt": dt, "sweep": banach_step,
                       "heat_solver": op.last_solve["solver"],
                       "heat_iters": op.last_solve["iters"], **stats,
                       "u_diff": u_diff, "theta_diff": th_diff,
                       "heat_seconds": t_ns - t_heat, "ns_seconds": t_end - t_ns}
                if "factor_seconds" in op.last_solve:
                    row["heat_factor_seconds"] = op.last_solve["factor_seconds"]
                telemetry.append(row)
            u_prev, theta_prev = u1.copy(), theta1.copy()
            if u_diff < 1.0e-1 and th_diff < 1.0e-1:
                break

        end()
        if failed:
            continue

        theta0, u0, p0 = theta1, u1, p1
        step_index += 1
        target_dt = dt * 5.0 / banach_step
        t += ctrl.propose(target_dt)

    return u1, p1, theta1


def _packed_ns_step(V, P, u_bcs, rho_const, mu, dt, u0, p0, rho_theta, g_const):
    """One Rotational projection step through the box-packed stepper with
    the nodal buoyancy rho(theta) g e_z (the public Newton contract by
    Picard; RuntimeError where a solve did not converge, which drives the
    caller's dt backoff). The stepper is cached on V per (P, BCs, rho,
    mu). Returns (u1, p1, the step's counts and Newton residual)."""
    from ..navier_stokes.boxfast import BoxPackedStepper

    cache = getattr(V, "_box_b3d_cache", None)
    key = (id(P), tuple(id(b) for b in u_bcs), rho_const, mu)
    if cache is None or cache[0] != key:
        st = BoxPackedStepper(
            V, P, u_bcs, [], rho_const, mu,
            newton_tol=1.0e-10, picard_maxiter=10, picard_tol=1.0e-10,
            linear_rtol=1.0e-4, pressure_rtol=1.0e-10, correction_rtol=1.0e-10,
        )
        V._box_b3d_cache = (key, st)
    else:
        st = cache[1]
    f = buoyancy_function(rho_theta, g_const, V).vector
    Uf, Pf = st.to_packed_state(u0.vector, p0.vector)
    U1f, P1f, stats = st.step_api(Uf, Pf, dt, st.pack_vec(f))
    nres = float(stats.newton_res)
    if nres > 10.0 * 1.0e-10:
        raise RuntimeError(f"Newton solver did not converge (residual {nres:.3e})")
    if not bool(stats.pressure_converged):
        raise RuntimeError("Pressure Poisson solve did not converge")
    if not bool(stats.correction_converged):
        raise RuntimeError("Velocity correction solve did not converge")
    U1, P1 = st.from_packed_state(U1f, P1f)
    counts = {"newton_iters": int(stats.newton_iters), "newton_res": nres,
              "linear_iters": int(stats.linear_iters),
              "pressure_iters": int(stats.pressure_iters),
              "correction_iters": int(stats.correction_iters)}
    return Function(V, U1), Function(P, P1), counts
