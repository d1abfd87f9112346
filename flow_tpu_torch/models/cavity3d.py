# 3-D lid-driven cavity on a structured box: the pure Navier-Stokes
# throughput workload of the box path and of FastStepper's 3-D routes. Port
# of flow_tpu/models/cavity3d.py: Cavity3DProblem, and run_cavity3d_fast on
# FastStepper's einsum route (the JAX driver's) or its window-kernel route,
# with the structured multigrid as the pressure preconditioner.
from __future__ import annotations

import time

import numpy as np

from ..fem.bc import DirichletBC
from ..fem.spaces import FunctionSpace, VectorFunctionSpace
from ..mesh3d import box_mesh

__all__ = ["Cavity3DProblem", "run_cavity3d_fast"]


class Cavity3DProblem:
    """Unit cube, n^3 Kuhn cubes, P2/P1 Taylor-Hood, lid u_x = lid_speed on
    z = 1 and no-slip elsewhere. `dtype` and `device` are those of the mesh
    and the default of a stepper built on it."""

    def __init__(self, n=16, rho=1.0, mu=0.01, lid_speed=1.0, dtype=None,
                 device=None):
        mesh = box_mesh((0, 0, 0), (1, 1, 1), n, n, n, dtype=dtype,
                        device=device)
        self.mesh = mesh
        self.rho = rho
        self.mu = mu
        self.V = VectorFunctionSpace(mesh, 2, n_components=3)
        self.Q = FunctionSpace(mesh, 1)

        def lid(x):
            return np.where(x[:, 2] > 1 - 1e-12, lid_speed, 0.0)

        self.u_bcs = [
            DirichletBC(self.V.sub(0), lid, "on_boundary"),
            DirichletBC(self.V.sub(1), 0.0, "on_boundary"),
            DirichletBC(self.V.sub(2), 0.0, "on_boundary"),
        ]
        self.p_bcs = []


def run_cavity3d_fast(
    num_steps=50,
    n=16,
    mu=0.01,
    dt0=1.0e-3,
    newton_rtol=1.0e-3,
    pressure_rtol=1.0e-4,
    use_structured_mg=True,
    winkernel=False,
    winkernel_S=None,
    tangent_mode="linearize",
    chunk_size=None,
    lmax=None,
    device=None,
    dtype=None,
):
    """The 3-D cavity on FastStepper at the JAX driver's settings (Newton,
    backward Euler, newton_rtol 1e-3 / maxiter 3, linear_rtol 1e-4,
    pressure_rtol 1e-4, correction 1e-5, CFL 1 with dt_max 0.1), the
    pure-Neumann pressure preconditioned by StructuredHierarchy's V-cycle.

    winkernel=False is the einsum route, the JAX driver's: the pressure
    operator is the assembled ELL stiffness, and tangent_mode sets the
    Newton tangent's storage ("linearize" or "jvp", FastStepper).
    winkernel=True is the window-kernel route (winkernel_S pins the
    velocity window stride). `device` and `dtype` are
    the problem's (defaults: the card, torch's default dtype). The steps
    run in chunks of `chunk_size` (default: one chunk), each ending in a
    copy of its telemetry to the host. lmax: the hierarchy's per-level
    lambda_max (coarse to fine), e.g. the JAX package's, instead of the
    power iteration's estimate.

    Returns the state as tensors (U [n_V, 3], P [n_Q]), the last dt, the
    telemetry as numpy arrays, the host seconds of setup (with the window
    layouts' share, 0 on the einsum route) and of each chunk."""
    from ..navier_stokes.fast import FastStepper

    t0 = time.perf_counter()
    prob = Cavity3DProblem(n=n, mu=mu, dtype=dtype, device=device)
    stepper = FastStepper(
        prob.V, prob.Q, prob.u_bcs, prob.p_bcs, prob.rho, prob.mu,
        rotational_form=True, newton_tol=0.0, newton_rtol=newton_rtol,
        newton_maxiter=3, linear_rtol=1.0e-4, pressure_rtol=pressure_rtol,
        correction_rtol=1.0e-5, cfl_target=1.0, dt_max=0.1,
        winkernel=winkernel, winkernel_S=winkernel_S, tangent_mode=tangent_mode,
    )
    if use_structured_mg:
        from ..solvers.structured_mg import StructuredHierarchy

        hier = StructuredHierarchy(prob.mesh)  # pure-Neumann pressure
        if lmax is not None:
            from ..interop import load_hierarchy_lmax

            load_hierarchy_lmax(hier, lmax)
        stepper.pressure_precond = hier.v_cycle
    U, P = stepper.zeros()
    setup = time.perf_counter() - t0

    chunk = min(num_steps, chunk_size or num_steps)
    dt = dt0
    tels, chunk_seconds = [], []
    done = 0
    while done < num_steps:
        k = min(chunk, num_steps - done)
        tc = time.perf_counter()
        U, P, dt, tel = stepper.run(U, P, dt, n_steps=k)
        # the copy to the host waits for the chunk's device work
        tels.append({key: v.cpu().numpy() for key, v in tel.items()})
        chunk_seconds.append(time.perf_counter() - tc)
        done += k
    telemetry = {key: np.concatenate([t[key] for t in tels]) for key in tels[0]}
    telemetry["t"] = np.cumsum(telemetry["dt"])
    return {
        "problem": prob,
        "stepper": stepper,
        "U": U,
        "P": P,
        "dt": float(dt),
        "telemetry": telemetry,
        "setup_seconds": setup,
        "layout_seconds": (stepper.winmom.layout_seconds + stepper.K_Q.layout_seconds
                           if winkernel else 0.0),
        "chunk_seconds": chunk_seconds,
    }
