# Karman vortex street: flow past a cylinder in a channel, the benchmark
# problem of the repository (Re=100 on the BASELINE metric). Port of
# flow_tpu/models/karman.py::KarmanProblem: the geometry, the refine_uniform
# mesh hierarchy (for multigrid), the P2/P1 spaces and the boundary
# conditions. The Stokes bootstrap, the force probes and the run_karman
# drivers are not ported.
from __future__ import annotations

import numpy as np

from .. import materials
from ..fem.bc import DirichletBC
from ..fem.spaces import FunctionSpace, VectorFunctionSpace
from ..mesh import rectangle_with_hole_mesh, refine_uniform

__all__ = ["KarmanProblem"]

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
        self.obstacle_predicate = obstacle
        self.reynolds = self.u_ref * diameter * self.rho / mu

    @property
    def n_dofs(self):
        """Velocity and pressure unknowns: 2 n_V + n_Q."""
        return 2 * self.V.n_dofs + self.Q.n_dofs
