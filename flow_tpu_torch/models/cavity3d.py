# 3-D lid-driven cavity on a structured box: the pure Navier-Stokes
# throughput workload of the box path. Port of
# flow_tpu/models/cavity3d.py (Cavity3DProblem only).
from __future__ import annotations

import numpy as np

from ..fem.bc import DirichletBC
from ..fem.spaces import FunctionSpace, VectorFunctionSpace
from ..mesh3d import box_mesh

__all__ = ["Cavity3DProblem"]


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
