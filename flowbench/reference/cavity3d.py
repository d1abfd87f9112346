"""The lid-driven unit cube of a configuration, worked out again for the
reference: n^3 cubes, each cut into the six Kuhn tetrahedra around its main
diagonal, no slip on the walls, u_x = lid speed on z = 1, the pressure
pure Neumann (its constant left out)."""
from __future__ import annotations

import numpy as np
import torch

HAS_DS = False  # every boundary velocity dof is Dirichlet

# the six tetrahedra of a cube as paths from corner 0 to corner 7; corner
# bit 0 is x, bit 1 y, bit 2 z
KUHN = [(0, 1, 3, 7), (0, 1, 5, 7), (0, 2, 3, 7), (0, 2, 6, 7), (0, 4, 5, 7),
        (0, 4, 6, 7)]


def mesh(cfg):
    n = cfg["n"]
    g = np.linspace(0.0, 1.0, n + 1)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], 1)
    I, J, K = (a.ravel() for a in np.meshgrid(*(np.arange(n),) * 3, indexing="ij"))

    def vid(i, j, k):
        return (i * (n + 1) + j) * (n + 1) + k

    corners = np.stack([vid(I + (c & 1), J + ((c >> 1) & 1), K + ((c >> 2) & 1))
                        for c in range(8)], 1)
    cells = np.concatenate([corners[:, list(t)] for t in KUHN], 0)
    return pts, cells.astype(np.int64)


def boundary_conditions(fe, cfg):
    """(mask [n2, 3], values [n2, 3], None: no pressure pin)."""
    on = fe.on_boundary2
    mask = torch.zeros(fe.n2, 3, dtype=torch.float64, device=on.device)
    mask[on] = 1.0
    val = torch.zeros_like(mask)
    lid = on & (fe.dof_points[:, 2] > 1 - 1e-12)
    val[lid, 0] = cfg["lid_speed"]
    return mask, val, None


def velocity_scale(cfg):
    return cfg["lid_speed"]
