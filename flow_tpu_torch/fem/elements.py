# Lagrange P1/P2 reference-element tabulation on simplices (2-D triangles,
# 3-D tetrahedra). Port of flow_tpu/fem/elements.py: host numpy, unchanged.
#
# Barycentric coordinates: l0 = 1 - sum(x), l_i = x_i.
# P1 dofs: local vertices.
# P2 dofs: vertices, then edge midpoints in edge_list(dim) order. For dim=2
#          edge k is opposite vertex k (dof 3+k = midpoint(v_{k+1}, v_{k+2}));
#          for dim=3 edges are the 6 canonical pairs
#          (0,1),(0,2),(0,3),(1,2),(1,3),(2,3).
from __future__ import annotations

from functools import lru_cache

import numpy as np

__all__ = [
    "tabulate",
    "n_local_dofs",
    "hessian_ref",
    "edge_list",
]


def edge_list(dim):
    if dim == 2:
        return [(1, 2), (2, 0), (0, 1)]
    return [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]


def n_local_dofs(degree, dim=2):
    nv = dim + 1
    return nv if degree == 1 else nv + len(edge_list(dim))


def _bary(points, dim):
    lam0 = 1.0 - points.sum(axis=1)
    return np.concatenate([lam0[:, None], points], axis=1)  # [nq, dim+1]


def _dlam(dim):
    return np.concatenate([-np.ones((1, dim)), np.eye(dim)], axis=0)  # [dim+1, dim]


def tabulate(degree, points, dim=2):
    """Tabulate basis values and reference gradients at `points` [nq, dim].

    Returns (phi [nq, nl], dphi [nq, nl, dim]).
    """
    points = np.asarray(points, dtype=np.float64).reshape(-1, dim)
    lam = _bary(points, dim)
    dlam = _dlam(dim)
    nq = len(points)
    nv = dim + 1
    if degree == 1:
        return lam.copy(), np.broadcast_to(dlam, (nq, nv, dim)).copy()
    assert degree == 2, f"unsupported degree {degree}"
    edges = edge_list(dim)
    nl = nv + len(edges)
    phi = np.empty((nq, nl))
    dphi = np.empty((nq, nl, dim))
    for i in range(nv):
        phi[:, i] = lam[:, i] * (2.0 * lam[:, i] - 1.0)
        dphi[:, i, :] = (4.0 * lam[:, i, None] - 1.0) * dlam[i]
    for k, (a, b) in enumerate(edges):
        phi[:, nv + k] = 4.0 * lam[:, a] * lam[:, b]
        dphi[:, nv + k, :] = 4.0 * (
            lam[:, a, None] * dlam[b] + lam[:, b, None] * dlam[a]
        )
    return phi, dphi


@lru_cache(maxsize=None)
def hessian_ref(degree, dim=2):
    """Constant reference Hessians H[i] [dim, dim] of each basis function
    (P2 is quadratic => constant; P1 => 0). Used for the rotational-form
    grad(div u*) term."""
    nl = n_local_dofs(degree, dim)
    H = np.zeros((nl, dim, dim))
    if degree == 2:
        dlam = _dlam(dim)
        nv = dim + 1
        for i in range(nv):
            H[i] = 4.0 * np.outer(dlam[i], dlam[i])
        for k, (a, b) in enumerate(edge_list(dim)):
            H[nv + k] = 4.0 * (
                np.outer(dlam[a], dlam[b]) + np.outer(dlam[b], dlam[a])
            )
    return H
