"""The Karman channel of a configuration, worked out again for the
reference: the coarse mesh (a frozen copy of the program's generator: a
background grid, the cylinder cut out, Delaunay, Laplacian smoothing; the
bandwidth reordering left out, since dofs are matched by their
coordinates), uniform red refinement with boundary midpoints snapped onto
the cylinder, and the boundary conditions of the problem."""
from __future__ import annotations

import numpy as np
import torch

MESH_EPS = 1.0e-12
HAS_DS = True  # the outflow and inflow ds terms of the momentum operator


def coarse_mesh(x0, x1, y0, y1, cx, cy, r, lcar, smooth_iters=30):
    import scipy.spatial

    nx = max(4, int(round((x1 - x0) / lcar)))
    ny = max(4, int(round((y1 - y0) / lcar)))
    h = min((x1 - x0) / nx, (y1 - y0) / ny)
    X, Y = np.meshgrid(np.linspace(x0, x1, nx + 1), np.linspace(y0, y1, ny + 1),
                       indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel()], axis=1)
    d = np.linalg.norm(pts - [cx, cy], axis=1) - r
    snap = np.abs(d) < 0.5 * h
    th = np.arctan2(pts[:, 1] - cy, pts[:, 0] - cx)
    pts[snap] = np.stack([cx + r * np.cos(th[snap]), cy + r * np.sin(th[snap])], 1)
    d = np.linalg.norm(pts - [cx, cy], axis=1) - r

    def on_rect(p):
        return ((np.abs(p[:, 0] - x0) < 1e-12) | (np.abs(p[:, 0] - x1) < 1e-12)
                | (np.abs(p[:, 1] - y0) < 1e-12) | (np.abs(p[:, 1] - y1) < 1e-12))

    pk = pts[np.where((d > -1e-12) | on_rect(pts))[0]]
    cells = scipy.spatial.Delaunay(pk).simplices.astype(np.int32)
    cent = pk[cells].mean(axis=1)
    inside = np.linalg.norm(cent - [cx, cy], axis=1) < r * (1.0 - 1e-9)
    d0 = pk[cells[:, 1]] - pk[cells[:, 0]]
    d1 = pk[cells[:, 2]] - pk[cells[:, 0]]
    area = 0.5 * np.abs(d0[:, 0] * d1[:, 1] - d0[:, 1] * d1[:, 0])
    cells = cells[~inside & ~(area < 1e-6 * h * h)]
    used = np.unique(cells)
    remap = -np.ones(len(pk), dtype=np.int64)
    remap[used] = np.arange(len(used))
    pk = pk[used]
    cells = remap[cells].astype(np.int32)
    fixed = (np.abs(np.linalg.norm(pk - [cx, cy], axis=1) - r) < 1e-9) | on_rect(pk)
    e_all = np.concatenate([cells[:, [1, 2]], cells[:, [2, 0]], cells[:, [0, 1]]], 0)
    e_all = np.unique(np.sort(e_all, axis=1), axis=0)
    for _ in range(smooth_iters):
        acc = np.zeros_like(pk)
        cnt = np.zeros(len(pk))
        np.add.at(acc, e_all[:, 0], pk[e_all[:, 1]])
        np.add.at(acc, e_all[:, 1], pk[e_all[:, 0]])
        np.add.at(cnt, e_all[:, 0], 1)
        np.add.at(cnt, e_all[:, 1], 1)
        pk = np.where(fixed[:, None], pk, acc / np.maximum(cnt, 1)[:, None])
    return pk, cells.astype(np.int64)


def refine(points, cells, cx, cy, r):
    """Each triangle into 4; new boundary midpoints within 0.3 r of the
    cylinder are moved onto it."""
    nv = len(points)
    loc = [(1, 2), (2, 0), (0, 1)]  # local edge k opposite vertex k
    pairs = np.stack([np.sort(cells[:, list(e)], axis=1) for e in loc], 1)
    key = pairs[..., 0].astype(np.int64) * nv + pairs[..., 1]
    ukey, inv, cnt = np.unique(key.ravel(), return_inverse=True, return_counts=True)
    e0, e1 = ukey // nv, ukey % nv
    mid = 0.5 * (points[e0] + points[e1])
    bnd = cnt == 1
    p = mid[bnd]
    th = np.arctan2(p[:, 1] - cy, p[:, 0] - cx)
    dist = np.linalg.norm(p - [cx, cy], axis=1)
    near = np.abs(dist - r) < 0.3 * r
    p[near] = np.stack([cx + r * np.cos(th[near]), cy + r * np.sin(th[near])], 1)
    mid[bnd] = p
    m = nv + inv.reshape(-1, 3)
    v0, v1, v2 = cells.T
    m0, m1, m2 = m.T
    new = np.concatenate([np.stack(t, 1) for t in (
        (v0, m2, m1), (v1, m0, m2), (v2, m1, m0), (m0, m1, m2))], 0)
    return np.concatenate([points, mid], 0), new


def mesh(cfg):
    g = cfg["geometry"]
    r = 0.5 * g["diameter"]
    cx, cy = g["center"]
    p, c = coarse_mesh(g["x0"], g["x1"], g["y0"], g["y1"], cx, cy, r, cfg["lcar"])
    for _ in range(cfg["n_refine"]):
        p, c = refine(p, c, cx, cy, r)
    return p, c


def boundary_conditions(fe, cfg):
    """(mask [n2, 2], values [n2, 2], pressure pin mask [nv]) on the
    reference's dofs: no slip on the walls and the cylinder, the parabolic
    profile's x component at the inlet and the outlet, the pressure pinned
    to 0 at the outlet."""
    g = cfg["geometry"]
    x0, x1, y0, y1, u_in = g["x0"], g["x1"], g["y0"], g["y1"], g["u_in"]
    X = fe.dof_points
    on = fe.on_boundary2
    x, y = X[:, 0], X[:, 1]
    left, right = on & (x < x0 + MESH_EPS), on & (x > x1 - MESH_EPS)
    walls = on & ((y < y0 + MESH_EPS) | (y > y1 - MESH_EPS))
    obstacle = on & (x > x0 + MESH_EPS) & (x < x1 - MESH_EPS) & (y > y0 + MESH_EPS) \
        & (y < y1 - MESH_EPS)
    profile = u_in * (y1 - y) * (y - y0) / (0.5 * (y1 - y0)) ** 2
    mask = torch.zeros(fe.n2, 2, dtype=torch.float64, device=X.device)
    val = torch.zeros_like(mask)
    mask[walls | obstacle] = 1.0
    val[walls | obstacle] = 0.0
    for side in (left, right):
        mask[side, 0] = 1.0
        val[side, 0] = profile[side]
    pin = (fe.on_boundary1 & (fe.points[:, 0] > x1 - MESH_EPS)).to(torch.float64)
    return mask, val, pin


def velocity_scale(cfg):
    return cfg["geometry"]["u_in"]
