# Triangle meshes. Port of flow_tpu/mesh.py (Mesh, refine_uniform,
# reorder_rcm, rectangle_with_hole_mesh): topology is built on the host in
# numpy and by the meshkit library (native.py). As with TetMesh, every
# consumer is host setup code, so no device mirrors of the arrays are kept;
# `dtype` and `device` are the defaults of the spaces and steppers built on
# the mesh (device None: the current CUDA device, or an error where there
# is none).
#
# Local conventions (shared with fem/):
#   * cells are counterclockwise (det of the affine Jacobian > 0),
#   * local edge k of a cell is the edge opposite local vertex k, i.e. it
#     connects local vertices (k+1)%3 and (k+2)%3 (P2 dof 3+k is its
#     midpoint).
from __future__ import annotations

import numpy as np
import torch

from . import native
from .mesh3d import _device

__all__ = ["Mesh", "refine_uniform", "reorder_rcm", "rectangle_with_hole_mesh",
           "rectangle_mesh", "unit_square_mesh"]


class Mesh:
    """A 2-D triangle mesh (host numpy arrays).

      points_np            [n_points, 2] float64
      cells_np             [n_cells, 3] int32, CCW
      edges_np             [n_edges, 2] int32, each row sorted, unique
      cell_edges_np        [n_cells, 3] int32, global edge of local edge k
      boundary_edges_np    [n_bnd] int32, indices into edges
      boundary_cells_np    [n_bnd] int32, the cell of each boundary edge
      boundary_local_np    [n_bnd] int32, its local edge index there
      boundary_normals_np  [n_bnd, 2] unit outward normals
      boundary_lengths_np  [n_bnd]
      hmax, hmin           max/min cell diameter (longest edge)
    """

    dim = 2

    def __init__(self, points, cells, dtype=None, device=None):
        points = np.asarray(points, dtype=np.float64)[:, :2]
        cells = np.asarray(cells, dtype=np.int32)
        p = points
        d0 = p[cells[:, 1]] - p[cells[:, 0]]
        d1 = p[cells[:, 2]] - p[cells[:, 0]]
        det = d0[:, 0] * d1[:, 1] - d0[:, 1] * d1[:, 0]
        cells = cells.copy()
        flip = det < 0
        cells[flip] = cells[flip][:, [0, 2, 1]]

        nc = len(cells)
        edges, cell_edges, bnd_edge_ids = native.build_edges(cells)

        # (cell, local) of each boundary edge (exactly one occurrence)
        flat = cell_edges.ravel()
        order = np.argsort(flat, kind="stable")
        occurrence = order[np.searchsorted(flat[order], bnd_edge_ids)]
        boundary_cells = (occurrence // 3).astype(np.int32)
        boundary_local = (occurrence % 3).astype(np.int32)
        e_all = np.concatenate(
            [cells[:, [1, 2]], cells[:, [2, 0]], cells[:, [0, 1]]], axis=0
        )

        # outward normal of edge k of a CCW triangle: (v_{k+2} - v_{k+1})
        # rotated by -90 degrees
        a = cells[boundary_cells, (boundary_local + 1) % 3]
        b = cells[boundary_cells, (boundary_local + 2) % 3]
        t = p[b] - p[a]
        lengths = np.linalg.norm(t, axis=1)
        normals = np.stack([t[:, 1], -t[:, 0]], axis=1) / lengths[:, None]

        el = p[e_all[:, 1]] - p[e_all[:, 0]]
        h_cell = np.linalg.norm(el, axis=1).reshape(3, nc).max(axis=0)
        self.hmax = float(h_cell.max())
        self.hmin = float(h_cell.min())

        self.dtype = torch.get_default_dtype() if dtype is None else dtype
        self.device = _device(device)
        self.points_np = points
        self.cells_np = cells
        self.edges_np = edges.astype(np.int32)
        self.cell_edges_np = cell_edges
        self.boundary_edges_np = bnd_edge_ids
        self.boundary_cells_np = boundary_cells
        self.boundary_local_np = boundary_local
        self.boundary_normals_np = normals
        self.boundary_lengths_np = lengths

    @property
    def n_points(self):
        return self.points_np.shape[0]

    @property
    def n_cells(self):
        return self.cells_np.shape[0]

    @property
    def n_edges(self):
        return self.edges_np.shape[0]

    def __repr__(self):
        return (
            f"Mesh(n_points={self.n_points}, n_cells={self.n_cells}, "
            f"hmax={self.hmax:.3e})"
        )


_DIAGONALS = ("left", "right", "left/right", "right/left", "crossed")


def rectangle_mesh(p0, p1, nx, ny, diagonal="right", dtype=None, device=None):
    """Structured triangulation of the rectangle [p0, p1] (dolfin's
    RectangleMesh), with the JAX package's vertex ids (i*(ny+1) + j, y
    fastest) and cell order (quad (i, j) in row-major order, its triangles
    in turn), built with array operations instead of a loop over quads.

    ``diagonal`` in {'left', 'right', 'left/right', 'right/left',
    'crossed'}; 'crossed' adds one centre point per quad after the grid
    vertices and cuts the quad into 4. Uniform 'left'/'right' grids carry
    grid_shape (nx+1, ny+1) and grid_spacing, which the structured stencil
    operator (ops/structured.py) needs."""
    if diagonal not in _DIAGONALS:
        raise ValueError(f"unknown diagonal {diagonal!r}")
    x0, y0 = p0
    x1, y1 = p1
    xs = np.linspace(x0, x1, nx + 1)
    ys = np.linspace(y0, y1, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel()], axis=1)

    I, J = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    I, J = I.ravel(), J.ravel()
    v00 = I * (ny + 1) + J
    v10 = v00 + (ny + 1)
    v01 = v00 + 1
    v11 = v10 + 1
    if diagonal == "crossed":
        cc = (nx + 1) * (ny + 1) + I * ny + J
        centers = 0.25 * (pts[v00] + pts[v10] + pts[v01] + pts[v11])
        tris = [(v00, v10, cc), (v10, v11, cc), (v11, v01, cc), (v01, v00, cc)]
        pts = np.concatenate([pts, centers], axis=0)
    else:
        left = {"left": np.ones_like(I, dtype=bool), "right": np.zeros_like(I, dtype=bool),
                "left/right": (I + J) % 2 == 0, "right/left": (I + J) % 2 == 1}[diagonal]
        # left: diagonal from (i, j+1) to (i+1, j); right: (i, j) to (i+1, j+1)
        tris = [(v00, v10, np.where(left, v01, v11)),
                (np.where(left, v10, v00), v11, v01)]
    cells = np.stack([np.stack(t, axis=1) for t in tris], axis=1).reshape(-1, 3)
    mesh = Mesh(pts, cells, dtype=dtype, device=device)
    if diagonal in ("left", "right"):
        mesh.grid_shape = (nx + 1, ny + 1)
        mesh.grid_spacing = ((x1 - x0) / nx, (y1 - y0) / ny)
    return mesh


def unit_square_mesh(n, diagonal="right", dtype=None, device=None):
    """dolfin UnitSquareMesh(n, n, diagonal) equivalent."""
    return rectangle_mesh((0.0, 0.0), (1.0, 1.0), n, n, diagonal=diagonal,
                          dtype=dtype, device=device)


def refine_uniform(mesh: Mesh, snap_boundary=None):
    """Uniform red refinement: each triangle into 4. The fine vertices are
    [coarse vertices; coarse edge midpoints] (the multigrid prolongation
    relies on it). ``snap_boundary`` maps new boundary midpoints onto a
    curved boundary."""
    p = mesh.points_np
    c = mesh.cells_np
    e = mesh.edges_np
    ce = mesh.cell_edges_np
    n_old = len(p)

    mid = 0.5 * (p[e[:, 0]] + p[e[:, 1]])
    if snap_boundary is not None:
        bnd = mesh.boundary_edges_np
        mid[bnd] = snap_boundary(mid[bnd])
    new_pts = np.concatenate([p, mid], axis=0)

    m = n_old + ce  # [nc, 3] midpoint vertex of local edge k
    v0, v1, v2 = c[:, 0], c[:, 1], c[:, 2]
    m0, m1, m2 = m[:, 0], m[:, 1], m[:, 2]
    new_cells = np.concatenate(
        [
            np.stack([v0, m2, m1], axis=1),
            np.stack([v1, m0, m2], axis=1),
            np.stack([v2, m1, m0], axis=1),
            np.stack([m0, m1, m2], axis=1),
        ],
        axis=0,
    )
    out = Mesh(new_pts, new_cells, dtype=mesh.dtype, device=mesh.device)
    out._coarse = mesh
    return out


def reorder_rcm(points, cells, only_if_better=True, return_perm=False):
    """Vertices renumbered by reverse Cuthill-McKee on the edge graph (kept
    only if it lowers the mean edge bandwidth, with only_if_better), cells
    sorted by their minimum new vertex id."""
    points = np.asarray(points)
    cells = np.asarray(cells, dtype=np.int32)
    edges, _, _ = native.build_edges(cells)

    def mean_bw(e):
        return float(np.mean(np.abs(e[:, 0].astype(np.int64) - e[:, 1])))

    perm = np.asarray(native.rcm_order(len(points), edges))  # new -> old
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=perm.dtype)
    if only_if_better and mean_bw(inv[edges]) >= mean_bw(edges):
        points2, cells2 = points, cells
        inv = np.arange(len(points), dtype=perm.dtype)
    else:
        points2, cells2 = points[perm], inv[cells].astype(np.int32)
    order = np.argsort(cells2.min(axis=1), kind="stable")
    if return_perm:
        return points2, cells2[order], inv, order
    return points2, cells2[order]


def rectangle_with_hole_mesh(
    x0, x1, y0, y1, cx, cy, r, lcar, dtype=None, device=None,
    smooth_iters=30, rcm=True,
):
    """Triangle mesh of a rectangle with a circular hole: a structured
    background grid, cells inside the circle removed, near-circle vertices
    snapped onto it, Delaunay triangulation and Laplacian smoothing."""
    import scipy.spatial

    nx = max(4, int(round((x1 - x0) / lcar)))
    ny = max(4, int(round((y1 - y0) / lcar)))
    hx = (x1 - x0) / nx
    hy = (y1 - y0) / ny
    h = min(hx, hy)

    xs = np.linspace(x0, x1, nx + 1)
    ys = np.linspace(y0, y1, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel()], axis=1)

    d = np.linalg.norm(pts - [cx, cy], axis=1) - r
    snap = np.abs(d) < 0.5 * h
    theta = np.arctan2(pts[:, 1] - cy, pts[:, 0] - cx)
    pts[snap] = np.stack(
        [cx + r * np.cos(theta[snap]), cy + r * np.sin(theta[snap])], 1
    )
    d = np.linalg.norm(pts - [cx, cy], axis=1) - r

    keep = d > -1e-12
    on_rect = (
        (np.abs(pts[:, 0] - x0) < 1e-12)
        | (np.abs(pts[:, 0] - x1) < 1e-12)
        | (np.abs(pts[:, 1] - y0) < 1e-12)
        | (np.abs(pts[:, 1] - y1) < 1e-12)
    )
    keep |= on_rect

    kept = np.where(keep)[0]
    pk = pts[kept]
    tri = scipy.spatial.Delaunay(pk)
    cells = tri.simplices.astype(np.int32)
    cent = pk[cells].mean(axis=1)
    inside = np.linalg.norm(cent - [cx, cy], axis=1) < r * (1.0 - 1e-9)
    d0 = pk[cells[:, 1]] - pk[cells[:, 0]]
    d1 = pk[cells[:, 2]] - pk[cells[:, 0]]
    area = 0.5 * np.abs(d0[:, 0] * d1[:, 1] - d0[:, 1] * d1[:, 0])
    degenerate = area < 1e-6 * h * h
    cells = cells[~inside & ~degenerate]

    used = np.unique(cells)
    remap = -np.ones(len(pk), dtype=np.int64)
    remap[used] = np.arange(len(used))
    pk = pk[used]
    cells = remap[cells].astype(np.int32)

    on_circle = np.abs(np.linalg.norm(pk - [cx, cy], axis=1) - r) < 1e-9
    on_rect = (
        (np.abs(pk[:, 0] - x0) < 1e-12)
        | (np.abs(pk[:, 0] - x1) < 1e-12)
        | (np.abs(pk[:, 1] - y0) < 1e-12)
        | (np.abs(pk[:, 1] - y1) < 1e-12)
    )
    fixed = on_circle | on_rect

    e_all = np.concatenate([cells[:, [1, 2]], cells[:, [2, 0]], cells[:, [0, 1]]], 0)
    e_all = np.unique(np.sort(e_all, axis=1), axis=0)
    for _ in range(smooth_iters):
        acc = np.zeros_like(pk)
        cnt = np.zeros(len(pk))
        np.add.at(acc, e_all[:, 0], pk[e_all[:, 1]])
        np.add.at(acc, e_all[:, 1], pk[e_all[:, 0]])
        np.add.at(cnt, e_all[:, 0], 1)
        np.add.at(cnt, e_all[:, 1], 1)
        new = acc / np.maximum(cnt, 1)[:, None]
        pk = np.where(fixed[:, None], pk, new)
    if rcm:
        pk, cells = reorder_rcm(pk, cells)
    return Mesh(pk, cells, dtype=dtype, device=device)
