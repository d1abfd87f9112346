# Tetrahedral meshes. Port of flow_tpu/mesh3d.py: the mesh is built on the
# host in numpy (flat static arrays: cells, edges, cell_edges, boundary
# faces/edges, n_points/n_cells/n_edges, hmax/hmin) plus the structured-grid
# metadata of box_mesh. Every consumer is host setup code, so the JAX
# package's device mirrors of these arrays are not kept; `dtype` and
# `device` are the defaults of the spaces and steppers built on the mesh.
from __future__ import annotations

import numpy as np
import torch

__all__ = ["TetMesh", "box_mesh"]

# Kuhn decomposition of the unit cube into 6 tets sharing the main diagonal
# (0,0,0)-(1,1,1): consistent across neighboring cubes (no orientation
# conflicts on shared faces).
_KUHN = [
    (0, 1, 3, 7),
    (0, 1, 5, 7),
    (0, 2, 3, 7),
    (0, 2, 6, 7),
    (0, 4, 5, 7),
    (0, 4, 6, 7),
]

_TET_EDGES = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
_TET_FACES = [(1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2)]


def _device(device):
    """torch.device with the index filled in ("cuda" -> "cuda:<current>"),
    so that devices compare equal to the .device of their tensors."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class TetMesh:
    dim = 3

    def __init__(self, points, cells, dtype=None, device=None):
        points = np.asarray(points, dtype=np.float64)[:, :3]
        cells = np.asarray(cells, dtype=np.int64)
        npts = len(points)

        # orient cells positively (detJ > 0)
        p = points
        d = p[cells[:, 1:]] - p[cells[:, 0]][:, None, :]  # [nt, 3, 3]
        det = np.linalg.det(d)
        flip = det < 0
        cells = cells.copy()
        cells[flip] = cells[flip][:, [0, 2, 1, 3]]

        nc = len(cells)
        # edges (for P2 dofs): canonical pair order per cell. A sorted pair
        # (a, b) is keyed a*npts + b, so a 1-D unique gives the same
        # lexicographic edge order as a row-wise unique.
        e_all = np.concatenate(
            [cells[:, [a, b]] for a, b in _TET_EDGES], axis=0
        )  # [6*nc, 2], k-major
        e_sorted = np.sort(e_all, axis=1)
        ekeys, inverse = np.unique(
            e_sorted[:, 0] * npts + e_sorted[:, 1], return_inverse=True
        )
        edges = np.stack([ekeys // npts, ekeys % npts], axis=1)
        cell_edges = inverse.reshape(6, nc).T

        # boundary faces: triples appearing once
        f_all = np.concatenate(
            [cells[:, list(f)] for f in _TET_FACES], axis=0
        )  # [4*nc, 3]
        f_sorted = np.sort(f_all, axis=1)
        faces, finv, fcounts = np.unique(
            f_sorted, axis=0, return_inverse=True, return_counts=True
        )
        finv = finv.reshape(-1)
        bnd_face_ids = np.where(fcounts == 1)[0]
        order = np.argsort(finv, kind="stable")
        first = order[np.searchsorted(finv[order], bnd_face_ids)]
        self.boundary_cells_np = first % nc
        self.boundary_local_np = first // nc
        self.boundary_faces_np = faces[bnd_face_ids]

        # an edge is on the boundary iff it lies in a boundary face
        face_edge = np.concatenate(
            [
                np.sort(self.boundary_faces_np[:, [i, j]], axis=1)
                for i, j in [(0, 1), (0, 2), (1, 2)]
            ],
            axis=0,
        )
        fe_ids = np.searchsorted(ekeys, face_edge[:, 0] * npts + face_edge[:, 1])
        bnd_edge = np.zeros(len(edges), dtype=bool)
        bnd_edge[fe_ids] = True
        self.boundary_edges_np = np.where(bnd_edge)[0]

        elen = np.linalg.norm(
            p[e_all[:, 1]] - p[e_all[:, 0]], axis=1
        ).reshape(6, nc)
        h_cell = elen.max(axis=0)
        self.hmax = float(h_cell.max())
        self.hmin = float(h_cell.min())

        self.dtype = torch.get_default_dtype() if dtype is None else dtype
        self.device = _device("cpu" if device is None else device)
        self.points_np = points
        self.cells_np = cells
        self.edges_np = edges
        self.cell_edges_np = cell_edges

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
            f"TetMesh(n_points={self.n_points}, n_cells={self.n_cells}, "
            f"hmax={self.hmax:.3e})"
        )


def box_mesh(p0, p1, nx, ny, nz, dtype=None, device=None):
    """Structured Kuhn tetrahedralization of the box [p0, p1]."""
    x0, y0, z0 = p0
    x1, y1, z1 = p1
    xs = np.linspace(x0, x1, nx + 1)
    ys = np.linspace(y0, y1, ny + 1)
    zs = np.linspace(z0, z1, nz + 1)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    def vid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    I, J, K = np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
    )
    I, J, K = I.ravel(), J.ravel(), K.ravel()
    # cube corner ids: bit 0 -> x, bit 1 -> y, bit 2 -> z
    corners = np.stack(
        [vid(I + (c & 1), J + ((c >> 1) & 1), K + ((c >> 2) & 1)) for c in range(8)],
        axis=1,
    )  # [ncube, 8]
    cells = np.concatenate([corners[:, list(t)] for t in _KUHN], axis=0)
    mesh = TetMesh(pts, cells, dtype=dtype, device=device)
    # structured-grid metadata: lexicographic (i, j, k) vertex layout, which
    # the stencil operator (ops/structured.py) and box layout need
    mesh.grid_shape = (nx + 1, ny + 1, nz + 1)
    mesh.grid_spacing = (
        (x1 - x0) / nx,
        (y1 - y0) / ny,
        (z1 - z0) / nz,
    )
    return mesh
