# Patch lattices over uniformly refined triangle meshes. Port of
# flow_tpu/fem/patch.py: the host maps (PatchInfo, build_patch_info) and the
# patch-ordered geometry (PatchGeom) that fem/patchpack.py builds on.
#
# After k red refinements (mesh.refine_uniform) each coarse cell owns a
# fixed barycentric lattice of 4^k children: lattice point (i, j), i+j <= n
# (n = 2^k), sits at barycentric (1-(i+j)/n, i/n, j/n); up-children at (i,j)
# have corners {(i,j),(i+1,j),(i,j+1)}, down-children
# {(i+1,j),(i+1,j+1),(i,j+1)}. The cell->dof map inside a patch is then
# index arithmetic: a gather is a few shifted dense windows and a dof sum
# their overlap-add, with indexed addressing left only on the patch seams.
#
# Everything here is host numpy, built once per hierarchy; PatchGeom's
# tables are float64 numpy too (fem/patchpack.py casts and moves them once).
# The PatchLayout/PatchSpace/PatchBoundaryTab of the JAX module serve
# FastStepper's patch mode and are not ported.
from __future__ import annotations

import numpy as np

__all__ = ["PatchInfo", "build_patch_info", "PatchGeom"]


def _edge_lookup(mesh):
    """Sorted keys v0 * n_points + v1 of the mesh's edges (rows of edges_np
    are sorted) and the edge id of each sorted key."""
    e = mesh.edges_np.astype(np.int64)
    keys = e[:, 0] * np.int64(mesh.n_points) + e[:, 1]
    order = np.argsort(keys).astype(np.int64)
    return keys[order], order


def _refine_vmap(v, mesh):
    """Lattice vertex-id map of the next refinement level.

    v: [C, nn+1, nn+1] global vertex ids on mesh's lattice, -1 at invalid
    (i+j > nn) slots. Returns [C, 2nn+1, 2nn+1] ids valid on
    refine_uniform(mesh), which numbers the midpoint of edge e n_points + e
    (mesh.refine_uniform)."""
    nn = v.shape[1] - 1
    npts = np.int64(mesh.n_points)
    keys_sorted, order = _edge_lookup(mesh)

    def mid_ids(a, b):
        valid = (a >= 0) & (b >= 0)
        lo = np.minimum(a, b)
        hi = np.maximum(a, b)
        q = np.where(valid, lo * npts + hi, keys_sorted[0])
        pos = np.searchsorted(keys_sorted, q.ravel()).reshape(q.shape)
        pos = np.clip(pos, 0, len(keys_sorted) - 1)
        found = keys_sorted[pos] == q
        assert bool(np.all(found[valid])), "lattice edge missing from mesh"
        eid = order[pos]
        return np.where(valid, npts + eid, np.int64(-1))

    m2 = 2 * nn + 1
    out = np.full((v.shape[0], m2, m2), -1, dtype=np.int64)
    out[:, ::2, ::2] = v
    # horizontal edges (i,j)-(i+1,j) -> fine (2i+1, 2j)
    out[:, 1::2, ::2] = mid_ids(v[:, :-1, :], v[:, 1:, :])
    # vertical edges (i,j)-(i,j+1) -> fine (2i, 2j+1)
    out[:, ::2, 1::2] = mid_ids(v[:, :, :-1], v[:, :, 1:])
    # diagonal edges (i+1,j)-(i,j+1) -> fine (2i+1, 2j+1)
    out[:, 1::2, 1::2] = mid_ids(v[:, 1:, :-1], v[:, :-1, 1:])
    return out


def _match_rows(A, B):
    """For each row of B (int64 [m, 3]), its index in A ([n, 3]; unique
    rows), or -1. A big-endian byte view makes the void compare
    lexicographic."""

    def keyed(X):
        Xc = np.ascontiguousarray(X.astype(">i8"))
        return Xc.view([("", Xc.dtype)] * X.shape[1]).ravel()

    ka, kb = keyed(A), keyed(B)
    order = np.argsort(ka)
    pos = np.searchsorted(ka[order], kb)
    pos = np.clip(pos, 0, len(ka) - 1)
    idx = order[pos]
    idx[ka[idx] != kb] = -1
    return idx


class PatchInfo:
    """Host-side lattice maps of one refinement hierarchy (coarse -> fine,
    each mesh refine_uniform of the one before).

    vmaps[l]: [C, 2^l+1, 2^l+1] global vertex ids of mesh l's patch lattice
    p2map:    [C, 2n+1, 2n+1] P2 dof ids on the finest mesh (vertex dofs at
              even-even coordinates, edge dofs n_points + e elsewhere: the
              doubled lattice is one more _refine_vmap step, since the P2
              dof numbering is refine_uniform's midpoint numbering)
    """

    def __init__(self, mesh_hierarchy):
        meshes = list(mesh_hierarchy)
        assert len(meshes) >= 2, "patch layout needs >= 1 refinement"
        coarse = meshes[0]
        C = coarse.n_cells
        c0 = coarse.cells_np.astype(np.int64)
        v = np.full((C, 2, 2), -1, dtype=np.int64)
        v[:, 0, 0] = c0[:, 0]
        v[:, 1, 0] = c0[:, 1]
        v[:, 0, 1] = c0[:, 2]
        vmaps = [v]
        for mesh in meshes[:-1]:
            v = _refine_vmap(v, mesh)
            vmaps.append(v)
        self.meshes = meshes
        self.vmaps = vmaps
        self.C = C
        self.k = len(meshes) - 1
        self.n = 1 << self.k  # fine cells per patch axis
        self.p2map = _refine_vmap(vmaps[-1], meshes[-1])
        self._fine_cell_slot = None

    def fine_cell_slot(self):
        """[nc_fine] flat patch-cell slot of each fine-mesh cell (up cells
        [C, n, n] row-major, then down cells)."""
        if self._fine_cell_slot is None:
            v = self.vmaps[-1]
            up = np.stack(
                [v[:, :-1, :-1], v[:, 1:, :-1], v[:, :-1, 1:]], axis=-1
            ).reshape(-1, 3)
            dn = np.stack(
                [v[:, 1:, :-1], v[:, 1:, 1:], v[:, :-1, 1:]], axis=-1
            ).reshape(-1, 3)
            allc = np.sort(np.concatenate([up, dn], axis=0), axis=1)
            cells = np.sort(self.meshes[-1].cells_np.astype(np.int64), axis=1)
            idx = _match_rows(allc, cells)
            assert int((idx < 0).sum()) == 0, "fine cell not found in patches"
            self._fine_cell_slot = idx.astype(np.int32)
        return self._fine_cell_slot


def build_patch_info(mesh_hierarchy) -> PatchInfo:
    return PatchInfo(mesh_hierarchy)


class PatchGeom:
    """Per-cell affine geometry of hierarchy level `level` (default finest)
    in flat patch cell order [ncp = 2*C*n*n] (up cells, then down cells),
    with zero geometry (detJ = G = C = 0) on out-of-triangle slots, so
    masked cells contribute nothing through any volume form. Host float64
    numpy: detJ [ncp], G [ncp, 2, 2] (= J^{-T}), C [ncp, 2, 2]
    (= detJ G^T G), cell_x0 [ncp, 2], dvecs [ncp, 2, 2]; cellvalid_np
    [ncp] marks the in-triangle slots."""

    def __init__(self, info: PatchInfo, level=None):
        level = info.k if level is None else level
        mesh = info.meshes[level]
        v = info.vmaps[level]
        nct = 1 << level
        # corner coordinates per lattice node (invalid -> 0; masked below)
        coords = mesh.points_np[np.clip(v, 0, None)]  # [C, m, m, 2]
        coords[v < 0] = 0.0

        def w(oa, ob):
            return coords[:, oa: oa + nct, ob: ob + nct].reshape(-1, 2)

        # up corners (i,j),(i+1,j),(i,j+1); down (i+1,j),(i+1,j+1),(i,j+1)
        X0 = np.concatenate([w(0, 0), w(1, 0)], axis=0)
        X1 = np.concatenate([w(1, 0), w(1, 1)], axis=0)
        X2 = np.concatenate([w(0, 1), w(0, 1)], axis=0)
        ii, jj = np.meshgrid(np.arange(nct), np.arange(nct), indexing="ij")
        valid_up = (ii + jj) <= nct - 1
        valid_dn = (ii + jj) <= nct - 2
        cellvalid = np.concatenate([
            np.broadcast_to(valid_up, (info.C,) + valid_up.shape).reshape(-1),
            np.broadcast_to(valid_dn, (info.C,) + valid_dn.shape).reshape(-1),
        ])
        d0 = X1 - X0
        d1 = X2 - X0
        detJ = d0[:, 0] * d1[:, 1] - d0[:, 1] * d1[:, 0]
        assert bool(np.all(detJ[cellvalid] > 0.0)), (
            "patch lattice cell with non-positive area (inverted geometry?)"
        )
        detJ_s = np.where(cellvalid, detJ, 1.0)
        inv = np.stack(
            [
                np.stack([d1[:, 1], -d0[:, 1]], axis=-1),
                np.stack([-d1[:, 0], d0[:, 0]], axis=-1),
            ],
            axis=-2,
        ) / detJ_s[:, None, None]
        detJ = np.where(cellvalid, detJ, 0.0)
        inv[~cellvalid] = 0.0
        dvecs = np.stack([d0, d1], axis=-1)
        dvecs[~cellvalid] = 0.0

        self.dim = 2
        self.cellvalid_np = cellvalid
        self.detJ = detJ
        self.G = inv
        self.C = np.einsum("edk,edl->ekl", inv, inv) * detJ[:, None, None]
        self.cell_x0 = np.where(cellvalid[:, None], X0, 0.0)
        self.dvecs = dvecs

    def physical_points(self, ref_pts):
        """Reference points [nq, 2] -> physical [ncp, nq, 2]."""
        r = np.asarray(ref_pts, dtype=np.float64)
        return self.cell_x0[:, None, :] + np.einsum("qk,edk->eqd", r, self.dvecs)
