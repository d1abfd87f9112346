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
# The maps, PatchLayout and PatchGeom are host numpy, built once per
# hierarchy (fem/patchpack.py casts and moves PatchGeom's tables once;
# PatchGeom.on gives a device view). PatchSpace and PatchBoundaryTab serve
# FastStepper's patch mode (navier_stokes/patchctx.py) and
# solvers/patch_mg.py: the state is a flat replicated vector [n_flat(,m)]
# (each seam dof held once per patch), gathers are window slices, dof sums
# overlap-adds plus a seam sum over a member table (a fixed order, so they
# repeat on the card), and Krylov runs with the replica-weighted inner
# product, which reproduces the un-replicated iteration.
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from .gathersum import member_table

__all__ = ["PatchInfo", "build_patch_info", "PatchGeom", "PatchLayout",
           "PatchSpace", "PatchBoundaryTab"]


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
        self._layouts = {}

    def layout(self, degree, level=None):
        """The PatchLayout of P`degree` on hierarchy level `level` (default
        the finest; P2 only there)."""
        level = self.k if level is None else level
        key = (degree, level)
        lay = self._layouts.get(key)
        if lay is None:
            if degree == 1:
                lay = PatchLayout._p1(self, level)
            else:
                assert degree == 2 and level == self.k
                lay = PatchLayout._p2(self)
            self._layouts[key] = lay
        return lay

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

    def on(self, dtype, device):
        """detJ, G and C as tensors in `dtype` on `device` (the surface of
        assembly.geometry_on that the forms read)."""
        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

        return SimpleNamespace(dim=2, detJ=dev(self.detJ), G=dev(self.G), C=dev(self.C))


# ---------------------------------------------------------------------------
# layout: planes, windows, seam groups (host numpy)
# ---------------------------------------------------------------------------
class PatchLayout:
    """Index structures of one scalar patch layout.

    planes:      (a, b) plane shapes (each plane is [C, a, b])
    win:         win[cell_type][local_dof] = (plane, oa, ob) window offsets;
                 a window spans (nct, nct) (cells per patch axis)
    L:           [n_flat] global dof of each flat slot (-1 on padding)
    weight:      [n_flat] 1 / replica multiplicity (0 on padding)
    rep_slots/rep_group: the replica slots and their shared-dof group ids
    slot_of_dof: [n_dofs] a representative flat slot of each global dof
    """

    def __init__(self, C, nct, planes, win, L, n_dofs):
        self.C, self.nct, self.planes, self.win = C, nct, planes, win
        self.L, self.n_dofs = L, n_dofs
        self.n_flat = L.shape[0]
        sizes = [C * a * b for a, b in planes]
        self.offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        self.valid = valid = L >= 0
        Lv = L[valid]
        counts = np.bincount(Lv, minlength=n_dofs)
        assert counts.min() >= 1, "unmapped global dof"
        w = np.zeros(self.n_flat)
        w[valid] = 1.0 / counts[Lv]
        self.weight = w
        idx = np.where(valid)[0]
        slot = np.empty(n_dofs, dtype=np.int64)
        slot[L[idx[::-1]]] = idx[::-1]  # the first occurrence wins
        self.slot_of_dof = slot
        shared = counts > 1
        rep_mask = valid & shared[np.where(valid, L, 0)]
        rep_slots = np.where(rep_mask)[0]
        shared_ids = np.where(shared)[0]
        gid = np.full(n_dofs, -1, dtype=np.int64)
        gid[shared_ids] = np.arange(len(shared_ids))
        self.rep_slots = rep_slots.astype(np.int64)
        self.rep_group = gid[L[rep_slots]].astype(np.int64)
        self.n_groups = len(shared_ids)

    @staticmethod
    def _p1(info, level):
        v = info.vmaps[level]
        nct = 1 << level
        m = nct + 1
        win = [
            [(0, 0, 0), (0, 1, 0), (0, 0, 1)],  # up: v0, v1, v2 (CCW)
            [(0, 1, 0), (0, 1, 1), (0, 0, 1)],  # down (CCW)
        ]
        return PatchLayout(info.C, nct, [(m, m)], win,
                           v.reshape(-1).astype(np.int64),
                           info.meshes[level].n_points)

    @staticmethod
    def _p2(info):
        d = info.p2map  # [C, 2n+1, 2n+1]
        n = info.n
        # parity planes EE [n+1,n+1], EO [n+1,n], OE [n,n+1], OO [n,n]
        parts = (d[:, ::2, ::2], d[:, ::2, 1::2], d[:, 1::2, ::2], d[:, 1::2, 1::2])
        L = np.concatenate([x.reshape(-1) for x in parts]).astype(np.int64)
        planes = [(n + 1, n + 1), (n + 1, n), (n, n + 1), (n, n)]
        # local dof order [v0, v1, v2, mid(v1,v2), mid(v0,v2), mid(v0,v1)]
        # (fem/elements.py); up cell (i,j) in doubled coordinates: v0=(2i,2j)
        # v1=(2i+2,2j) v2=(2i,2j+2), m12=OO(i,j) m02=EO(i,j) m01=OE(i,j)
        up = [(0, 0, 0), (0, 1, 0), (0, 0, 1), (3, 0, 0), (1, 0, 0), (2, 0, 0)]
        # down cell (i,j): v0=(2i+2,2j) v1=(2i+2,2j+2) v2=(2i,2j+2),
        # m12=OE(i,j+1) m02=OO(i,j) m01=EO(i+1,j)
        dn = [(0, 1, 0), (0, 1, 1), (0, 0, 1), (2, 0, 1), (3, 0, 0), (1, 1, 0)]
        mesh = info.meshes[-1]
        return PatchLayout(info.C, n, planes, [up, dn], L,
                           mesh.n_points + mesh.n_edges)


# ---------------------------------------------------------------------------
# the space: window gathers, overlap-add dof sums, the seam sum
# ---------------------------------------------------------------------------
class PatchSpace:
    """A FunctionSpace work-alike over a PatchLayout, in `dtype` on
    `device`: the gather/dof_sum surface that fem/forms.py and
    fem/assembly.py read, by window slices and overlap-adds. n_dofs is the
    flat replicated length; states are [n_flat(,m)], replica-consistent."""

    def __init__(self, layout, mesh, degree, n_components=1, dtype=None,
                 device=None):
        self.layout = layout
        self.mesh = mesh  # the real mesh of the level: dim, hmax
        self.degree = degree
        self.n_components = n_components
        self.n_local = 3 if degree == 1 else 6
        self.n_dofs = layout.n_flat
        self.n_true_dofs = layout.n_dofs
        self.dim = 2
        self.dtype = dtype = mesh.dtype if dtype is None else dtype
        self.device = device = mesh.device if device is None else torch.device(device)

        def dev(a, dt=dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)

        self._rep_slots = dev(layout.rep_slots, torch.int64)
        self._rep_group = dev(layout.rep_group, torch.int64)
        self._group_table = dev(member_table(layout.rep_group, layout.n_groups),
                                torch.int64)
        self._weight = dev(layout.weight)
        self._slot_of_dof = dev(layout.slot_of_dof, torch.int64)
        self._L = dev(np.clip(layout.L, 0, None), torch.int64)
        self._validf = dev(layout.valid.astype(np.float64))

    def _unflatten(self, X):
        lay = self.layout
        return [X[lay.offsets[p]:lay.offsets[p + 1]].reshape((lay.C, a, b) + X.shape[1:])
                for p, (a, b) in enumerate(lay.planes)]

    def _flatten(self, planes):
        t = planes[0].shape[3:]
        return torch.cat([p.reshape((-1,) + t) for p in planes])

    def gather(self, X):
        """[n_flat(,m)] -> [ncp, nl(,m)] by plane window slices."""
        lay = self.layout
        nct = lay.nct
        planes = self._unflatten(X)
        blocks = []
        for wspec in lay.win:
            blk = torch.stack([planes[p][:, oa:oa + nct, ob:ob + nct]
                               for (p, oa, ob) in wspec], dim=3)
            blocks.append(blk.reshape((-1, len(wspec)) + blk.shape[4:]))
        return torch.cat(blocks)

    def dof_sum(self, loc):
        """[ncp, nl(,...)] -> [n_flat(,...)]: the overlap-add of the windows
        and the seam sum (masked cell slots carry zero contributions)."""
        lay = self.layout
        C, nct = lay.C, lay.nct
        nl, t = loc.shape[1], loc.shape[2:]
        half = C * nct * nct
        blocks = [loc[:half].reshape((C, nct, nct, nl) + t),
                  loc[half:].reshape((C, nct, nct, nl) + t)]
        planes = [loc.new_zeros((C, a, b) + t) for a, b in lay.planes]
        for wspec, blk in zip(lay.win, blocks):
            for l, (p, oa, ob) in enumerate(wspec):
                planes[p][:, oa:oa + nct, ob:ob + nct] += blk[:, :, :, l]
        return self.seam_sum(self._flatten(planes))

    def seam_sum(self, X):
        """Sum the replicas of each shared dof and give every replica the
        total (the only indexed addressing: O(C n) rows)."""
        vals = X[self._rep_slots]
        vals = torch.cat([vals, vals.new_zeros((1,) + vals.shape[1:])])
        sums = vals[self._group_table].sum(dim=1)
        out = X.clone()
        out[self._rep_slots] = sums[self._rep_group]
        return out

    def zeros(self):
        shape = (self.n_dofs,) if self.n_components == 1 else (self.n_dofs,
                                                                self.n_components)
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    def dot(self, x, y):
        """The replica-weighted inner product (the global layout's dot)."""
        w = self._weight.reshape(self._weight.shape + (1,) * (x.dim() - 1))
        return torch.sum(w * x * y)

    def to_patch(self, x):
        """A global-layout vector [n_dofs(,m)] -> the patch layout."""
        out = torch.as_tensor(x, dtype=self.dtype, device=self.device)[self._L]
        return out * self._validf.reshape((-1,) + (1,) * (out.dim() - 1))

    def from_patch(self, X):
        return X[self._slot_of_dof]


class PatchBoundaryTab:
    """A fine-mesh BoundaryTab addressed into a PatchSpace: the facet dof
    gathers read representative replica slots (the facet cell's geometry
    Gb stays the fine mesh's, in its own local order), and integrate_rhs
    sums onto single replicas through a member table (a fixed order) and
    then takes the seam sum. O(surface)."""

    def __init__(self, btab, space):
        self.phi, self.dphi, self.wl = btab.phi, btab.dphi, btab.wl
        self.normals, self.Gb, self.nq1 = btab.normals, btab.Gb, btab.nq1
        self.x_np = btab.x_np
        self.space = space
        self.cell_dofs_np = space.layout.slot_of_dof[btab.cell_dofs_np]
        self.cell_dofs = torch.as_tensor(self.cell_dofs_np, device=btab.cell_dofs.device)
        self._members = torch.as_tensor(member_table(self.cell_dofs_np, space.n_dofs),
                                        device=btab.cell_dofs.device)

    def gather(self, U):
        return U[self.cell_dofs]

    def values(self, U):
        Uloc = self.gather(U)
        if Uloc.dim() == 2:
            return torch.einsum("bql,bl->bq", self.phi, Uloc)
        return torch.einsum("bql,blm->bqm", self.phi, Uloc)

    def grads(self, U):
        Uloc = self.gather(U)
        if Uloc.dim() == 2:
            return torch.einsum("bqlk,bdk,bl->bqd", self.dphi, self.Gb, Uloc)
        return torch.einsum("bqlk,bdk,blm->bqmd", self.dphi, self.Gb, Uloc)

    def integrate_rhs(self, val):
        if val.dim() == 2:
            loc = torch.einsum("bq,bq,bqi->bi", val, self.wl, self.phi)
        else:
            loc = torch.einsum("bqm,bq,bqi->bim", val, self.wl, self.phi)
        flat = loc.reshape((-1,) + loc.shape[2:])
        flat = torch.cat([flat, flat.new_zeros((1,) + flat.shape[1:])])
        return self.space.seam_sum(flat[self._members].sum(dim=1))

    def integrate_scalar(self, val):
        return torch.einsum("bq,bq->", val, self.wl)
