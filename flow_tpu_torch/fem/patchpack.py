# The packed patch layout and its operators: the Karman benchmark path's
# volume kernels. Port of flow_tpu/fem/patchpack.py.
#
# LAYOUT. On a coarse mesh refined k times (fem/patch.py), a scalar field
# lives as per-patch lattice planes stored [a, b, C] (lattice axes leading,
# the coarse cell C minor), flattened plane after plane into one vector:
#   P1 on level l: one plane [m, m, C], m = 2^l + 1 (lattice (i, j),
#     i+j <= 2^l; the slots with i+j > 2^l are padding);
#   P2 on the finest level: the doubled lattice split by parity into EE
#     [n+1, n+1, C], EO [n+1, n, C], OE [n, n+1, C], OO [n, n, C], so that
#     every cell window is a stride-1 slice.
# A vector field is component-major [2 * n_flat]. Seam lattice points are
# replicated (each patch owns a copy); the seam sum after an overlap-add
# restores consistency, and inner products weight replicas by
# 1/multiplicity (`weight`), so Krylov iterations are those of the
# unreplicated system. Cells are [up; down] blocks [n, n, C] with zero
# geometry on out-of-triangle slots, so masked cells contribute nothing.
#
# PYTORCH IDIOM. The JAX module unrolls every small axis (local dofs,
# quadrature points, components, cell types) in Python and leaves the
# fusing to XLA; eager PyTorch would launch a kernel per term. Here the
# small axes are tensor dimensions: the windows of a field are one stacked
# tensor [..., 2 types, nl, X] (X = n*n*C, flat), the lagged element tensor
# S is [2, 6, 6, X], constant coefficients are built once at construction
# ([2, 3, 3, X] for the P1 stiffness, [2, 6, 6, X] for the grad:grad
# scalar), and the local-dof couplings are matmuls against small constant
# matrices or a few broadcast multiply-adds. The overlap-add stays one
# in-place slice-add per (type, local dof), on a buffer this module
# allocates.
#
# SEAMS. The seam sum is two gathers from the flat vector: side points
# (shared by exactly two patches) get own + partner, and the 3C patch
# corners get the sum over their coarse vertex's replicas, through a padded
# [corners, members] table built at setup. Every replica of a point then
# holds the same bits, and no scatter has a repeated index, so the result
# does not depend on the order of atomic adds (PackedBoundary's boundary
# scatter is made deterministic the same way).
from __future__ import annotations

import numpy as np
import torch

from . import assembly, dense, elements, quadrature
from .assembly import CONV_RULE, geometry
from .forms import ref_p1_integrals
from .gathersum import member_table
from .patch import PatchGeom, PatchInfo
from .spaces import FunctionSpace
from ..message import spanned
from ..mesh3d import _device

__all__ = [
    "PackedLayout",
    "make_p1_layout",
    "make_p2_layout",
    "PackedPatch",
    "PackedBoundary",
    "P1LevelKernels",
    "PackedPatchP1Hierarchy",
]

# window specs (plane, oa, ob) per cell type and local dof; local P2 order
# [v0, v1, v2, mid(v1,v2), mid(v0,v2), mid(v0,v1)] (fem/elements.py).
# Up cell (i,j), doubled coordinates: v0=(2i,2j) v1=(2i+2,2j) v2=(2i,2j+2),
# m12=(2i+1,2j+1)=OO(i,j), m02=(2i,2j+1)=EO(i,j), m01=(2i+1,2j)=OE(i,j).
# Down cell (i,j): v0=(2i+2,2j) v1=(2i+2,2j+2) v2=(2i,2j+2),
# m12=(2i+1,2j+2)=OE(i,j+1), m02=(2i+1,2j+1)=OO(i,j), m01=(2i+2,2j+1)=EO(i+1,j)
_P2_WIN = [
    [(0, 0, 0), (0, 1, 0), (0, 0, 1), (3, 0, 0), (1, 0, 0), (2, 0, 0)],
    [(0, 1, 0), (0, 1, 1), (0, 0, 1), (2, 0, 1), (3, 0, 0), (1, 1, 0)],
]
_P1_WIN = [
    [(0, 0, 0), (0, 1, 0), (0, 0, 1)],
    [(0, 1, 0), (0, 1, 1), (0, 0, 1)],
]
# constant P1 reference gradients d0=(-1,-1), d1=(1,0), d2=(0,1)
_P1_DREF = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])


def _parity_blocks(vmap):
    """[C, 2n+1, 2n+1] doubled-lattice map -> (EE, EO, OE, OO), each
    [C, a, b]."""
    return (
        vmap[:, ::2, ::2],
        vmap[:, ::2, 1::2],
        vmap[:, 1::2, ::2],
        vmap[:, 1::2, 1::2],
    )


class PackedLayout:
    """Index structures of one packed scalar layout.

    planes: list of (a, b); plane p is stored [a, b, C] and flattened in
    C-minor order. win[type][l] = (plane, oa, ob): the window of local dof l
    of the cells of a type is plane[oa:oa+nct, ob:ob+nct]. Host numpy: L
    (global dof per flat slot, -1 on padding), valid, weight
    (1/multiplicity, 0 on padding), slot_of_dof (a representative slot per
    dof), the seam topology (_nbr, _flip: the side neighbour of each
    (side, cell) row and whether it runs the other way; _corner_slots,
    _corner_group: the patch corners grouped by coarse vertex). Device
    tensors (in `dtype` on `device`): weight_t, valid_t, slot_of_dof_t and
    the seam tables.
    """

    def __init__(self, C, nct, planes, win, Lblocks, n_dofs, coarse_cells,
                 dtype, device):
        self.C = C
        self.nct = nct
        self.planes = planes
        self.win = win
        self.n_dofs = n_dofs
        self.dtype = dtype
        self.device = device
        sizes = [a * b * C for a, b in planes]
        self.offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        self.n_flat = int(self.offsets[-1])

        # flat global-dof map in packed order ([a, b, C] ravel per plane)
        L = np.concatenate(
            [blk.transpose(1, 2, 0).ravel() for blk in Lblocks]
        ).astype(np.int64)
        self.L = L
        valid = L >= 0
        self.valid = valid
        Lv = L[valid]
        counts = np.bincount(Lv, minlength=n_dofs)
        assert counts.min() >= 1
        w = np.zeros(self.n_flat)
        w[valid] = 1.0 / counts[Lv]
        self.weight = w
        idx = np.where(valid)[0]
        slot = np.empty(n_dofs, dtype=np.int64)
        slot[L[idx[::-1]]] = idx[::-1]  # the first occurrence wins
        self.slot_of_dof = slot.astype(np.int32)

        self._build_seam(coarse_cells, Lblocks)

        def dev(a, dt=dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)

        self.weight_t = dev(w)
        self.valid_t = dev(valid.astype(np.float64))
        self.slot_of_dof_t = dev(self.slot_of_dof, torch.int64)
        self._L_t = dev(np.clip(L, 0, None), torch.int64)
        self._seam_gather = dev(self._seam_gather_np, torch.int64)
        self._seam_put = dev(self._seam_put_np, torch.int64)
        self._corner_table_t = dev(self._corner_table, torch.int64)

    # -- seam topology -------------------------------------------------------
    def _slot(self, p, i, j, c):
        return self.offsets[p] + (i * self.planes[p][1] + j) * self.C + c

    def _side_slot(self, odd, s, t, c):
        """Flat slot of entry t of side s of patch c: the even (EE) part
        t = 0..n, or the odd part t = 0..n-1 (P2).
          side 0: the J=0 row (t = i); side 1: the I=0 column (t = j);
          side 2: the hypotenuse (i, n-i) (t = j)."""
        n = self.nct
        if not odd:
            i = np.choose(s, [t, 0 * t, n - t])
            j = np.choose(s, [0 * t, t, t])
            return self._slot(0, i, j, c)
        # (2t+1, 0) = OE(t, 0); (0, 2t+1) = EO(0, t); OO(n-1-t, t)
        p = np.choose(s, [2, 1, 3])
        i = np.choose(s, [t, 0 * t, n - 1 - t])
        j = np.choose(s, [0 * t, t, t])
        return self.offsets[p] + (i * np.asarray(self.planes)[p, 1] + j) * self.C + c

    def _build_seam(self, cells, Lblocks):
        """Side neighbours (flip when the two traversals run opposite;
        boundary sides have none: index 3C) and corner groups, then the
        device tables of seam_sum: the side points that have a partner on
        the neighbouring patch (ends of the even sides excluded: they are
        corners) with their partners, and the corners with a padded
        [3C, members] table of their group."""
        C = self.C
        a0, a1, a2 = cells[:, 0], cells[:, 1], cells[:, 2]
        side_pairs = np.stack(
            [np.stack([a0, a1], 1), np.stack([a0, a2], 1), np.stack([a1, a2], 1)],
            axis=0,
        )  # [3, C, 2] ordered endpoint pairs
        key = np.sort(side_pairs, axis=2)
        nvert = int(cells.max()) + 1
        kflat = (key[:, :, 0].astype(np.int64) * nvert + key[:, :, 1]).reshape(-1)
        order = np.argsort(kflat, kind="stable")
        ks = kflat[order]
        nbr = np.full(3 * C, 3 * C, dtype=np.int32)
        flip = np.zeros(3 * C, dtype=bool)
        sp_flat = side_pairs.reshape(-1, 2)
        i = 0
        while i < len(ks):
            j = i + 1
            while j < len(ks) and ks[j] == ks[i]:
                j += 1
            if j - i == 2:
                x, y = order[i], order[j - 1]
                nbr[x], nbr[y] = y, x
                fl = bool(np.all(sp_flat[x] == sp_flat[y][::-1]))
                flip[x] = flip[y] = fl
            else:
                assert j - i == 1, "coarse edge shared by >2 cells"
            i = j
        # rows are (side, cell): row = s * C + c
        self._nbr = nbr
        self._flip = flip

        n = self.nct
        EE = Lblocks[0]  # [C, n+1, n+1] global ids
        cc = np.arange(C)
        corner_slots = np.concatenate(
            [self._slot(0, 0, 0, cc), self._slot(0, n, 0, cc), self._slot(0, 0, n, cc)]
        )
        corner_dofs = np.concatenate([EE[:, 0, 0], EE[:, n, 0], EE[:, 0, n]])
        uniq, grp = np.unique(corner_dofs, return_inverse=True)
        self._corner_slots = corner_slots.astype(np.int32)
        self._corner_group = grp.astype(np.int32)
        self._n_corner_groups = len(uniq)
        members = [np.where(grp == g)[0] for g in range(len(uniq))]
        kmax = max(len(m) for m in members)
        table = np.full((3 * C, kmax), 3 * C, dtype=np.int64)
        for m in members:
            table[m, : len(m)] = m
        self._corner_table = table

        rows = np.where(nbr < 3 * C)[0]
        s, c = rows // C, rows % C
        s2, c2 = nbr[rows] // C, nbr[rows] % C
        own, partner = [], []
        parts = [(False, np.arange(1, n), n)]  # even sides: interior points
        if len(self.planes) > 1:
            parts.append((True, np.arange(n), n - 1))
        for odd, t, last in parts:
            t = np.broadcast_to(t[None, :], (len(rows), len(t)))
            t2 = np.where(flip[rows][:, None], last - t, t)
            own.append(self._side_slot(odd, s[:, None], t, c[:, None]).ravel())
            partner.append(self._side_slot(odd, s2[:, None], t2, c2[:, None]).ravel())
        own = np.concatenate(own).astype(np.int64)
        partner = np.concatenate(partner).astype(np.int64)
        self._n_side = len(own)
        self._seam_gather_np = np.concatenate([own, partner, corner_slots])
        self._seam_put_np = np.concatenate([own, corner_slots])
        assert len(np.unique(self._seam_put_np)) == len(self._seam_put_np)

    # -- plane plumbing --------------------------------------------------------
    def unflatten(self, X):
        """Flat [..., n_flat] -> the planes as views [..., a, b, C]."""
        lead = tuple(X.shape[:-1])
        return [
            X[..., self.offsets[p]: self.offsets[p + 1]].view(lead + (a, b, self.C))
            for p, (a, b) in enumerate(self.planes)
        ]

    def windows(self, X):
        """Flat [..., n_flat] -> every window [..., 2 types, nl, X], X =
        nct*nct*C (one stacked copy)."""
        planes = self.unflatten(X)
        n = self.nct
        ws = [planes[p][..., oa: oa + n, ob: ob + n, :]
              for spec in self.win for p, oa, ob in spec]
        lead = tuple(X.shape[:-1])
        return torch.stack(ws, dim=len(lead)).view(
            lead + (2, len(self.win[0]), n * n * self.C))

    def overlap_add(self, Y, locals_=None):
        """Cell values Y [..., 2 types, nl, X] -> the seam-consistent flat
        [..., n_flat] sum over every cell's local dofs (one in-place
        slice-add per type and local dof; locals_ restricts to those local
        dofs, where the others are known to be zero)."""
        lead = tuple(Y.shape[:-3])
        out = torch.zeros(lead + (self.n_flat,), dtype=Y.dtype, device=Y.device)
        planes = self.unflatten(out)
        n = self.nct
        shape = lead + (n, n, self.C)
        for t, spec in enumerate(self.win):
            for l, (p, oa, ob) in enumerate(spec):
                if locals_ is None or l in locals_:
                    planes[p][..., oa: oa + n, ob: ob + n, :] += Y[..., t, l, :].view(shape)
        return self.seam_sum(out)

    # -- seam sum ----------------------------------------------------------------
    def seam_sum(self, X):
        """Restore replica consistency of X [..., n_flat] in place after an
        overlap-add: side points own + partner, corners their group's sum."""
        k = self._n_side
        vals = X.index_select(-1, self._seam_gather)
        side = vals[..., :k] + vals[..., k: 2 * k]
        corner = vals[..., 2 * k:]
        corner = torch.cat([corner, corner.new_zeros(corner.shape[:-1] + (1,))], -1)
        corner = corner[..., self._corner_table_t].sum(-1)
        X.index_copy_(X.dim() - 1, self._seam_put, torch.cat([side, corner], -1))
        return X

    # -- conversions (setup and probes) ------------------------------------------
    def to_packed(self, x):
        """Global [n_dofs(, m)] (tensor or numpy) -> packed [n_flat(, m)],
        zero on padding."""
        x = torch.as_tensor(x, dtype=self.dtype, device=self.device)
        v = self.valid_t.reshape(self.valid_t.shape + (1,) * (x.dim() - 1))
        return x[self._L_t] * v

    def from_packed(self, X):
        return X[self.slot_of_dof_t]

    def dot(self, x, y):
        w = self.weight_t.reshape(self.weight_t.shape + (1,) * (x.dim() - 1))
        return torch.sum(w * x * y)


def make_p2_layout(info: PatchInfo, dtype, device) -> PackedLayout:
    n = info.n
    planes = [(n + 1, n + 1), (n + 1, n), (n, n + 1), (n, n)]
    mesh = info.meshes[-1]
    return PackedLayout(
        info.C, n, planes, _P2_WIN, list(_parity_blocks(info.p2map)),
        mesh.n_points + mesh.n_edges, info.meshes[0].cells_np, dtype, device,
    )


def make_p1_layout(info: PatchInfo, level, dtype, device) -> PackedLayout:
    nct = 1 << level
    return PackedLayout(
        info.C, nct, [(nct + 1, nct + 1)], _P1_WIN, [info.vmaps[level]],
        info.meshes[level].n_points, info.meshes[0].cells_np, dtype, device,
    )


def _cell_blocks(arr, C, n):
    """PatchGeom flat cell order [2*C*n*n, ...] -> [2 types, ..., X] with
    X = (i*n + j)*C + c, the windows' order."""
    t = arr.shape[1:]
    x = arr.reshape((2, C, n, n) + t)
    x = np.moveaxis(x, 1, -1)  # [2, n, n, ..., C]
    x = np.moveaxis(x, (1, 2), (-3, -2))  # [2, ..., n, n, C]
    return x.reshape((2,) + t + (n * n * C,))


class P1LevelKernels:
    """The P1 stiffness of one hierarchy level on its packed layout, with
    the coefficients K_ij = 0.5 d_i^T C d_j built once ([2, 3, 3, X])."""

    def __init__(self, info: PatchInfo, level, dtype, device):
        self.lay = make_p1_layout(info, level, dtype, device)
        geom = PatchGeom(info, level=level)
        Cg = _cell_blocks(geom.C, info.C, 1 << level)  # [2, 2, 2, X]
        kc = 0.5 * np.einsum("ik,tklx,jl->tijx", _P1_DREF, Cg, _P1_DREF)
        self.kc = torch.as_tensor(kc, dtype=dtype, device=device)

    def stiffness_apply(self, p):
        pw = self.lay.windows(p)  # [2, 3, X]
        kc = self.kc
        y = kc[:, :, 0] * pw[:, None, 0]
        y.addcmul_(kc[:, :, 1], pw[:, None, 1])
        y.addcmul_(kc[:, :, 2], pw[:, None, 2])
        return self.lay.overlap_add(y)


class PackedPatch:
    """Geometry and hot operators over the packed layouts of a hierarchy's
    finest mesh (lay2: P2, lay1: P1). Cell tensors are [2 types, ..., X];
    all tables live on `device` in `dtype` (defaults: the finest mesh's)."""

    def __init__(self, info: PatchInfo, dtype=None, device=None):
        self.info = info
        mesh = info.meshes[-1]
        self.mesh = mesh
        self.dtype = dtype = mesh.dtype if dtype is None else dtype
        self.device = device = _device(mesh.device if device is None else device)
        self.lay2 = make_p2_layout(info, dtype, device)
        self.p1 = P1LevelKernels(info, info.k, dtype, device)
        self.lay1 = self.p1.lay
        self.n2 = self.lay2.n_flat
        self.n1 = self.lay1.n_flat
        self._build_tabs()
        self._build_geometry()

    def _build_tabs(self):
        # the P2 tabulation at the convection rule (the einsum path's)
        pts, w = quadrature.simplex_rule(CONV_RULE, 2)
        phi, dphi = elements.tabulate(2, pts, dim=2)
        self.qw = np.asarray(w)  # [nq]
        self.phi = np.asarray(phi)  # [nq, 6]
        self.dphi = np.asarray(dphi)  # [nq, 6, 2]
        self.nq = len(w)
        self.Mref2 = assembly.ref_mass(2, 2)  # [6, 6]
        self.Kref2 = assembly.ref_stiffness(2, 2)  # [2, 2, 6, 6]
        self.Bref21 = assembly.ref_mixed(1, 2, 2)  # [2, 3, 6]
        self.Href2 = elements.hessian_ref(2, 2)  # [6, 2, 2]
        self.dref1 = _P1_DREF  # [3, 2]
        self.refint2 = ref_p1_integrals(2, 2)  # [6]

    def _build_geometry(self):
        info = self.info
        geom = PatchGeom(info)
        C, n = info.C, info.n
        detJ = _cell_blocks(geom.detJ, C, n)  # [2, X]
        G = _cell_blocks(geom.G, C, n)  # [2, 2(d), 2(k), X]
        Cg = _cell_blocks(geom.C, C, n)  # [2, 2, 2, X]
        K, B, H = self.Kref2, self.Bref21, self.Href2

        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=self.dtype,
                                   device=self.device)

        self.detJ = dev(detJ)
        self.G = dev(G)
        self.dJG = dev(detJ[:, None, None] * G)
        self.half_dJ = dev(0.5 * detJ)
        # grad:grad scalar pairs Kscal[t, i, j] = C_kl Kref[k, l, i, j]
        self.kscal = dev(np.einsum("tklx,klij->tijx", Cg, K))
        self.Mref_t = dev(self.Mref2[None, :, :, None])
        self.Mref_mat = dev(self.Mref2)
        self.phi_t = dev(self.phi)
        self.wphiT = dev((self.qw[:, None] * self.phi).T)  # [6, nq]
        self.dphi_t = dev(self.dphi[None, :, :, :, None])  # [1, nq, 6, 2, 1]
        # the transpose stress coupling u[k, i] = Kref[k, l, j, i] w[l, j]
        self.Kt_mat = dev(K.transpose(0, 3, 1, 2).reshape(12, 12))
        # div_rhs: y[m] = Bref[k, m, j] g[k, j]
        self.Bdiv_mat = dev(B.transpose(1, 0, 2).reshape(3, 12))
        # pressure_grad_rhs: h[k, i] = Bref[k, m, i] p[m]
        self.Bgrad_mat = dev(B.transpose(0, 2, 1).reshape(12, 3))
        # grad_div_cell: u[k] = Href[j, k, l] w[l, j]
        self.H_mat = dev(H.transpose(1, 2, 0).reshape(2, 12))
        self.dref_t = dev(self.dref1)  # [3, 2]
        self.drefT = dev(self.dref1.T)  # [2, 3]
        self.refint_t = dev(self.refint2[:, None])  # [6, 1]
        self._refint_dofs = [i for i in range(6) if self.refint2[i] != 0.0]

    # -- small helpers ---------------------------------------------------------
    def comps(self, Xf):
        n = self.n2
        return Xf[:n], Xf[n:]

    def windows2(self, Xf):
        """Packed vector flat [2*n2] -> windows [2 comps, 2 types, 6, X]."""
        return self.lay2.windows(Xf.view(2, self.n2))

    def _grad_windows(self, xw):
        """w[t, l, j] = sum_b G[t, b, l] x_j^b from vector windows
        [2, 2, 6, X] -> [2, 2, 6, X]."""
        G = self.G
        w = G[:, 0, :, None] * xw[0][:, None]
        w.addcmul_(G[:, 1, :, None], xw[1][:, None])
        return w

    def _apply_G(self, M, u):
        """v[t, a, ...] = sum_k M[t, a, k] u[t, k, ...] for M [2, 2, 2, X]
        and u [2, 2, ..., X]."""
        extra = (None,) * (u.dim() - 3)
        v = M[:, :, 0][(slice(None), slice(None)) + extra] * u[:, None, 0]
        v.addcmul_(M[:, :, 1][(slice(None), slice(None)) + extra], u[:, None, 1])
        return v

    # -- P1 stiffness (pressure Poisson) ----------------------------------------
    def p1_stiffness_apply(self, p):
        return self.p1.stiffness_apply(p)

    # -- P2 vector mass (velocity correction) -----------------------------------
    def mass_apply_vec(self, Xf):
        xw = self.windows2(Xf)
        y = torch.matmul(self.Mref_mat, xw) * self.detJ[:, None]
        return self.lay2.overlap_add(y).view(-1)

    # -- mixed / coupling operators ---------------------------------------------
    def div_rhs(self, Xf):
        """b[m] = int div(u) q_m -> P1 packed flat (exact)."""
        g = self._grad_windows(self.windows2(Xf))  # [2, 2(k), 6(j), X]
        y = torch.matmul(self.Bdiv_mat, g.reshape(2, 12, -1)) * self.detJ[:, None]
        return self.lay1.overlap_add(y)

    def pressure_grad_rhs(self, Pf):
        """b[(i,a)] = int p d_a v_i -> packed P2 vector flat (exact)."""
        pw = self.lay1.windows(Pf)  # [2, 3, X]
        h = torch.matmul(self.Bgrad_mat, pw).view(2, 2, 6, -1)
        y = self._apply_G(self.dJG, h)  # [2(t), 2(a), 6, X]
        return self.lay2.overlap_add(y.transpose(0, 1)).view(-1)

    def grad_div_cell(self, Xf):
        """Per-cell constant grad(div u) for P2 u: [2 types, 2 (d), X]."""
        w = self._grad_windows(self.windows2(Xf))
        u = torch.matmul(self.H_mat, w.reshape(2, 12, -1))  # [2, 2(k), X]
        return self._apply_G(self.G, u)

    def grad_div_rhs(self, Xf):
        """b[m] = int grad(div u).grad(q_m) -> P1 packed flat (exact; the
        rotational pressure term)."""
        v = self.grad_div_cell(Xf)  # [2, 2(d), X]
        gv = self.G[:, 0] * v[:, 0, None]
        gv.addcmul_(self.G[:, 1], v[:, 1, None])  # [2, 2(k), X]
        y = torch.matmul(self.dref_t, gv) * self.half_dJ[:, None]
        return self.lay1.overlap_add(y)

    def grad_phi_rhs(self, Pf, div_part=None, mu=0.0):
        """b[(i,a)] = int (grad(phi)_a [+ mu grad(div u*)_a]) v_i -> packed
        vector flat (exact: grad(phi) is per-cell constant for P1 phi, and
        int_cell v_i = detJ * refint_i). div_part: grad_div_cell's
        [2, 2, X]."""
        pw = self.lay1.windows(Pf)
        pk = torch.matmul(self.drefT, pw)  # [2, 2(k), X]
        ga = self._apply_G(self.G, pk)  # [2(t), 2(a), X]
        if div_part is not None:
            ga = ga + mu * div_part
        ga = ga * self.detJ[:, None]
        y = self.refint_t * ga.transpose(0, 1)[:, :, None]  # [2a, 2t, 6, X]
        return self.lay2.overlap_add(y, self._refint_dofs).view(-1)

    # -- lagged momentum operator (the EMA) ---------------------------------------
    def ema_S(self, Tf, s_mu, s_rho):
        """The scalar element tensor of the lagged momentum operator
        [2 types, 6, 6, X]:
        S_ij = detJ (Mref_ij + 0.5 s_rho conv_ij) + s_mu Kscal_ij,
        conv_ij = sum_q qw_q (phi_qi A_qj - phi_qj A_qi),
        A_qm = sum_k TG_qk dphi[q, m, k], TG_qk = sum_d T_d(q) G[d, k]."""
        Tw = self.windows2(Tf)  # [2(d), 2(t), 6, X]
        Tq = torch.matmul(self.phi_t, Tw)  # [2(d), 2(t), nq, X]
        G = self.G
        TG = Tq[0][:, :, None] * G[:, None, 0]
        TG.addcmul_(Tq[1][:, :, None], G[:, None, 1])  # [2, nq, 2(k), X]
        d = self.dphi_t
        A = d[:, :, :, 0] * TG[:, :, None, 0]
        A.addcmul_(d[:, :, :, 1], TG[:, :, None, 1])  # [2, nq, 6, X]
        nx = A.shape[-1]
        B = torch.matmul(self.wphiT, A.view(2, self.nq, 6 * nx)).view(2, 6, 6, nx)
        S = (B - B.transpose(1, 2)).mul_(0.5 * s_rho).add_(self.Mref_t)
        S.mul_(self.detJ[:, None, None])
        return S.add_(s_mu * self.kscal)

    def ema_volume_apply(self, S, Xf, s_mu):
        """Volume part of the lagged tangent: the component-diagonal
        contraction with S plus the factored grad-transpose stress coupling
        s_mu detJ G[a, k] G[b, l] Kref[k, l, j, i] x_j^b."""
        xw = self.windows2(Xf)  # [2(a), 2(t), 6(j), X]
        y = S[None, :, :, 0] * xw[:, :, None, 0]
        for j in range(1, 6):
            y.addcmul_(S[None, :, :, j], xw[:, :, None, j])
        w = self._grad_windows(xw)  # [2(t), 2(l), 6(j), X]
        u = torch.matmul(self.Kt_mat, w.reshape(2, 12, -1)).view(2, 2, 6, -1)
        val = self._apply_G(self.dJG, u)  # [2(t), 2(a), 6(i), X]
        y.addcmul_(val.transpose(0, 1),
                   torch.as_tensor(s_mu, dtype=y.dtype, device=y.device))
        return self.lay2.overlap_add(y).view(-1)


class PackedBoundary:
    """A boundary-facet tabulation (fem/assembly.BoundaryTab) re-addressed
    to a packed layout: O(surface) representative-slot gathers, and a
    deterministic boundary sum (a padded [slots, members] table summed along
    its member axis) followed by the seam sum. Carries the ds-terms of the
    momentum residual."""

    def __init__(self, btab, lay: PackedLayout):
        self.lay = lay
        self.phi = btab.phi  # [nb, q, nl]
        self.wl = btab.wl  # [nb, q]
        self.normals = btab.normals  # [nb, 2]
        self.nq1 = btab.nq1
        cd = lay.slot_of_dof.astype(np.int64)[btab.cell_dofs_np]  # [nb, nl]
        self.cell_dofs_np = cd
        dev = btab.phi.device
        self.cell_dofs = torch.as_tensor(cd, device=dev)
        self.dphiG = torch.einsum("bqlk,bdk->bqld", btab.dphi, btab.Gb)
        self.wphi = btab.wl[:, :, None] * btab.phi  # [nb, q, nl]
        flat = cd.reshape(-1)
        uniq, inv = np.unique(flat, return_inverse=True)
        self._targets = torch.as_tensor(uniq, device=dev)
        self._table = torch.as_tensor(member_table(inv, len(uniq)), device=dev)

    def _local(self, X):
        """Flat [(2,) n_flat] packed field -> local values [(2,) nb, nl]."""
        return X[..., self.cell_dofs]

    def values_vec(self, Xf):
        """Packed vector flat -> boundary values [nb, q, 2]."""
        loc = self._local(Xf.view(2, self.lay.n_flat))
        return torch.einsum("bql,abl->bqa", self.phi, loc)

    def values_scalar(self, Pf):
        """On a scalar layout (the P1 pressure): boundary values [nb, q]."""
        return torch.einsum("bql,bl->bq", self.phi, self._local(Pf))

    def grads_vec(self, Xf):
        """[nb, q, a, d] = d u_a / d x_d at the boundary quadrature points."""
        loc = self._local(Xf.view(2, self.lay.n_flat))
        return torch.einsum("bqld,abl->bqad", self.dphiG, loc)

    def integrate_rhs_vec(self, val):
        """val [nb, q, 2] -> packed vector flat (seam-consistent)."""
        loc = torch.einsum("bqa,bqi->abi", val, self.wphi).reshape(2, -1)
        loc = torch.cat([loc, loc.new_zeros(2, 1)], dim=1)
        sums = loc[:, self._table].sum(-1)
        out = torch.zeros(2, self.lay.n_flat, dtype=val.dtype, device=val.device)
        out.index_copy_(1, self._targets, sums)
        return self.lay.seam_sum(out).view(-1)


class _Level:
    pass


class PackedPatchP1Hierarchy:
    """Geometric multigrid for the pressure Poisson operator on the packed
    P1 layouts of every hierarchy level: V-cycle with Chebyshev smoothing
    (Jacobi-scaled), lattice prolongation and its exact adjoint, a dense
    inverse on the coarsest level. bc_mask: the finest level's packed
    Dirichlet mask (1.0 on constrained slots), or None for the pure-Neumann
    operator (constant nullspace projected at every level). Tables live on
    `device` in `dtype` (defaults: the finest mesh's). Each level's
    lambda_max comes from a power iteration (solvers/chebyshev.py);
    set_lmax (interop.load_hierarchy_lmax) replaces it."""

    def __init__(self, info: PatchInfo, bc_mask=None, smoother_degree=3,
                 coarse_dense_max=3000, lmin_ratio=0.30, dtype=None,
                 device=None):
        from ..solvers.chebyshev import power_iteration_lmax

        mesh = info.meshes[-1]
        self.dtype = dtype = mesh.dtype if dtype is None else dtype
        self.device = device = _device(mesh.device if device is None else device)
        self.info = info
        self.nlevels = info.k + 1
        self.neumann = bc_mask is None
        self.smoother_degree = smoother_degree
        self.lmin_ratio = lmin_ratio

        self.levels = []
        for l in range(self.nlevels):
            L = _Level()
            L.kern = P1LevelKernels(info, l, dtype, device)
            L.lay = L.kern.lay
            self.levels.append(L)

        masks = [None] * self.nlevels
        if bc_mask is not None:
            masks[-1] = torch.as_tensor(bc_mask, dtype=dtype, device=device)
            for l in range(self.nlevels - 2, -1, -1):
                fl = self.levels[l + 1].lay.unflatten(masks[l + 1])[0]
                masks[l] = fl[::2, ::2].reshape(-1)

        for l, L in enumerate(self.levels):
            L.mask = masks[l]
            L.free = None if L.mask is None else (1.0 - L.mask)
            base = L.kern.stiffness_apply
            if L.mask is None:
                L.K = base
            else:

                def K(x, base=base, free=L.free, mask=L.mask):
                    return free * base(free * x) + mask * x

                L.K = K
            # the global stiffness diagonal, packed (one-time, exact)
            sp = FunctionSpace(info.meshes[l], 1)
            dg = L.lay.to_packed(assembly.stiffness_diag(sp, geometry(info.meshes[l])))
            diag = torch.where(dg > 0, dg, torch.ones_like(dg))
            if L.mask is not None:
                diag = L.free * diag + L.mask
            L.diag = diag
            self.set_lmax(L, power_iteration_lmax(L.K, diag, L.lay.n_flat, dtype=dtype))

        mesh0 = info.meshes[0]
        S0 = FunctionSpace(mesh0, 1)
        n0 = mesh0.n_points
        assert n0 <= coarse_dense_max, f"coarse level too big: {n0}"
        K0 = dense.scalar_dense(S0, assembly.stiffness_local(S0, geometry(mesh0)))
        L0 = self.levels[0]
        if self.neumann:
            v = np.full(n0, 1.0 / np.sqrt(n0))
            K0 = K0 + np.outer(v, v)
        else:
            m0 = L0.lay.from_packed(L0.mask).cpu().numpy() == 1.0
            K0[m0, :] = 0.0
            K0[:, m0] = 0.0
            K0[m0, m0] = 1.0
        self.K0_inv = torch.as_tensor(np.linalg.inv(K0), dtype=dtype, device=device)

    def set_lmax(self, L, lmax):
        """Set a level's lambda_max estimate and the Chebyshev interval
        [lmin_ratio, 1.05] * lmax derived from it."""
        L.lmax = float(lmax)
        lmax_s, lmin_s = 1.05 * L.lmax, self.lmin_ratio * L.lmax
        L.theta = 0.5 * (lmax_s + lmin_s)
        L.delta = 0.5 * (lmax_s - lmin_s)

    # -- transfers ---------------------------------------------------------------
    def prolong(self, l, xc):
        """P1 lattice interpolation from level l to l+1 ([mc, mc, C] ->
        [2mc-1, 2mc-1, C]; consistent -> consistent)."""
        Xc = self.levels[l].lay.unflatten(xc)[0]
        layf = self.levels[l + 1].lay
        out = torch.empty(layf.n_flat, dtype=xc.dtype, device=xc.device)
        Y = layf.unflatten(out)[0]
        Y[::2, ::2] = Xc
        torch.add(Xc[:-1], Xc[1:], out=Y[1::2, ::2]).mul_(0.5)
        torch.add(Xc[:, :-1], Xc[:, 1:], out=Y[::2, 1::2]).mul_(0.5)
        torch.add(Xc[1:, :-1], Xc[:-1, 1:], out=Y[1::2, 1::2]).mul_(0.5)
        return out

    def restrict(self, l, rf):
        """The exact adjoint of prolong on the replicated layout (weight
        split, local transpose, coarse seam sum): level l+1 -> l."""
        layf = self.levels[l + 1].lay
        Rf = layf.unflatten(layf.weight_t * rf)[0]
        layc = self.levels[l].lay
        out = Rf[::2, ::2].contiguous().view(-1)
        o = layc.unflatten(out)[0]
        H, V, D = 0.5 * Rf[1::2, ::2], 0.5 * Rf[::2, 1::2], 0.5 * Rf[1::2, 1::2]
        o[:-1, :] += H
        o[1:, :] += H
        o[:, :-1] += V
        o[:, 1:] += V
        o[1:, :-1] += D
        o[:-1, 1:] += D
        return layc.seam_sum(out)

    # -- smoothing ------------------------------------------------------------------
    def _smooth(self, L, b, x):
        """`smoother_degree` Chebyshev iterations on K x = b from x."""
        sigma = L.theta / L.delta
        rho = 1.0 / sigma
        r = b - L.K(x)
        d = (r / L.diag) / L.theta
        x = x + d
        for _ in range(self.smoother_degree - 1):
            r = r - L.K(d)
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = rho_new * rho * d + (2.0 * rho_new / L.delta) * (r / L.diag)
            x = x + d
            rho = rho_new
        return x

    def _project(self, l, x):
        lay = self.levels[l].lay
        w = lay.weight_t
        return (x - torch.sum(w * x) / torch.sum(w)) * lay.valid_t

    # -- V-cycle -----------------------------------------------------------------
    @spanned("flow.vcycle")
    def v_cycle(self, b):
        """One V(smooth, smooth) cycle applied to b (zero initial guess):
        linear and SPD, the pressure CG's M."""
        if self.neumann:
            b = self._project(self.nlevels - 1, b)
        bs = [None] * self.nlevels
        xs = [None] * self.nlevels
        bs[-1] = b
        for l in range(self.nlevels - 1, 0, -1):
            L = self.levels[l]
            x = self._smooth(L, bs[l], torch.zeros_like(bs[l]))
            r = bs[l] - L.K(x)
            if self.neumann:
                r = self._project(l, r)
            xs[l] = x
            rc = self.restrict(l - 1, r)
            if self.levels[l - 1].mask is not None:
                rc = (1.0 - self.levels[l - 1].mask) * rc
            bs[l - 1] = rc
        L0 = self.levels[0]
        x0 = L0.lay.to_packed(self.K0_inv @ L0.lay.from_packed(bs[0]))
        if self.neumann:
            x0 = self._project(0, x0)
        xs[0] = x0
        for l in range(1, self.nlevels):
            corr = self.prolong(l - 1, xs[l - 1])
            if self.levels[l].mask is not None:
                corr = (1.0 - self.levels[l].mask) * corr
            xs[l] = self._smooth(self.levels[l], bs[l], xs[l] + corr)
        out = xs[-1]
        if self.neumann:
            out = self._project(self.nlevels - 1, out)
        return out * self.levels[-1].lay.valid_t
