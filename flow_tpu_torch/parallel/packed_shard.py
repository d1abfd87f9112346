# The packed-patch projection stepper distributed over ranks by blocks of
# patches. Port of flow_tpu/parallel/packed_shard.py (ShardedPackedStepper).
#
# Patches (coarse cells) are ordered in strips by centroid along the
# domain's long axis and cut into equal blocks, one a rank; the patch count
# is padded to a multiple of the rank count with DUMMY patches (zero
# geometry, no seams, zero weight), so every rank's planes are [a, b, Cl]
# and the dummies are arithmetic no-ops. The partition (PackedShardPlan) is
# the JAX package's, bit for bit.
#
# Each rank holds its block: the volume operators of fem/patchpack.py run
# unchanged on its planes. The only coupling between ranks is
#   * the seam sum of an overlap-add: one all_gather of the seam values
#     other ranks need (side points whose partner lies on another rank, and
#     patch corners whose coarse vertex has replicas elsewhere); each rank
#     then sums its side points and corners from its own values and the
#     gathered ones, in the single-card order (fem/patchpack.py), so the
#     seam sum is bitwise the single card's;
#   * the inner products and the CFL maximum: one all_reduce each, as the
#     JAX package's psum/pmax; GMRES's projections reduce through
#     krylov.gmres(reduce=);
#   * the multigrid's coarse solve: every rank adds its weighted coarse
#     values into the n0-vector of the coarse mesh, one all_reduce, and
#     every rank solves the replicated dense system.
# Every table is sliced from the single-card stepper built on the host
# (`base`, on the CPU, as the JAX package builds it under setup_on_cpu), so
# the distributed step takes the single card's Krylov decisions: the CPU
# tests hold it iterate-exact against `base` and the JAX class. The
# multigrid levels read their Chebyshev bounds from base.hierarchy, so
# interop.load_hierarchy_lmax(stepper.hierarchy, lmax) after construction
# reaches the distributed cycle too.
#
# Collectives go through parallel/comm.py on `group` (default: the world);
# the rank's tables and state live on `device` (default cuda:<local rank>).
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..fem.gathersum import member_table
from ..fem.patch import PatchInfo
from ..fem.patchpack import (
    PackedBoundary,
    PackedLayout,
    PackedPatch,
    PackedPatchP1Hierarchy,
    P1LevelKernels,
)
from ..navier_stokes.patchfast import PackedPatchStepper
from ..solvers import krylov
from . import comm

__all__ = ["ShardedPackedStepper", "PackedShardPlan"]


# ---------------------------------------------------------------------------
# host-side partition plan (numpy, once)
# ---------------------------------------------------------------------------
def _strip_order(info: PatchInfo):
    """Patch order minimizing the cut for block partitions: lexicographic
    centroid sort along the domain's long axis (strips)."""
    coarse = info.meshes[0]
    cent = coarse.points_np[coarse.cells_np].mean(axis=1)
    ext = cent.max(axis=0) - cent.min(axis=0)
    ax = int(np.argmax(ext))
    return np.lexsort((cent[:, 1 - ax], cent[:, ax]))


def _slice_gidx(arr, gidx, fill=0.0):
    """arr[gidx] with -1 slots -> fill."""
    a = np.asarray(arr)
    out = a[np.maximum(gidx, 0)]
    return np.where(gidx >= 0, out, np.asarray(fill, dtype=out.dtype))


class PackedShardPlan:
    """Partition of the patch axis over ndev ranks (the JAX package's)."""

    def __init__(self, info: PatchInfo, ndev: int):
        self.info = info
        self.ndev = ndev
        C = info.C
        perm = _strip_order(info)  # new -> old
        Cl = -(-C // ndev)
        Cpad = Cl * ndev
        old_of_new = np.full(Cpad, -1, dtype=np.int64)
        old_of_new[:C] = perm
        new_of_old = np.empty(C, dtype=np.int64)
        new_of_old[perm] = np.arange(C)
        self.C, self.Cl, self.Cpad = C, Cl, Cpad
        self.old_of_new = old_of_new
        self.new_of_old = new_of_old
        self.dev_of_old = new_of_old // Cl

    def local_flat_index(self, lay: PackedLayout):
        """[ndev, n_flat_local] global flat slot of each local slot (-1 at
        dummy-patch slots). Local flat order: plane-major, (i*b+j)*Cl+q."""
        Cl, ndev = self.Cl, self.ndev
        parts = []
        for p, (a, b) in enumerate(lay.planes):
            off = int(lay.offsets[p])
            base = off + np.arange(a * b, dtype=np.int64)[:, None] * lay.C
            g = np.where(
                self.old_of_new[None, :] >= 0,
                base + np.maximum(self.old_of_new[None, :], 0),
                -1,
            )  # [a*b, Cpad]; Cpad order is the new patch index d*Cl+q
            parts.append(g.reshape(a * b, ndev, Cl).transpose(1, 0, 2))
        return np.concatenate([blk.reshape(ndev, -1) for blk in parts], axis=1)

    def locate(self, lay: PackedLayout, g):
        """Global flat slots g -> (rank, local flat slot)."""
        g = np.asarray(g, dtype=np.int64)
        p = np.searchsorted(lay.offsets, g, side="right") - 1
        rel = g - lay.offsets[p]
        ij, c = rel // lay.C, rel % lay.C
        new = self.new_of_old[c]
        d, q = new // self.Cl, new % self.Cl
        loc_off = np.concatenate([[0], np.cumsum([a * b * self.Cl for a, b in lay.planes])])
        return d, loc_off[p] + ij * self.Cl + q

    def seam_tables(self, lay: PackedLayout, rank):
        """This rank's seam-sum tables for a layout, from the single-card
        layout's (own, partner) side pairs and corner groups. Indices into
        ext = [local X (n_l) | every rank's exports (ndev * E) | 0]:
        exports (the local slots other ranks read, padded with n_l: the
        zero of [X | 0]), own/partner (side points), put/table (corners,
        each row its coarse vertex's replicas in the single-card order)."""
        ndev = self.ndev
        n_l = sum(a * b for a, b in lay.planes) * self.Cl
        k = lay._n_side
        gath = lay._seam_gather_np
        own_g, part_g = gath[:k], gath[k: 2 * k]
        d_own, l_own = self.locate(lay, own_g)
        d_part, l_part = self.locate(lay, part_g)
        cs = lay._corner_slots.astype(np.int64)
        grp = lay._corner_group.astype(np.int64)
        d_cs, l_cs = self.locate(lay, cs)
        members = member_table(grp, lay._n_corner_groups)  # pad: 3C
        mdev = np.concatenate([d_cs, [-1]])[members]
        multi = (np.where(members < len(cs), mdev, ndev).min(1)
                 != np.where(members < len(cs), mdev, -1).max(1))
        # what each rank exports: remote side partners, shared corners
        req_d = np.concatenate([d_part[d_own != d_part], d_cs[multi[grp]]])
        req_l = np.concatenate([l_part[d_own != d_part], l_cs[multi[grp]]])
        exports, pos = [], np.full((ndev, n_l), -1, dtype=np.int64)
        for e in range(ndev):
            rows = np.unique(req_l[req_d == e])
            exports.append(rows)
            pos[e, rows] = np.arange(len(rows))
        E = max(max(len(r) for r in exports), 1)
        any_remote = sum(len(r) for r in exports) > 0

        def ext(d, l):
            return np.where(d == rank, l, n_l + d * E + pos[d, l])

        mine = d_own == rank
        own = l_own[mine]
        partner = ext(d_part[mine], l_part[mine])
        kc = np.where(d_cs == rank)[0]
        put = l_cs[kc]
        rows = members[grp[kc]]  # [n_corners, kmax] positions into cs
        real = rows < len(cs)
        rr = np.where(real, rows, 0)
        table = np.where(real, ext(d_cs[rr], l_cs[rr]), n_l + ndev * E)
        exp = np.full(E, n_l, dtype=np.int64)
        exp[: len(exports[rank])] = exports[rank]
        assert (ext(d_part[mine], l_part[mine]) >= 0).all() and (table >= 0).all()
        return {"exports": exp, "own": own, "partner": partner, "put": put,
                "table": table, "E": E, "any_remote": any_remote}

    def slice_patch_axis(self, A, rank):
        """[..., n*n*C] cell tensor (X = (i*n + j)*C + c) -> this rank's
        [..., n*n*Cl] (dummy patches 0)."""
        cl = self.old_of_new[rank * self.Cl: (rank + 1) * self.Cl]
        C = self.C
        lead = tuple(A.shape[:-1])
        A = A.reshape(lead + (-1, C))
        out = A[..., torch.as_tensor(np.maximum(cl, 0), device=A.device)]
        if (cl < 0).any():
            keep = torch.as_tensor(cl >= 0, dtype=A.dtype, device=A.device)
            out = out * keep
        return out.reshape(lead + (-1,))


# ---------------------------------------------------------------------------
# one rank's layout, with the seam sum across ranks
# ---------------------------------------------------------------------------
class _LocalLayout(PackedLayout):
    """PackedLayout work-alike over one rank's patch block: windows and
    overlap-adds are inherited; the seam sum all_gathers the exported seam
    values and sums in the single-card order."""

    def __init__(self, ref: PackedLayout, plan, rank, group, dtype, device):
        # no super().__init__: the index structures are sliced from ref
        self.C = plan.Cl
        self.nct = ref.nct
        self.planes = ref.planes
        self.win = ref.win
        self.dtype, self.device = dtype, device
        sizes = [a * b * self.C for a, b in ref.planes]
        self.offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        self.n_flat = int(self.offsets[-1])
        self.group = group
        self.gidx = gidx = plan.local_flat_index(ref)[rank]
        self.weight = _slice_gidx(ref.weight, gidx)
        self.valid = _slice_gidx(ref.valid, gidx, fill=False)

        def dev(a, dt=dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)

        self.weight_t = dev(self.weight)
        self.valid_t = dev(self.valid.astype(np.float64))
        st = plan.seam_tables(ref, rank)
        self._ndev = plan.ndev
        self._E = st["E"]
        self._remote = st["any_remote"]
        self._exports = dev(st["exports"], torch.int64)
        self._own = dev(st["own"], torch.int64)
        self._partner = dev(st["partner"], torch.int64)
        self._put = dev(np.concatenate([st["own"], st["put"]]), torch.int64)
        self._table = dev(st["table"], torch.int64)

    def seam_sum(self, X):
        lead = tuple(X.shape[:-1])
        zero = X.new_zeros(lead + (1,))
        parts = [X]
        if self._remote:
            buf = torch.cat([X, zero], -1).index_select(-1, self._exports)
            allb = comm.all_gather(buf, self.group)  # [ndev, ..., E]
            parts.append(allb.movedim(0, -2).reshape(lead + (self._ndev * self._E,)))
        else:
            parts.append(X.new_zeros(lead + (self._ndev * self._E,)))
        parts.append(zero)
        ext = torch.cat(parts, -1)
        side = X.index_select(-1, self._own) + ext.index_select(-1, self._partner)
        corner = ext[..., self._table].sum(-1)
        X.index_copy_(X.dim() - 1, self._put, torch.cat([side, corner], -1))
        return X

    def dot(self, x, y):
        w = self.weight_t.reshape(self.weight_t.shape + (1,) * (x.dim() - 1))
        return comm.all_reduce_sum(torch.sum(w * x * y), self.group)

    def to_packed(self, x):  # pragma: no cover - setup is the stepper's
        raise NotImplementedError("use ShardedPackedStepper.to_sharded")

    def from_packed(self, X):  # pragma: no cover
        raise NotImplementedError("use ShardedPackedStepper.from_sharded")


def _local_packed_patch(ref: PackedPatch, lay2, lay1, plan, rank, device):
    """PackedPatch work-alike: the volume kernels run unchanged on the
    rank's [n, n, Cl] blocks; the cell tensors are sliced on the patch
    axis, the constants moved to the device."""
    pp = object.__new__(PackedPatch)
    pp.info, pp.mesh = ref.info, ref.mesh
    pp.dtype, pp.device = ref.dtype, device
    pp.lay2, pp.lay1 = lay2, lay1
    pp.n2, pp.n1 = lay2.n_flat, lay1.n_flat
    for name in ("qw", "phi", "dphi", "nq", "Mref2", "Kref2", "Bref21", "Href2",
                 "dref1", "refint2", "_refint_dofs"):
        setattr(pp, name, getattr(ref, name))
    for name in ("detJ", "G", "dJG", "half_dJ", "kscal"):
        setattr(pp, name, plan.slice_patch_axis(getattr(ref, name), rank).to(device))
    for name in ("Mref_t", "Mref_mat", "phi_t", "wphiT", "dphi_t", "Kt_mat",
                 "Bdiv_mat", "Bgrad_mat", "H_mat", "dref_t", "drefT", "refint_t"):
        setattr(pp, name, getattr(ref, name).to(device))
    p1 = object.__new__(P1LevelKernels)
    p1.lay = lay1
    p1.kc = plan.slice_patch_axis(ref.p1.kc, rank).to(device)
    pp.p1 = p1
    return pp


def _local_boundary(bt: PackedBoundary, lay_g, lay_l, facets, device):
    """The facets this rank owns of a PackedBoundary, addressed to its local
    layout (a dof's first local replica), with their deterministic sum
    table."""
    out = object.__new__(PackedBoundary)
    out.lay = lay_l
    idx = torch.as_tensor(facets, dtype=torch.int64)
    out.phi = bt.phi[idx].to(device)
    out.wl = bt.wl[idx].to(device)
    out.normals = bt.normals[idx].to(device)
    out.nq1 = bt.nq1
    out.dphiG = bt.dphiG[idx].to(device)
    out.wphi = bt.wphi[idx].to(device)
    dofs = lay_g.L[bt.cell_dofs_np[facets]]  # [nb_l, nl]
    assert (dofs >= 0).all()
    gidx = lay_l.gidx
    Lloc = _slice_gidx(lay_g.L, gidx, fill=-1)
    Lloc = np.where(gidx < 0, -1, Lloc)
    v = np.where(Lloc >= 0)[0]
    first = np.full(lay_g.n_dofs, -1, dtype=np.int64)
    first[Lloc[v[::-1]]] = v[::-1]
    cd = first[dofs]
    assert (cd >= 0).all(), "facet dof missing from its owning rank"
    out.cell_dofs_np = cd
    out.cell_dofs = torch.as_tensor(cd, device=device)
    uniq, inv = np.unique(cd.reshape(-1), return_inverse=True)
    out._targets = torch.as_tensor(uniq, dtype=torch.int64, device=device)
    out._table = torch.as_tensor(member_table(inv, len(uniq)), device=device)
    return out


# ---------------------------------------------------------------------------
# the distributed multigrid (pressure preconditioner)
# ---------------------------------------------------------------------------
class _LocalLevel:
    """A level on one rank; its Chebyshev bounds are the single-card
    level's (the distributed operator is the same operator)."""

    def __init__(self, glevel):
        self._g = glevel

    @property
    def theta(self):
        return self._g.theta

    @property
    def delta(self):
        return self._g.delta


class _LocalHierarchy(PackedPatchP1Hierarchy):
    """One rank's twin of the packed P1 multigrid: smoothers and transfers
    are inherited (window operations on the local planes and the
    distributed seam sum); the dense coarse solve sums the weighted coarse
    values of every rank into the replicated n0 system (one all_reduce),
    and the Neumann projections all_reduce the weighted mean."""

    def __init__(self, levels, neumann, smoother_degree, K0_inv, l0_table, w0,
                 l0_dofs, n0, group):
        self.levels = levels
        self.nlevels = len(levels)
        self.neumann = neumann
        self.smoother_degree = smoother_degree
        self.K0_inv = K0_inv
        self._l0_table = l0_table  # [n0, k] local slots (pad n_l: a zero)
        self._w0 = w0
        self._l0_dofs = l0_dofs  # local slot -> global coarse dof (n0: none)
        self._n0 = n0
        self.group = group

    def _project(self, l, x):
        lay = self.levels[l].lay
        w = lay.weight_t
        sums = comm.all_reduce_sum(torch.stack([torch.sum(w * x), torch.sum(w)]),
                                   self.group)
        return (x - sums[0] / sums[1]) * lay.valid_t

    def v_cycle(self, b):
        # PackedPatchP1Hierarchy.v_cycle with the coarse block replaced by
        # the all_reduced replicated dense solve
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
        wb = torch.cat([self._w0 * bs[0], bs[0].new_zeros(1)])
        b0 = comm.all_reduce_sum(wb[self._l0_table].sum(-1), self.group)
        x0g = self.K0_inv @ b0
        x0 = x0g[self._l0_dofs] * L0.lay.valid_t
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


class _LocalStepper(PackedPatchStepper):
    """One rank's stepper. Every discrete equation is inherited from
    PackedPatchStepper (the same substeps and Krylov calls); this class
    only swaps the inner products and the CFL maximum for all_reduced ones
    and passes the reduction to GMRES, so the distributed step takes the
    single card's Krylov decisions."""

    def __init__(self):  # attributes are assigned by ShardedPackedStepper
        pass

    def dotv(self, x, y):
        return comm.all_reduce_sum(torch.sum(self.wvec * x * y), self.group)

    def dotp(self, x, y):
        return comm.all_reduce_sum(torch.sum(self.w1 * x * y), self.group)

    def _mom_krylov(self, A, b, M, rtol, atol):
        if self.mom_solver == "gmres":
            sw = self._sqrtw
            group = self.group

            def sdot(x, y):
                return comm.all_reduce_sum(torch.sum(x * y), group)

            def A2(v):
                return sw * A(v / sw)

            def M2(v):
                return sw * M(v / sw)

            x2, sinfo = krylov.gmres(
                A2, sw * b, M=M2, rtol=rtol, atol=atol, maxiter=300,
                restart=self.gmres_restart, dot=sdot,
                reduce=lambda h: comm.all_reduce_sum(h, group),
            )
            return x2 / sw, sinfo
        return krylov.bicgstab(A, b, M=M, rtol=rtol, atol=atol, maxiter=300,
                               dot=self.dotv)

    def _next_dt(self, U1, dt, dt_cap, cfl):
        a, b = self.pp.comps(U1)
        umax = comm.all_reduce_max(torch.sqrt(torch.max(a * a + b * b)), self.group)
        target_dt = cfl * self.hmax / torch.clamp(umax, min=1e-30)
        return torch.minimum(
            dt_cap,
            dt * torch.clamp(1.0 + 0.5 * (target_dt - dt) / dt, max=2.0),
        )


# ---------------------------------------------------------------------------
# the public distributed stepper
# ---------------------------------------------------------------------------
class ShardedPackedStepper:
    """PackedPatchStepper distributed over the ranks of `group` (default:
    the world) by blocks of patches. Each rank holds its block of the
    packed state: Us [2 * n2_local] (component-major), Ps [n1_local], on
    `device` (default cuda:<local rank>; "cpu" with a gloo group).
    to_sharded/from_sharded convert from/to the global layout (U [n_V, 2],
    P [n_Q]); from_sharded gathers the global state on every rank.

    step(Us, Ps, dt)       -> (U1s, P1s, StepStats)
    run(Us, Ps, dt0, n)    -> (Us, Ps, dt, telemetry): n steps with the
                              CFL controller (BDF2 when built with
                              time_step_method="bdf2")

    base is the single-card PackedPatchStepper the tables are sliced from,
    built on the CPU; hierarchy is its multigrid, whose Chebyshev bounds
    the distributed cycle reads. Keywords go to PackedPatchStepper."""

    def __init__(self, V, Q, u_bcs, p_bcs, rho, mu, info: PatchInfo, group=None,
                 device=None, time_step_method="backward euler", dtype=None, **kw):
        self.group = group
        self.device = device = comm.resolve_device(device, group)
        self.rank = rank = dist.get_rank(group)
        self.ndev = ndev = dist.get_world_size(group)
        base = PackedPatchStepper(V, Q, u_bcs, p_bcs, rho, mu, info,
                                  time_step_method=time_step_method, device="cpu",
                                  dtype=dtype, **kw)
        self.base = base
        self.hierarchy = base.hierarchy
        pp = base.pp
        self.dtype = dtype = pp.dtype
        self.plan = plan = PackedShardPlan(info, ndev)

        lay2 = _LocalLayout(pp.lay2, plan, rank, group, dtype, device)
        lay1 = _LocalLayout(pp.lay1, plan, rank, group, dtype, device)
        self._gidx2 = plan.local_flat_index(pp.lay2)
        self._gidx1 = plan.local_flat_index(pp.lay1)
        nbr = pp.lay2._nbr
        rows = np.where(nbr < 3 * plan.C)[0]
        dev_c = plan.dev_of_old
        self._seam_stats = {
            "n_patches": plan.C,
            "patches_per_device": plan.Cl,
            "exported_values_max": int(lay2._E),
            "remote_row_pairs": int((dev_c[rows % plan.C]
                                     != dev_c[nbr[rows] % plan.C]).sum()),
            "local_rows_per_device": 3 * plan.Cl,
        }

        st = _LocalStepper()
        st.group = group
        st.pp = pplocal = _local_packed_patch(pp, lay2, lay1, plan, rank, device)
        st.device, st.dtype = device, dtype
        st.rho, st.mu, st.hmax = base.rho, base.mu, base.hmax
        st.bdf2 = base.bdf2
        for name in ("newton_tol", "newton_rtol", "linear_rtol", "pressure_rtol",
                     "pressure_maxiter", "correction_rtol", "cfl_target", "dt_max",
                     "mom_solver", "gmres_restart", "has_p_bcs", "rotational",
                     "picard_maxiter", "picard_tol"):
            setattr(st, name, getattr(base, name))
        st.forces_probe = None

        def slice_vec(x, gidx, pin=None):
            n = len(x) // 2
            parts = [_slice_gidx(x[:n], gidx), _slice_gidx(x[n:], gidx)]
            out = np.concatenate(parts)
            if pin is not None:
                out = np.where(np.concatenate([gidx < 0] * 2), pin, out)
            return torch.as_tensor(out, dtype=dtype, device=device)

        def slice_p(x, gidx, pin=None):
            out = _slice_gidx(x, gidx)
            if pin is not None:
                out = np.where(gidx < 0, pin, out)
            return torch.as_tensor(out, dtype=dtype, device=device)

        g2, g1 = self._gidx2[rank], self._gidx1[rank]
        # dummy slots are pinned like the single card's padding: Dirichlet-0
        st.mask_u = slice_vec(base.mask_u.numpy(), g2, pin=1.0)
        st.val_u = slice_vec(base.val_u.numpy(), g2)
        st.mask_p = slice_p(base.mask_p.numpy(), g1, pin=1.0)
        st.val_p = slice_p(base.val_p.numpy(), g1)
        st.mass_diag = slice_vec(base.mass_diag.numpy(), g2, pin=1.0)
        st.stiff_diag = slice_vec(base.stiff_diag.numpy(), g2, pin=1.0)
        st.wvec = torch.cat([lay2.weight_t, lay2.weight_t])
        st._sqrtw = torch.sqrt(torch.where(st.wvec > 0, st.wvec,
                                           torch.ones_like(st.wvec)))
        st.w1 = lay1.weight_t

        # boundary facets, by owning patch
        slot = info.fine_cell_slot()
        n, C = info.n, info.C
        half = C * n * n
        s = slot[np.asarray(info.meshes[-1].boundary_cells_np, dtype=np.int64)]
        patch_old = np.where(s < half, s // (n * n), (s - half) // (n * n))
        facets = np.where(plan.dev_of_old[patch_old] == rank)[0]
        st.bt = _local_boundary(base.bt, pp.lay2, lay2, facets, device)
        st.btQ = _local_boundary(base.btQ, pp.lay1, lay1, facets, device)

        # the multigrid levels
        gh = base.hierarchy
        levels = []
        for l, GL in enumerate(gh.levels):
            L = _LocalLevel(GL)
            L.lay = lay_l = (lay1 if l == len(gh.levels) - 1 else
                             _LocalLayout(GL.lay, plan, rank, group, dtype, device))
            kern = object.__new__(P1LevelKernels)
            kern.lay = lay_l
            kern.kc = plan.slice_patch_axis(GL.kern.kc, rank).to(device)
            L.kern = kern
            gidx = lay_l.gidx
            L.mask = None
            if GL.mask is not None:
                L.mask = slice_p(GL.mask.numpy(), gidx, pin=1.0)
            L.free = None if L.mask is None else 1.0 - L.mask
            basek = kern.stiffness_apply
            if L.mask is None:
                L.K = basek
            else:
                def K(x, basek=basek, free=L.free, mask=L.mask):
                    return free * basek(free * x) + mask * x
                L.K = K
            L.diag = slice_p(GL.diag.numpy(), gidx, pin=1.0)
            levels.append(L)
        n0 = info.meshes[0].n_points
        lay0 = gh.levels[0].lay
        gidx0 = levels[0].lay.gidx
        l0 = _slice_gidx(lay0.L, gidx0, fill=-1)
        l0 = np.where((gidx0 < 0) | (l0 < 0), n0, l0)
        table = member_table(l0, n0 + 1)[:n0]  # pad = len(l0): the zero
        self._K0_inv = gh.K0_inv.to(device)
        hier = _LocalHierarchy(
            levels, gh.neumann, gh.smoother_degree, self._K0_inv,
            torch.as_tensor(table, device=device),
            levels[0].lay.weight_t,
            torch.as_tensor(np.minimum(l0, n0 - 1), device=device),
            n0, group,
        )
        st.pressure_precond = hier.v_cycle
        self.local = st

    # -- entry points ----------------------------------------------------------
    def step(self, Us, Ps, dt):
        """One projection step on this rank's block -> (U1s, P1s, StepStats)."""
        return self.local.step(Us, Ps, dt)

    def run(self, Us, Ps, dt0, n_steps, dt_max=None, cfl_target=None):
        """n_steps steps with the CFL controller -> (Us, Ps, dt, telemetry).
        BDF2 when built with time_step_method='bdf2' (bootstrapped from a
        backward-Euler first step, as PackedPatchStepper)."""
        out = self.local.run(Us, Ps, dt0, n_steps, dt_max=dt_max,
                             cfl_target=cfl_target)
        return out[:4]

    # -- state conversion ----------------------------------------------------------
    def to_sharded(self, U, P):
        """Global dof arrays (U [n, 2], P [n1]) -> this rank's blocks."""
        pp = self.base.pp
        U = torch.as_tensor(U).to("cpu", self.dtype)
        P = torch.as_tensor(P).to("cpu", self.dtype)
        g2, g1 = self._gidx2[self.rank], self._gidx1[self.rank]
        a = _slice_gidx(pp.lay2.to_packed(U[:, 0]).numpy(), g2)
        b = _slice_gidx(pp.lay2.to_packed(U[:, 1]).numpy(), g2)
        p = _slice_gidx(pp.lay1.to_packed(P).numpy(), g1)
        dev = self.device
        return (torch.as_tensor(np.concatenate([a, b]), dtype=self.dtype, device=dev),
                torch.as_tensor(p, dtype=self.dtype, device=dev))

    def from_sharded(self, Us, Ps):
        """Every rank's blocks -> the global dof arrays (U [n, 2], P [n1]),
        on every rank (CPU tensors)."""
        pp = self.base.pp
        allU = comm.all_gather(Us, self.group).cpu().numpy()
        allP = comm.all_gather(Ps, self.group).cpu().numpy()
        n2l = self._gidx2.shape[1]
        ga = np.zeros(pp.lay2.n_flat)
        gb = np.zeros(pp.lay2.n_flat)
        gp = np.zeros(pp.lay1.n_flat)
        for d in range(self.ndev):
            v2 = self._gidx2[d] >= 0
            ga[self._gidx2[d][v2]] = allU[d, :n2l][v2]
            gb[self._gidx2[d][v2]] = allU[d, n2l:][v2]
            v1 = self._gidx1[d] >= 0
            gp[self._gidx1[d][v1]] = allP[d][v1]
        t = lambda a: torch.as_tensor(a, dtype=self.dtype)  # noqa: E731
        U = torch.stack([pp.lay2.from_packed(t(ga)), pp.lay2.from_packed(t(gb))], -1)
        return U, pp.lay1.from_packed(t(gp))

    @property
    def seam_stats(self):
        return dict(self._seam_stats)
