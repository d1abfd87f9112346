# The full Navier-Stokes projection step over dof-partitioned state with a
# halo exchange between ring neighbours. Port of
# flow_tpu/parallel/halo_step.py (HaloSpace, HaloProjection).
#
# Each rank holds, for every space, the extended vector
#   [ owned dofs (padded to the largest strip) | ghosts from the left |
#     ghosts from the right | 0 ]
# in the HaloSpace numbering (the JAX package's partition: cells sorted by
# centroid x into strips, a dof owned by the lowest rank among its cells').
# An operator apply is a forward exchange (strip-edge values to the
# neighbours' ghosts: one comm.ring_exchange, the JAX package's two
# ppermutes), an assembly over the rank's own cells into the extended
# vector (the fem/forms.py einsums through a duck-typed space, or K3 on the
# window route), and a backward exchange (ghost partial sums to their
# owners). Krylov inner products are all_reduces, the CFL maximum an
# all_reduce(MAX). Boundary ds-facets belong to their cell's rank.
#
# The Newton tangent is the torch.func.jvp of the rank's assembly between
# the two exchanges (they are linear), where the JAX package linearizes the
# whole residual. The pressure solve is CG, preconditioned (with
# mesh_hierarchy) by the distributed multigrid of _build_mg: Chebyshev
# smoothing with halo matvecs on the partitioned fine level, the residual
# all_gathered into the global numbering, restricted, and a replicated
# coarse P1Hierarchy V-cycle on every rank (its levels run csrc/ell.cu's
# kernels on the card). lax.while_loop and lax.scan are Python loops.
#
# The JAX package's knobs are constructor arguments: winkernel=True is its
# FLOW_WINKERNEL=1 (the window route, attic/halo_win.py). The pressure and
# correction solves are in increment form, the JAX package's default.
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

from ..fem import assembly, forms
from ..fem.assembly import geometry, geometry_on
from ..fem.bc import combine_bcs
from ..fem.gathersum import GatherSum, member_table
from ..fem.spaces import FunctionSpace
from ..solvers import chebyshev, krylov
from . import comm

__all__ = ["HaloSpace", "HaloProjection"]


def _strips(mesh, ndev):
    """(dev_of_cell, cell_order): cells sorted by centroid x, cut into
    ndev blocks of ceil(n_cells / ndev)."""
    cent = mesh.points_np[mesh.cells_np].mean(axis=1)
    cell_order = np.argsort(cent[:, 0], kind="stable")
    nc = mesh.n_cells
    c_per = -(-nc // ndev)
    dev_of_cell = np.empty(nc, dtype=np.int64)
    for d in range(ndev):
        dev_of_cell[cell_order[d * c_per: (d + 1) * c_per]] = d
    return dev_of_cell, cell_order


class HaloSpace:
    """Partitioned layout of one FunctionSpace over a 1-D ring of ranks:
    ownership, renumbering, halo and send tables (the JAX package's), and
    this rank's extended cell-dof map and send lists on `device`."""

    def __init__(self, space: FunctionSpace, dev_of_cell, cell_order, ndev,
                 rank=0, group=None, device="cpu"):
        self.space = space
        self.ndev, self.rank, self.group = ndev, rank, group
        self.device = torch.device(device)
        n = space.n_dofs
        cd = space.cell_dofs_np
        nl = cd.shape[1]
        nc = cd.shape[0]
        c_per = -(-nc // ndev)
        self.c_loc = c_per

        owner = np.full(n, ndev, dtype=np.int64)
        for k in range(nl):
            np.minimum.at(owner, cd[:, k], dev_of_cell)
        assert owner.max() < ndev
        self.owner = owner
        perm = np.lexsort((np.arange(n), owner))  # new slot -> old dof
        newid = np.empty(n, dtype=np.int64)
        newid[perm] = np.arange(n)
        own_counts = np.bincount(owner, minlength=ndev)
        own_starts = np.concatenate([[0], np.cumsum(own_counts)])
        self.perm, self.newid = perm, newid
        self.own_counts, self.own_starts = own_counts, own_starts
        self.n_loc = n_loc = int(own_counts.max())

        halo_from_left, halo_from_right = [], []
        for d in range(ndev):
            touched = np.unique(cd[dev_of_cell == d].ravel())
            o = owner[touched]
            assert np.isin(o, (d - 1, d, d + 1)).all(), "strip decomposition violated"
            halo_from_left.append(touched[o == d - 1])
            halo_from_right.append(touched[o == d + 1])
        self.h = h = max([1] + [len(v) for v in halo_from_left]
                         + [len(v) for v in halo_from_right])
        self.dummy = n_loc + 2 * h
        self.n_ext = n_loc + 2 * h + 1

        # device d sends send_r (its local slots) to d + 1, which receives
        # them as its ghosts from the left in the same order; send_l alike
        d = rank
        send_r = np.full(h, self.dummy, dtype=np.int64)
        send_l = np.full(h, self.dummy, dtype=np.int64)
        if d + 1 < ndev:
            lst = halo_from_left[d + 1]
            send_r[: len(lst)] = newid[lst] - own_starts[d]
        if d - 1 >= 0:
            lst = halo_from_right[d - 1]
            send_l[: len(lst)] = newid[lst] - own_starts[d]
        self._ext = ext = np.full(n, self.dummy, dtype=np.int64)
        ext[halo_from_left[d]] = n_loc + np.arange(len(halo_from_left[d]))
        ext[halo_from_right[d]] = n_loc + h + np.arange(len(halo_from_right[d]))
        ext[owner == d] = newid[owner == d] - own_starts[d]
        self.cells = cell_order[d * c_per: (d + 1) * c_per]
        self.cell_dofs_ext_np = ext[cd[self.cells]]
        valid = np.zeros(n_loc)
        valid[: own_counts[d]] = 1.0
        self.valid_np = valid

        def dev(a, dt=torch.int64):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=self.device)

        self.send_r, self.send_l = dev(send_r), dev(send_l)
        self.cell_dofs_ext = dev(self.cell_dofs_ext_np)
        self._own = dev(perm[own_starts[d]: own_starts[d + 1]])

    def ext_index(self, g):
        """Extended-local index on this rank of global dofs g."""
        return self._ext[g]

    def to_partitioned(self, x_global):
        """Global [n(, m)] -> this rank's owned slots [n_loc(, m)] (zero
        padded), on the device."""
        x = torch.as_tensor(x_global).to(self.device)
        out = x.new_zeros((self.n_loc,) + tuple(x.shape[1:]))
        out[: len(self._own)] = x[self._own]
        return out

    def from_partitioned(self, xp):
        """Every rank's owned slots -> the global [n(, m)] on every rank (a
        CPU tensor)."""
        allx = comm.all_gather(xp, self.group).cpu()
        out = allx.new_zeros((self.space.n_dofs,) + tuple(xp.shape[1:]))
        for d in range(self.ndev):
            sl = torch.as_tensor(self.perm[self.own_starts[d]: self.own_starts[d + 1]])
            out[sl] = allx[d, : len(sl)]
        return out


def _fwd(x_own, hs, group):
    """Owned [n_loc(, m)] -> extended [n_ext(, m)] on a HaloSpace's layout:
    the neighbours' strip-edge values into the ghost slots."""
    h = hs.h
    tail = tuple(x_own.shape[1:])
    xz = torch.cat([x_own, x_own.new_zeros((2 * h + 1,) + tail)])
    gl, gr = comm.ring_exchange(xz[hs.send_r], xz[hs.send_l], group)
    return torch.cat([x_own, gl, gr, x_own.new_zeros((1,) + tail)])


def _bwd(y_ext, hs, group):
    """Extended partial sums -> owned: the ghosts' sums to their owners."""
    n_loc, h = hs.n_loc, hs.h
    from_left, from_right = comm.ring_exchange(
        y_ext[n_loc + h: n_loc + 2 * h], y_ext[n_loc: n_loc + h], group)
    tail = tuple(y_ext.shape[1:])
    yz = torch.cat([y_ext[:n_loc], y_ext.new_zeros((2 * h + 1,) + tail)])
    yz.index_add_(0, hs.send_r, from_right)
    yz.index_add_(0, hs.send_l, from_left)
    return yz[:n_loc]


class _ExtLocalSpace:
    """Duck-typed FunctionSpace over a rank's extended layout: dof_sum
    returns extended vectors (in a fixed order, fem/gathersum.GatherSum);
    the caller applies the backward exchange once per operator apply."""

    def __init__(self, degree, n_components, n_ext, cell_dofs_ext_np, dtype, dim,
                 device):
        self.degree = degree
        self.n_components = n_components
        self.n_ext = n_ext
        self.cell_dofs = torch.as_tensor(cell_dofs_ext_np, device=device)
        self.mesh = SimpleNamespace(dtype=dtype, dim=dim)
        self._sum = GatherSum(cell_dofs_ext_np, n_ext, device)

    def gather(self, U_ext):
        return U_ext[self.cell_dofs]

    def dof_sum(self, loc):
        return self._sum(loc)


class HaloProjection:
    """Full projection step over dof-partitioned state with a halo exchange,
    on the ranks of `group` (default: the world), on `device` (default
    cuda:<local rank>; "cpu" with a gloo group).

    step(U_part, P_part, dt) -> (U1_part, P1_part); step_bdf2; run(U_part,
    P_part, dt0, n) -> (U, P, dt, telemetry) with the CFL controller. Each
    rank passes and gets its own partitioned blocks: .Vh/.Qh
    to_partitioned/from_partitioned convert at the edges.
    mesh_hierarchy: the refine_uniform chain ending at V's mesh, for the
    distributed multigrid pressure preconditioner (else Jacobi CG).
    convection: "newton" or "lagged". winkernel: the window route (K3) for
    the momentum matvecs (the JAX package's FLOW_WINKERNEL=1)."""

    def __init__(
        self,
        V: FunctionSpace,
        Q: FunctionSpace,
        u_bcs,
        p_bcs,
        rho,
        mu,
        f=None,
        group=None,
        device=None,
        time_step_method="backward euler",
        rotational_form=True,
        newton_tol=1.0e-10,
        newton_maxiter=10,
        linear_rtol=1.0e-7,
        pressure_rtol=1.0e-10,
        correction_rtol=1.0e-10,
        mesh_hierarchy=None,
        smoother_degree=3,
        cfl_target=1.0,
        dt_max=1.0,
        convection="newton",
        winkernel=False,
    ):
        mesh = V.mesh
        self.dtype = dtype = mesh.dtype
        self.dim = dim = getattr(mesh, "dim", 2)
        self.Q = Q
        self.group = group
        self.device = device = comm.resolve_device(device, group)
        self.ndev = ndev = dist.get_world_size(group)
        self.rank = rank = dist.get_rank(group)

        dev_of_cell, cell_order = _strips(mesh, ndev)
        self.Vh = Vh = HaloSpace(V, dev_of_cell, cell_order, ndev, rank, group, device)
        self.Qh = Qh = HaloSpace(Q, dev_of_cell, cell_order, ndev, rank, group, device)
        cells = Vh.cells

        def dev(a, dt=dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)

        geomg = geometry(mesh)
        self._geo_np = (geomg.detJ[cells], geomg.G[cells], geomg.C[cells])
        self.geom = SimpleNamespace(detJ=dev(self._geo_np[0]), G=dev(self._geo_np[1]),
                                    C=dev(self._geo_np[2]), dim=dim)
        ncomp = V.n_components
        self.ncomp = ncomp
        self.Vl = _ExtLocalSpace(V.degree, ncomp, Vh.n_ext, Vh.cell_dofs_ext_np, dtype,
                                 dim, device)
        self.Ql = _ExtLocalSpace(Q.degree, 1, Qh.n_ext, Qh.cell_dofs_ext_np, dtype, dim,
                                 device)

        # a stationary body force at the volume quadrature points of the
        # rank's cells
        self.has_f = f is not None
        self.Fq = None
        if self.has_f:
            from ..fem.interpolate import eval_callable

            tabF = assembly.tabulation(V, 6)
            xq = dev(geomg.physical_points(tabF.ref_pts)[cells])
            self.Fq = eval_callable(f, xq).to(dtype)

        mask_u, val_u = combine_bcs(V, u_bcs)
        self.mask_u = Vh.to_partitioned(dev(mask_u))
        self.val_u = Vh.to_partitioned(dev(val_u))
        self.has_p_bcs = bool(p_bcs)
        if self.has_p_bcs:
            mask_p, val_p = combine_bcs(Q, p_bcs)
            self._mask_p_global_np = mask_p
            self.mask_p = Qh.to_partitioned(dev(mask_p))
            self.val_p = Qh.to_partitioned(dev(val_p))
        else:
            self._mask_p_global_np = None
            self.mask_p = torch.zeros(Qh.n_loc, dtype=dtype, device=device)
            self.val_p = self.mask_p
        self.valid_V = dev(Vh.valid_np)
        self.valid_Q = dev(Qh.valid_np)

        md = assembly.mass_diag(V, geomg)
        sd = assembly.stiffness_diag(V, geomg)
        self.mass_diag_V = Vh.to_partitioned(dev(np.repeat(md[:, None], ncomp, 1)))
        self.stiff_diag_V = Vh.to_partitioned(dev(np.repeat(sd[:, None], ncomp, 1)))
        self.stiff_diag_Q = Qh.to_partitioned(dev(assembly.stiffness_diag(Q, geomg)))

        self._build_boundary(V, Q, mesh, dev_of_cell, geomg)

        self.rho = float(rho)
        self.mu = float(mu)
        self.rotational = rotational_form
        self.bdf2 = time_step_method == "bdf2"
        if time_step_method == "forward euler":
            self.theta = (1.0, 0.0)
        elif time_step_method in ("backward euler", "bdf2"):
            # BDF2 is backward Euler from uhat = ((1+r)^2 U - r^2 Um1)/(1+2r)
            # with dt* = dt (1+r)/(1+2r) (FastStepper's reformulation)
            self.theta = (0.0, 1.0)
        elif time_step_method == "crank-nicolson":
            self.theta = (0.5, 0.5)
        else:
            raise ValueError(f"HaloProjection: unknown time_step_method "
                             f"{time_step_method!r}")
        self.newton_tol = newton_tol
        self.newton_maxiter = newton_maxiter
        self.linear_rtol = linear_rtol
        if convection not in ("newton", "lagged"):
            raise ValueError(f"HaloProjection: unknown convection {convection!r}")
        self.lagged = convection == "lagged"
        self.pressure_rtol = pressure_rtol
        self.correction_rtol = correction_rtol
        self.degV, self.degQ = V.degree, Q.degree
        self.cfl_target = cfl_target
        self.dt_max_run = dt_max
        self.hmax = float(mesh.hmax)

        self._mg = None
        if mesh_hierarchy is not None and len(mesh_hierarchy) > 1:
            self._build_mg(mesh_hierarchy, smoother_degree)

        self.winkernel = bool(winkernel)
        self._win = None
        if self.winkernel:
            from ..attic.halo_win import build_halo_window_tables

            self._win = build_halo_window_tables(Vh, *self._geo_np, dim, device=device)

    # -- boundary facets, by owning cell -----------------------------------------
    def _build_boundary(self, V, Q, mesh, dev_of_cell, geomg):
        from ..fem.assembly import BoundaryFaceTab, BoundaryTab

        Tab = BoundaryTab if self.dim == 2 else BoundaryFaceTab
        btV = Tab(V, rule_degree=6, dtype=self.dtype, device="cpu")
        btQ = Tab(Q, rule_degree=6, dtype=self.dtype, device="cpu")
        cells_b = np.asarray(mesh.boundary_cells_np, dtype=np.int64)
        mine = np.where(dev_of_cell[cells_b] == self.rank)[0]
        self._nb_loc = len(mine)
        if not len(mine):
            return
        idx = torch.as_tensor(mine)
        d = self.device
        self.b_phiV = btV.phi[idx].to(d)
        self.b_dphiV = btV.dphi[idx].to(d)
        self.b_phiQ = btQ.phi[idx].to(d)
        self.b_wl = btV.wl[idx].to(d)
        self.b_normals = btV.normals[idx].to(d)
        self.b_Gb = torch.as_tensor(geomg.G[cells_b[mine]], dtype=self.dtype, device=d)
        self.b_cdV = torch.as_tensor(self.Vh.ext_index(V.cell_dofs_np[cells_b[mine]]),
                                     device=d)
        self.b_cdQ = torch.as_tensor(self.Qh.ext_index(Q.cell_dofs_np[cells_b[mine]]),
                                     device=d)

    # -- distributed multigrid ----------------------------------------------------
    def _build_mg(self, meshes, smoother_degree):
        """The distributed V-cycle's data: the finest level is smoothed in the
        partitioned layout (Chebyshev; its matvecs are halo exchanges); the
        residual is restricted onto a replicated P1Hierarchy on meshes[:-1],
        whose V-cycle every rank runs. One all_gather of the fine residual a
        cycle, besides the smoothers' halos."""
        from ..solvers.multigrid import P1Hierarchy

        Q, mesh = self.Q, self.Q.mesh
        dtype, device = self.dtype, self.device
        if meshes[-1].n_points != mesh.n_points:
            raise ValueError("HaloProjection: mesh_hierarchy[-1] must be the stepper's mesh")
        n = Q.n_dofs
        geo = geometry_on(mesh, dtype, device)
        diag_g = torch.as_tensor(assembly.stiffness_diag(Q, geometry(mesh)), dtype=dtype,
                                 device=device)
        diag_g = torch.where(diag_g > 0, diag_g, torch.ones_like(diag_g))
        if self.has_p_bcs:
            mask_g = torch.as_tensor(self._mask_p_global_np, dtype=dtype, device=device)
            free_g = 1.0 - mask_g

            def Kg(x):
                return free_g * assembly.stiffness_apply(Q, geo, free_g * x) + mask_g * x

            diag_pw = free_g * diag_g + mask_g
            cmask = self._mask_p_global_np[: meshes[-2].n_points]
            coarse = P1Hierarchy(meshes[:-1], bc_mask=cmask,
                                 smoother_degree=smoother_degree, dtype=dtype,
                                 device=device)
        else:
            def Kg(x):
                return assembly.stiffness_apply(Q, geo, x)

            diag_pw = diag_g
            free_g = None
            coarse = P1Hierarchy(meshes[:-1], bc_mask=None,
                                 smoother_degree=smoother_degree, dtype=dtype,
                                 device=device)
        lmax = chebyshev.power_iteration_lmax(Kg, diag_pw, n, dtype=dtype)

        Qh = self.Qh
        ndev, n_loc = self.ndev, Qh.n_loc
        inv_slot = np.zeros(n, dtype=np.int64)  # global dof -> gathered slot
        for d in range(ndev):
            gl = Qh.perm[Qh.own_starts[d]: Qh.own_starts[d + 1]]
            inv_slot[gl] = d * n_loc + np.arange(len(gl))
        og = np.zeros(n_loc, dtype=np.int64)  # this rank's slot -> global dof
        gl = Qh.perm[Qh.own_starts[self.rank]: Qh.own_starts[self.rank + 1]]
        og[: len(gl)] = gl
        e = meshes[-2].edges_np.astype(np.int64)
        nc = int(meshes[-2].n_points)
        self._mg = dict(
            coarse=coarse,
            deg=smoother_degree,
            inv_slot=torch.as_tensor(inv_slot, device=device),
            og=torch.as_tensor(og, device=device),
            e0=torch.as_tensor(e[:, 0], device=device),
            e1=torch.as_tensor(e[:, 1], device=device),
            # the restriction's edge halves, summed by coarse vertex in a
            # fixed order (P1Hierarchy.restrict's tables)
            rtable=torch.as_tensor(member_table(np.concatenate([e[:, 0], e[:, 1]]), nc),
                                   device=device),
            ncoarse=nc,
            free_g=free_g,
            coarse_mask=coarse.levels[-1].mask,
        )
        self.set_fine_lmax(lmax)

    def set_fine_lmax(self, lmax):
        """The fine level's lambda_max and its Chebyshev interval
        [0.30, 1.05] * lmax."""
        mg = self._mg
        mg["lmax"] = float(lmax)
        lmax_s, lmin_s = 1.05 * mg["lmax"], 0.30 * mg["lmax"]
        mg["theta"] = 0.5 * (lmax_s + lmin_s)
        mg["delta"] = 0.5 * (lmax_s - lmin_s)

    def _cheb_smooth(self, K, diag, b, x=None):
        """Chebyshev smoothing on K x = b (P1Hierarchy._smooth's recurrence),
        degree self._mg['deg']."""
        mg = self._mg
        sigma = mg["theta"] / mg["delta"]
        rho_ = 1.0 / sigma
        r = b if x is None else b - K(x)
        d = (r / diag) / mg["theta"]
        x = d if x is None else x + d
        for _ in range(mg["deg"] - 1):
            r = r - K(d)
            rho_new = 1.0 / (2.0 * sigma - rho_)
            d = rho_new * rho_ * d + (2.0 * rho_new / mg["delta"]) * (r / diag)
            x = x + d
            rho_ = rho_new
        return x

    def _mg_precond(self, K, diag, valid_Q, proj):
        """The rank's V-cycle callable M(r) for _dist_cg."""
        mg = self._mg
        nc = mg["ncoarse"]

        def M(r):
            x = self._cheb_smooth(K, diag, r)
            res = r - K(x)
            if proj is not None:
                res = proj(res)
            rg = comm.all_gather(res, self.group).reshape(-1)[mg["inv_slot"]]
            half = 0.5 * rg[nc:]
            halves = torch.cat([half, half, half.new_zeros(1)])
            rc = rg[:nc] + halves[mg["rtable"]].sum(dim=1)
            if mg["coarse_mask"] is not None:
                rc = (1.0 - mg["coarse_mask"]) * rc
            xc = mg["coarse"].v_cycle(rc)
            corr_g = torch.cat([xc, 0.5 * (xc[mg["e0"]] + xc[mg["e1"]])])
            if mg["free_g"] is not None:
                corr_g = mg["free_g"] * corr_g
            x = x + corr_g[mg["og"]] * valid_Q
            x = self._cheb_smooth(K, diag, r, x)
            if proj is not None:
                x = proj(x)
            return x

        return M

    # -- public entry --------------------------------------------------------------
    def _scalar(self, v):
        return torch.as_tensor(v, dtype=self.dtype, device=self.device)

    def step(self, U_part, P_part, dt):
        U1, P1, _ = self._substep_core(U_part, P_part, self._scalar(dt))
        return U1, P1

    @staticmethod
    def _bdf2_hat(U, Um1, dt, dtp):
        r = dt / dtp
        uhat = ((1.0 + r) ** 2 * U - r * r * Um1) / (1.0 + 2.0 * r)
        dt_eff = dt * (1.0 + r) / (1.0 + 2.0 * r)
        return uhat, dt_eff, r

    def step_bdf2(self, U_part, Um1_part, P_part, dt, dtp):
        """One variable-step BDF2 step on partitioned state."""
        if not self.bdf2:
            raise ValueError("HaloProjection.step_bdf2: built without bdf2")
        uhat, dt_eff, r = self._bdf2_hat(U_part, Um1_part, self._scalar(dt),
                                         self._scalar(dtp))
        x0 = (1.0 + r) * U_part - r * Um1_part
        U1, P1, _ = self._substep_core(uhat, P_part, dt_eff, x0=x0)
        return U1, P1

    def _next_dt(self, U1, dt):
        um2 = comm.all_reduce_max(torch.max(torch.sum(U1 * U1, dim=1) * self.valid_V),
                                  self.group)
        umax = torch.sqrt(um2)
        target_dt = self.cfl_target * self.hmax / torch.clamp(umax, min=1e-30)
        return torch.clamp(dt * torch.clamp(1.0 + 0.5 * (target_dt - dt) / dt, max=2.0),
                           max=self.dt_max_run)

    def run(self, U_part, P_part, dt0, n_steps, Um1=None, dtp0=None):
        """n_steps projection steps with the CFL controller -> (U, P, dt,
        telemetry): t, dt, pressure_iters, correction_iters [n_steps], the
        same on every rank. BDF2 also returns (Um1, dtp), which continue a
        run at full order when passed back (the defaults Um1 = U,
        dtp = dt0 start it)."""
        dt = self._scalar(dt0)
        t = self._scalar(0.0)
        U, P = U_part, P_part
        if self.bdf2:
            Um1 = U if Um1 is None else Um1
            dtp = dt if dtp0 is None else self._scalar(dtp0)
        rows = []
        for _ in range(n_steps):
            if self.bdf2:
                uhat, dt_eff, r = self._bdf2_hat(U, Um1, dt, dtp)
                x0 = (1.0 + r) * U - r * Um1
                U1, P1, stats = self._substep_core(uhat, P, dt_eff, x0=x0)
            else:
                U1, P1, stats = self._substep_core(U, P, dt)
            t = t + dt
            dt_new = self._next_dt(U1, dt)
            rows.append((t, dt, stats))
            if self.bdf2:
                Um1, dtp = U, dt
            U, P, dt = U1, P1, dt_new
        tel = {
            "t": torch.stack([r[0] for r in rows]),
            "dt": torch.stack([r[1] for r in rows]),
            "pressure_iters": torch.tensor([r[2]["pressure_iters"] for r in rows]),
            "correction_iters": torch.tensor([r[2]["correction_iters"] for r in rows]),
        }
        if self.bdf2:
            return U, P, dt, tel, (Um1, dtp)
        return U, P, dt, tel

    # -- the step ----------------------------------------------------------------
    def _substep_core(self, U, Pv, dt, x0=None):
        Vh, Qh = self.Vh, self.Qh
        Vl, Ql, gm = self.Vl, self.Ql, self.geom
        rho, mu = self.rho, self.mu
        dtype = self.dtype
        mask_u, val_u, valid_V = self.mask_u, self.val_u, self.valid_V
        mask_p, val_p, valid_Q = self.mask_p, self.val_p, self.valid_Q
        group = self.group

        def fwd_V(x):
            return _fwd(x, Vh, group)

        def bwd_V(y):
            return _bwd(y, Vh, group)

        def fwd_Q(x):
            return _fwd(x, Qh, group)

        def bwd_Q(y):
            return _bwd(y, Qh, group)

        def dot(a, b):
            return comm.all_reduce_sum(torch.sum(a * b), group)

        has_b = self._nb_loc > 0

        # -- boundary (ds) terms: the facets of this rank's cells ----------
        def boundary_terms_ext(W_ext, P_ext, T_ext=None):
            out = torch.zeros((Vh.n_ext, self.ncomp), dtype=dtype, device=self.device)
            if not has_b:
                return out
            wloc = W_ext[self.b_cdV]  # [nb, nlV, m]
            pq = torch.einsum("bql,bl->bq", self.b_phiQ, P_ext[self.b_cdQ])
            gw = torch.einsum("bqlk,bdk,blm->bqmd", self.b_dphiV, self.b_Gb, wloc)
            val = -pq[:, :, None] * self.b_normals[:, None, :]
            # + mu (grad u)^T n
            val = val + mu * torch.einsum("bqma,bm->bqa", gw, self.b_normals)
            # the directional do-nothing outflow term (T_ext: the lagged
            # transport of the (w.n)+ factor)
            wb = torch.einsum("bqi,bim->bqm", self.b_phiV, wloc)
            tb = wb if T_ext is None else torch.einsum(
                "bqi,bim->bqm", self.b_phiV, T_ext[self.b_cdV])
            tn = torch.einsum("bqm,bm->bq", tb, self.b_normals)
            val = val - 0.5 * rho * torch.clamp(tn, min=0.0)[:, :, None] * wb
            loc = torch.einsum("bqm,bq,bqi->bim", val, self.b_wl, self.b_phiV)
            return out.index_add(0, self.b_cdV.reshape(-1), loc.reshape(-1, self.ncomp))

        def bnd_tangent_ext(v_ext, tsrc_ext, frozen_transport):
            """Tangent of the x-dependent ds-terms at tsrc_ext (the window
            route's momentum matvecs)."""
            if not has_b:
                return None
            wloc = v_ext[self.b_cdV]
            gw = torch.einsum("bqlk,bdk,blm->bqmd", self.b_dphiV, self.b_Gb, wloc)
            val = mu * torch.einsum("bqma,bm->bqa", gw, self.b_normals)
            tb = torch.einsum("bqi,bim->bqm", self.b_phiV, tsrc_ext[self.b_cdV])
            tn = torch.einsum("bqm,bm->bq", tb, self.b_normals)
            wb = torch.einsum("bqi,bim->bqm", self.b_phiV, wloc)
            val = val - 0.5 * rho * torch.clamp(tn, min=0.0)[:, :, None] * wb
            if not frozen_transport:
                wn = torch.einsum("bqm,bm->bq", wb, self.b_normals)
                pos = (tn > 0.0).to(wb.dtype)
                val = val - 0.5 * rho * (pos * wn)[:, :, None] * tb
            loc = torch.einsum("bqm,bq,bqi->bim", val, self.b_wl, self.b_phiV)
            out = torch.zeros((Vh.n_ext, self.ncomp), dtype=dtype, device=self.device)
            return out.index_add(0, self.b_cdV.reshape(-1), loc.reshape(-1, self.ncomp))

        # -- momentum residual: fwd exchange, local assembly, bwd exchange --
        free_u = (1.0 - mask_u) * valid_V[:, None]
        Fq = self.Fq

        def rhs_weak_loc(Wloc, Ploc, Tloc=None):
            if Tloc is None:
                loc = -rho * forms.skew_convection_combined_loc(Vl, gm, Wloc, rule_degree=5)
            else:
                loc = -rho * forms.skew_convection_lagged_loc(Vl, gm, Tloc, Wloc,
                                                              rule_degree=5)
            loc = loc - forms.sym_grad_loc(Vl, gm, Wloc, mu)
            loc = loc + forms.pressure_grad_loc(Vl, Ql, gm, Ploc)
            if Fq is not None:
                loc = loc + forms.body_force_loc(Vl, gm, Fq, rule_degree=6)
            return loc

        U_ext0 = fwd_V(U)
        P_ext0 = fwd_Q(Pv)
        U0loc = Vl.gather(U_ext0)
        Ploc0 = Ql.gather(P_ext0)
        w_ex, w_im = self.theta

        def residual_ext(x_ext, T_ext=None):
            """The rank's extended residual contributions (no exchange)."""
            xloc = Vl.gather(x_ext)
            loc = forms.mass_loc(Vl, gm, xloc - U0loc)
            if w_ex:
                loc = loc - (dt / rho) * w_ex * rhs_weak_loc(U0loc, Ploc0)
            if w_im:
                Tloc = None if T_ext is None else Vl.gather(T_ext)
                loc = loc - (dt / rho) * w_im * rhs_weak_loc(xloc, Ploc0, Tloc)
            r_ext = Vl.dof_sum(loc)
            if w_ex:
                r_ext = r_ext - (dt / rho) * w_ex * boundary_terms_ext(U_ext0, P_ext0)
            if w_im:
                r_ext = r_ext - (dt / rho) * w_im * boundary_terms_ext(x_ext, P_ext0,
                                                                         T_ext)
            return r_ext

        def residual(x, T_ext=None):
            return free_u * bwd_V(residual_ext(fwd_V(x), T_ext)) + mask_u * (x - val_u)

        def tangent(x_ext, T_ext=None):
            """v -> J v at x_ext: the jvp of the rank's assembly between the
            two (linear) exchanges."""
            def f(y):
                return residual_ext(y, T_ext)

            def Jv(v):
                t = torch.func.jvp(f, (x_ext,), (fwd_V(v),))[1]
                return free_u * bwd_V(t) + mask_u * v

            return Jv

        diag = self.mass_diag_V + (dt / rho) * w_im * (2.0 * mu) * self.stiff_diag_V
        diag = free_u * diag + mask_u + (1.0 - valid_V)[:, None]
        x0 = free_u * (U if x0 is None else x0) + mask_u * val_u
        win = self._win
        s = (dt / rho) * w_im

        if self.lagged:
            # one affine solve with the transport frozen at x0 (u^n, or the
            # BDF2 extrapolation)
            x0_ext = fwd_V(x0)
            r0 = residual(x0, x0_ext)
            if win is not None:
                from ..attic.halo_win import halo_transport_q, halo_window_momentum

                meta, wt, sm, tab = win
                Tqw = halo_transport_q(meta, tab, wt["cells"], Vl.cell_dofs, x0_ext)

                def Jv(v):
                    v_ext = fwd_V(v)
                    av = halo_window_momentum(meta, sm, wt, v_ext, Tqw, 1.0, s * rho,
                                              s * mu)
                    bt = bnd_tangent_ext(v_ext, x0_ext, True)
                    if bt is not None:
                        av = av - s * bt
                    return free_u * bwd_V(av) + mask_u * v
            else:
                Jv = tangent(x0_ext, x0_ext)
            dx, _ = krylov.bicgstab(Jv, -r0, M=lambda t: t / diag, rtol=self.linear_rtol,
                                    atol=0.05 * self.newton_tol, maxiter=300, dot=dot)
            Ui = x0 + dx
        else:
            x = x0
            r = residual(x)
            rnorm = torch.sqrt(dot(r, r))
            k = 0
            while bool(rnorm > self.newton_tol) and k < self.newton_maxiter:
                x_ext = fwd_V(x)
                if win is not None:
                    from ..attic.halo_win import halo_state_q, halo_window_momentum

                    meta, wt, sm, tab = win
                    Tqw, Uqw, Guw = halo_state_q(meta, tab, wt["cells"], Vl.cell_dofs,
                                                 gm.G, x_ext)

                    def Jv(v, x_ext=x_ext, Tqw=Tqw, Uqw=Uqw, Guw=Guw):
                        v_ext = fwd_V(v)
                        av = halo_window_momentum(meta, sm, wt, v_ext, Tqw, 1.0, s * rho,
                                                  s * mu, Uq=Uqw, Gu=Guw)
                        bt = bnd_tangent_ext(v_ext, x_ext, False)
                        if bt is not None:
                            av = av - s * bt
                        return free_u * bwd_V(av) + mask_u * v
                else:
                    Jv = tangent(x_ext)
                dx, _ = krylov.bicgstab(Jv, -r, M=lambda t: t / diag,
                                        rtol=self.linear_rtol, atol=0.05 * self.newton_tol,
                                        maxiter=300, dot=dot)
                x = x + dx
                r = residual(x)
                rnorm = torch.sqrt(dot(r, r))
                k += 1
            Ui = x

        # -- pressure Poisson (increment form) --------------------------------
        def K_own(p):
            return bwd_Q(assembly.stiffness_apply(Ql, gm, fwd_Q(p)))

        Ui_ext = fwd_V(Ui)
        L2_ext = -(rho / dt) * forms.div_rhs(Vl, Ql, gm, Ui_ext)
        if self.rotational:
            L2_ext = L2_ext - mu * forms.grad_div_ustar_rhs(Vl, Ql, gm, Ui_ext)
        L2 = bwd_Q(L2_ext)
        diag_Q = torch.where(self.stiff_diag_Q > 0, self.stiff_diag_Q,
                             torch.ones_like(self.stiff_diag_Q)) + (1.0 - valid_Q)
        if not self.has_p_bcs:
            nglobal = comm.all_reduce_sum(torch.sum(valid_Q), group)

            def proj(x):
                return (x - comm.all_reduce_sum(torch.sum(x * valid_Q), group)
                        / nglobal) * valid_Q

            M = (self._mg_precond(K_own, diag_Q, valid_Q, proj)
                 if self._mg is not None else None)
            phi, piters = _dist_cg(K_own, proj(L2), diag_Q, dot, self.pressure_rtol,
                                   1000, proj, M=M)
        else:
            free_p = (1.0 - mask_p) * valid_Q

            def K_bc(p):
                return free_p * K_own(free_p * p) + mask_p * p

            pin = mask_p * (val_p - Pv)
            rhs = free_p * (L2 - K_own(pin)) + pin
            dq = free_p * diag_Q + mask_p + (1.0 - valid_Q)
            M = (self._mg_precond(K_bc, dq, valid_Q, None)
                 if self._mg is not None else None)
            phi, piters = _dist_cg(K_bc, rhs, dq, dot, self.pressure_rtol, 1000, None,
                                   M=M)
        P1 = Pv + phi

        # -- velocity correction (increment form) -----------------------------
        phi_ext = fwd_Q(P1) - P_ext0
        div_part = mu * forms.grad_div_ustar(Vl, gm, Ui_ext) if self.rotational else None
        gphi_ext = (dt / rho) * forms.grad_phi_rhs(Vl, Ql, gm, phi_ext,
                                                   div_part=div_part, rule_degree=4)

        def M_bc(u):
            y = bwd_V(assembly.mass_apply(Vl, gm, fwd_V(free_u * u)))
            return free_u * y + mask_u * u

        dm = free_u * self.mass_diag_V + mask_u + (1.0 - valid_V)[:, None]
        L3 = bwd_V(-gphi_ext)
        dmask = mask_u * (val_u - Ui)
        rhs_u = free_u * (L3 - bwd_V(assembly.mass_apply(Vl, gm, fwd_V(dmask)))) + dmask
        d, citers = _dist_cg(M_bc, rhs_u, dm, dot, self.correction_rtol, 500, None)
        return Ui + d, P1, {"pressure_iters": piters, "correction_iters": citers}


def _dist_cg(A, b, diag, dot, rtol, maxiter, proj, M=None):
    """Distributed PCG: the operator does its own halo exchange and `dot`
    all_reduces. M (optional) replaces Jacobi: an SPD preconditioner doing
    its own exchanges (the distributed V-cycle). Returns (x, iters)."""
    if proj is None:
        def proj(x):
            return x
    if M is None:
        def M(r):
            return r / diag
    b = proj(b)
    x = torch.zeros_like(b)
    r = b
    z = proj(M(r))
    p = z
    rz = dot(r, z)
    target = rtol * torch.sqrt(dot(b, b))
    rn = torch.sqrt(dot(r, r))
    k = 0
    while bool(rn > target) and k < maxiter:
        Ap = proj(A(p))
        pAp = dot(p, Ap)
        alpha = rz / torch.where(pAp == 0, 1.0, pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        z = proj(M(r))
        rz_new = dot(r, z)
        beta = rz_new / torch.where(rz == 0, 1.0, rz)
        p = z + beta * p
        rz = rz_new
        rn = torch.sqrt(dot(r, r))
        k += 1
    return x, k
