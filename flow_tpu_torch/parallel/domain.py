# Domain decomposition with replicated vectors. Port of
# flow_tpu/parallel/domain.py (partition_cells, ShardedProjection).
#
# Cells are sorted by centroid x and cut into equal blocks, one a rank;
# every rank holds the whole dof vectors. Each operator apply sums the
# contributions of the rank's own cells (plus 1/ndev of the replicated
# boundary terms) and one all_reduce of the dof vector assembles it, so the
# Krylov iterations run replicated and their inner products need no
# communication. The forms are fem/forms.py's, reached through a
# duck-typed space over the rank's cells. The Newton tangent is the
# torch.func.jvp of the rank's part of the residual, all_reduced (the sum
# is linear), where the JAX package linearizes the psum'd residual.
#
# The JAX package pads every device's cell block to one size for
# shard_map; a rank here holds its own cells only (padded cells added zero).
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

from ..fem import assembly, forms
from ..fem.assembly import geometry
from ..fem.bc import combine_bcs
from ..fem.gathersum import GatherSum
from ..fem.spaces import FunctionSpace
from ..solvers import krylov
from . import comm
from .pc_context_shared import make_boundary_arrays

__all__ = ["partition_cells", "ShardedProjection"]


def partition_cells(mesh, n_devices):
    """Spatially sorted block partition of cells -> (order, n_local): cells
    sorted by centroid x (strips), n_local = ceil(n_cells / n_devices)."""
    cent = mesh.points_np[mesh.cells_np].mean(axis=1)
    order = np.argsort(cent[:, 0], kind="stable").astype(np.int32)
    n_local = -(-len(order) // n_devices)
    return order, n_local


class _LocalSpace:
    """Duck-typed FunctionSpace over a rank's block of cells: the global dof
    numbering, the local cell list, and a dof sum in a fixed order
    (fem/gathersum.GatherSum), for fem/forms.py and fem/assembly.py."""

    def __init__(self, degree, n_components, n_dofs, cell_dofs_np, dtype, dim,
                 device):
        self.degree = degree
        self.n_components = n_components
        self.n_dofs = n_dofs
        self.cell_dofs = torch.as_tensor(cell_dofs_np, dtype=torch.int64,
                                         device=device)
        self.n_local = cell_dofs_np.shape[1]
        self.mesh = SimpleNamespace(dtype=dtype, dim=dim)
        self._sum = GatherSum(cell_dofs_np, n_dofs, device)

    def gather(self, U):
        return U[self.cell_dofs]

    def dof_sum(self, loc):
        return self._sum(loc)


class ShardedProjection:
    """The full Navier-Stokes projection step (the discrete equations of
    navier_stokes.pressure_correction) over the ranks of `group` (default:
    the world), with replicated vectors on `device` (default
    cuda:<local rank>; "cpu" with a gloo group).

    sp(U, P, dt[, Fq]) (or sp.step) -> (U1, P1, Ui): U [n_V, 2], P [n_Q]
    the same on every rank; Ui the tentative velocity."""

    def __init__(
        self,
        V: FunctionSpace,
        Q: FunctionSpace,
        u_bcs,
        p_bcs,
        rho,
        mu,
        group=None,
        device=None,
        time_step_method="backward euler",
        rotational_form=True,
        newton_tol=1.0e-10,
        newton_maxiter=10,
        linear_rtol=1.0e-7,
        pressure_rtol=1.0e-10,
        with_force=False,
        force_rule=6,
    ):
        mesh = V.mesh
        self.dtype = dtype = mesh.dtype
        self.group = group
        self.device = device = comm.resolve_device(device, group)
        self.ndev = ndev = dist.get_world_size(group)
        rank = dist.get_rank(group)

        order, n_local = partition_cells(mesh, ndev)
        self._cells = cells = order[rank * n_local: (rank + 1) * n_local].astype(np.int64)
        geomg = geometry(mesh)
        dim = getattr(mesh, "dim", 2)

        def dev(a, dt=dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)

        self.geom = SimpleNamespace(detJ=dev(geomg.detJ[cells]), G=dev(geomg.G[cells]),
                                    C=dev(geomg.C[cells]))
        self.Vl = _LocalSpace(V.degree, 2, V.n_dofs, V.cell_dofs_np[cells], dtype, dim,
                              device)
        self.Ql = _LocalSpace(Q.degree, 1, Q.n_dofs, Q.cell_dofs_np[cells], dtype, dim,
                              device)

        mask_u, val_u = combine_bcs(V, u_bcs)
        self.mask_u, self.val_u = dev(mask_u), dev(val_u)
        self.has_p_bcs = bool(p_bcs)
        if self.has_p_bcs:
            mask_p, val_p = combine_bcs(Q, p_bcs)
            self.mask_p, self.val_p = dev(mask_p), dev(val_p)
        else:
            self.mask_p = torch.zeros(Q.n_dofs, dtype=dtype, device=device)
            self.val_p = self.mask_p
        self.ones_Q = torch.ones(Q.n_dofs, dtype=dtype, device=device)

        md = assembly.mass_diag(V, geomg)
        sd = assembly.stiffness_diag(V, geomg)
        self.mass_diag_V = dev(np.repeat(md[:, None], 2, 1))
        self.stiff_diag_V = dev(np.repeat(sd[:, None], 2, 1))
        self.stiff_diag_Q = dev(assembly.stiffness_diag(Q, geomg))

        # boundary terms: replicated, each rank adds 1/ndev of them
        self.bnd = make_boundary_arrays(V, Q, rule_degree=5, dtype=dtype, device=device)

        self.rho = float(rho)
        self.mu = float(mu)
        self.rotational = rotational_form
        if time_step_method == "forward euler":
            self.theta = (1.0, 0.0)
        elif time_step_method == "backward euler":
            self.theta = (0.0, 1.0)
        elif time_step_method == "crank-nicolson":
            self.theta = (0.5, 0.5)
        else:
            raise ValueError(f"ShardedProjection: unknown time_step_method "
                             f"{time_step_method!r}")
        self.newton_tol = newton_tol
        self.newton_maxiter = newton_maxiter
        self.linear_rtol = linear_rtol
        self.pressure_rtol = pressure_rtol
        self.nV, self.nQ = V.n_dofs, Q.n_dofs
        self.with_force = with_force
        self.force_rule = force_rule

    def pack_force(self, Fq_cells):
        """Per-cell force quadrature values [n_cells, nq, ncomp] -> this
        rank's cells'."""
        a = np.asarray(Fq_cells)[self._cells]
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    def _psum(self, x):
        return comm.all_reduce_sum(x, self.group)

    def __call__(self, U, Pv, dt, Fq=None):
        if self.with_force and Fq is None:
            raise ValueError("ShardedProjection: constructed with with_force=True")
        dt = torch.as_tensor(dt, dtype=self.dtype, device=self.device)
        return self._step(U, Pv, dt, Fq if self.with_force else None)

    step = __call__

    def _step(self, U, Pv, dt, Fq):
        Vl, Ql, gl = self.Vl, self.Ql, self.geom
        rho, mu = self.rho, self.mu
        inv_ndev = 1.0 / self.ndev
        psum = self._psum
        mask_u, val_u = self.mask_u, self.val_u
        free_u = 1.0 - mask_u
        U0loc = Vl.gather(U)
        Ploc0 = Ql.gather(Pv)

        def rhs_weak_loc(Wloc):
            loc = -rho * forms.skew_convection_combined_loc(Vl, gl, Wloc, rule_degree=5)
            loc = loc - forms.sym_grad_loc(Vl, gl, Wloc, mu)
            loc = loc + forms.pressure_grad_loc(Vl, Ql, gl, Ploc0)
            if Fq is not None:
                loc = loc + forms.body_force_loc(Vl, gl, Fq, rule_degree=self.force_rule)
            return loc

        w_ex, w_im = self.theta

        def residual_part(x):
            """This rank's part of the residual (before the all_reduce)."""
            xloc = Vl.gather(x)
            loc = forms.mass_loc(Vl, gl, xloc - U0loc)
            if w_ex:
                loc = loc - (dt / rho) * w_ex * rhs_weak_loc(U0loc)
            if w_im:
                loc = loc - (dt / rho) * w_im * rhs_weak_loc(xloc)
            r = Vl.dof_sum(loc)
            bnd = None
            if w_ex:
                bnd = (dt / rho) * w_ex * self._boundary_terms(U, Pv)
            if w_im:
                b = (dt / rho) * w_im * self._boundary_terms(x, Pv)
                bnd = b if bnd is None else bnd + b
            if bnd is not None:
                r = r - inv_ndev * bnd
            return r

        def residual(x):
            return free_u * psum(residual_part(x)) + mask_u * (x - val_u)

        diag = self.mass_diag_V + (dt / rho) * w_im * (2.0 * mu) * self.stiff_diag_V
        diag = free_u * diag + mask_u
        x = free_u * U + mask_u * val_u
        r = residual(x)
        rnorm = torch.sqrt(torch.sum(r * r))
        k = 0
        while bool(rnorm > self.newton_tol) and k < self.newton_maxiter:
            x_lin = x

            def Jv(v, x_lin=x_lin):
                t = torch.func.jvp(residual_part, (x_lin,), (v,))[1]
                return free_u * psum(t) + mask_u * v

            dx, _ = krylov.bicgstab(Jv, -r, M=lambda t: t / diag,
                                    rtol=self.linear_rtol, atol=0.05 * self.newton_tol,
                                    maxiter=300)
            x = x + dx
            r = residual(x)
            rnorm = torch.sqrt(torch.sum(r * r))
            k += 1
        Ui = x

        # pressure Poisson, increment form (the JAX package's default)
        def K(p):
            return psum(assembly.stiffness_apply(Ql, gl, p))

        L2 = -(rho / dt) * forms.div_rhs(Vl, Ql, gl, Ui)
        if self.rotational:
            L2 = L2 - mu * forms.grad_div_ustar_rhs(Vl, Ql, gl, Ui)
        L2 = psum(L2)
        diag_Q = torch.where(self.stiff_diag_Q > 0, self.stiff_diag_Q,
                             torch.ones_like(self.stiff_diag_Q))
        if not self.has_p_bcs:
            phi, _ = krylov.cg(K, L2, M=lambda r: r / diag_Q, rtol=self.pressure_rtol,
                               maxiter=1000, nullspace=[self.ones_Q])
        else:
            mask_p = self.mask_p
            free_p = 1.0 - mask_p

            def K_bc(p):
                return free_p * K(free_p * p) + mask_p * p

            pin = mask_p * (self.val_p - Pv)
            rhs = free_p * (L2 - K(pin)) + pin
            phi, _ = krylov.cg(K_bc, rhs, M=lambda r: r / (free_p * diag_Q + mask_p),
                               rtol=self.pressure_rtol, maxiter=1000)
        P1 = Pv + phi

        # velocity correction, increment form
        div_part = mu * forms.grad_div_ustar(Vl, gl, Ui) if self.rotational else None
        gphi = (dt / rho) * forms.grad_phi_rhs(Vl, Ql, gl, phi, div_part=div_part,
                                                 rule_degree=4)

        def M_bc(u):
            y = psum(assembly.mass_apply(Vl, gl, free_u * u))
            return free_u * y + mask_u * u

        diag_m = free_u * self.mass_diag_V + mask_u
        L3 = psum(-gphi)
        dmask = mask_u * (val_u - Ui)
        rhs = free_u * (L3 - psum(assembly.mass_apply(Vl, gl, dmask))) + dmask
        d, _ = krylov.cg(M_bc, rhs, M=lambda r: r / diag_m, rtol=1.0e-10, maxiter=500)
        return Ui + d, P1, Ui

    def _boundary_terms(self, W, P0):
        """-int p0 n.v ds + mu int (grad w)^T n.v ds over every boundary
        facet (replicated; the caller scales it by 1/ndev)."""
        b = self.bnd
        Wb = W[b.cdV]
        gw = torch.einsum("bqlk,bdk,blm->bqmd", b.dphiV, b.Gb, Wb)
        pq = torch.einsum("bql,bl->bq", b.phiQ, P0[b.cdQ])
        val = -pq[:, :, None] * b.normals[:, None, :]
        val = val + self.mu * torch.einsum("bqmd,bm->bqd", gw.transpose(2, 3), b.normals)
        loc = torch.einsum("bqm,bq,bqi->bim", val, b.wl, b.phiV)
        out = loc.new_zeros((self.nV, 2))
        return out.index_add_(0, b.cdV.reshape(-1), loc.reshape(-1, 2))
