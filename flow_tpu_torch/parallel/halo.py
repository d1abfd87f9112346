# The P1 Poisson solve over dof-partitioned vectors with a halo exchange
# between ring neighbours. Port of flow_tpu/parallel/halo.py (HaloPoisson).
#
# Cells are sorted by centroid x into one strip a rank; a dof belongs to the
# lowest rank among its cells' and the dofs are renumbered owner by owner
# (halo_step.HaloSpace: the JAX package's partition, which its HaloPoisson
# computes for itself). Each rank holds its owned dofs; an operator apply
# sends the strip-edge values its neighbours' cells touch (one
# ring_exchange: the JAX package's two ppermutes), assembles over its own
# cells into the extended vector [owned | ghosts from the left | ghosts
# from the right | 0], and returns the ghosts' partial sums to their owners
# (a second exchange). Krylov inner products are all_reduces.
from __future__ import annotations

import torch
import torch.distributed as dist

from ..fem.assembly import geometry, ref_stiffness
from ..fem.gathersum import GatherSum
from ..fem.spaces import FunctionSpace
from . import comm
from .halo_step import HaloSpace, _bwd, _fwd, _strips

__all__ = ["HaloPoisson"]


class HaloPoisson:
    """Distributed K p = b (P1 stiffness, pure Neumann or with a Dirichlet
    mask) over the ranks of `group` (default: the world), on `device`
    (default cuda:<local rank>; "cpu" with a gloo group).

    solve(b, rtol, maxiter) -> (x, iters): b and x are global vectors (the
    same on every rank; the partitioned layout lives inside)."""

    def __init__(self, mesh, bc_mask=None, group=None, device=None):
        self.group = group
        self.device = device = comm.resolve_device(device, group)
        self.ndev = ndev = dist.get_world_size(group)
        rank = dist.get_rank(group)
        self.space = space = FunctionSpace(mesh, 1)
        self.dtype = dtype = mesh.dtype
        self.hs = hs = HaloSpace(space, *_strips(mesh, ndev), ndev, rank, group, device)
        self._sum = GatherSum(hs.cell_dofs_ext_np, hs.n_ext, device)
        self.C = torch.as_tensor(geometry(mesh).C[hs.cells], dtype=dtype, device=device)
        self.valid = torch.as_tensor(hs.valid_np, dtype=dtype, device=device)
        self.neumann = bc_mask is None
        self.mask = torch.zeros(hs.n_loc, dtype=dtype, device=device)
        if bc_mask is not None:
            self.mask = hs.to_partitioned(torch.as_tensor(bc_mask).to(device, dtype))
        self.Kref = torch.as_tensor(ref_stiffness(1), dtype=dtype, device=device)
        self.maxiter = 2000

    def _halo_apply(self, x):
        """y = K x with the halo exchange; x [n_loc] on every rank."""
        hs = self.hs
        x_ext = _fwd(x, hs, self.group)
        loc = torch.einsum("ekl,klij,ej->ei", self.C, self.Kref, x_ext[hs.cell_dofs_ext])
        return _bwd(self._sum(loc), hs, self.group)

    def _solve_local(self, b, rtol):
        valid, mask = self.valid, self.mask
        free = (1.0 - mask) * valid

        def psum(v):
            return comm.all_reduce_sum(v, self.group)

        def K_bc(x):
            return free * self._halo_apply(free * x) + mask * x

        def dot(a, bb):
            return psum(torch.sum(a * bb))

        if self.neumann:
            nglobal = psum(torch.sum(valid))

            def proj(x):
                return (x - psum(torch.sum(x * valid)) / nglobal) * valid
        else:
            def proj(x):
                return x

        b = proj(free * b)
        # the diagonal of K: per-cell diagonals, the ghosts' partial sums
        # returned to their owners by the same exchange as the operator's
        Kd = torch.einsum("klii->kli", self.Kref)
        diag = _bwd(self._sum(torch.einsum("ekl,kli->ei", self.C, Kd)), self.hs, self.group)
        diag = torch.where(diag > 0, diag, torch.ones_like(diag))
        diag = free * diag + mask + (1.0 - valid)

        x = torch.zeros_like(b)
        r = b
        z = proj(r / diag)
        p = z
        rz = dot(r, z)
        target = rtol * torch.sqrt(dot(b, b))
        rn = torch.sqrt(dot(r, r))
        k = 0
        while bool(rn > target) and k < self.maxiter:
            Ap = proj(K_bc(p))
            alpha = rz / dot(p, Ap)
            x = x + alpha * p
            r = r - alpha * Ap
            z = proj(r / diag)
            rz_new = dot(r, z)
            beta = rz_new / rz
            p = z + beta * p
            rz = rz_new
            rn = torch.sqrt(dot(r, r))
            k += 1
        return x, k

    def solve(self, b_global, rtol=1e-10, maxiter=2000):
        self.maxiter = maxiter
        xp, iters = self._solve_local(
            self.hs.to_partitioned(torch.as_tensor(b_global).to(self.device, self.dtype)),
            torch.as_tensor(rtol, dtype=self.dtype))
        return self.hs.from_partitioned(xp), iters
