# Variationally consistent force evaluation on a boundary dof set. Port of
# flow_tpu/navier_stokes/forces.py::ConsistentForceProbe.
#
# Instead of integrating the boundary traction sigma(u, p).n (whose float32
# evaluation cancels catastrophically at small velocities), test the
# momentum residual against the discrete field w_d that is the unit vector
# e_d at every body dof and zero elsewhere:
#
#   F_d = (rho (du/dt + (u.grad)u), w_d) + (sigma(u,p), grad w_d) - (f, w_d)
#
# which equals the traction integral for the exact solution and is
# superconvergent for the discrete one. Everything is evaluated on the
# O(surface) layer of cells touching a body dof: torch einsums over a few
# hundred cells, on the state's device.
from __future__ import annotations

import numpy as np
import torch

from ..fem.assembly import geometry, tabulation

__all__ = ["ConsistentForceProbe"]


class ConsistentForceProbe:
    """Callable (U1, P1, U0, dt) -> [dim] force vector on the body whose
    dofs are selected by `where` (a predicate over dof coordinates, as
    FunctionSpace.boundary_dofs takes). Tables in `dtype` on `device`
    (defaults: the mesh's).

    needs_history = True: the stepper passes the previous state and step so
    the rho du/dt term uses the scheme's own time-derivative stencil (for
    BDF2 it receives (u_hat, dt_eff), exactly the BDF2 derivative).
    """

    needs_history = True

    def __init__(self, V, Q, where, rho, mu, rule_degree=5, dtype=None,
                 device=None):
        self.rho, self.mu = float(rho), float(mu)
        mesh = V.mesh
        self.dim = getattr(mesh, "dim", 2)
        dtype = mesh.dtype if dtype is None else dtype
        device = mesh.device if device is None else torch.device(device)

        body = np.zeros(V.n_dofs, dtype=bool)
        body[V.boundary_dofs(where)] = True
        # the O(surface) support layer: cells touching any body dof
        cells = np.where(body[V.cell_dofs_np].any(axis=1))[0]
        assert len(cells) > 0, "no cells touch the body dof set"

        def dev(a, dt=dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)

        self.cell_dofs_V = dev(V.cell_dofs_np[cells], torch.int64)  # [ns, nlv]
        self.cell_dofs_Q = dev(Q.cell_dofs_np[cells], torch.int64)  # [ns, nlq]
        # w mask at the V local dofs of the subset cells [ns, nlv]
        self.wmask = dev(body[V.cell_dofs_np[cells]].astype(np.float64))
        geom = geometry(mesh)
        self.detJ = dev(geom.detJ[cells])
        self.G = dev(geom.G[cells])  # [ns, dim, dim]
        tv = tabulation(V, rule_degree).on(dtype, device)
        self.phiV, self.dphiV = tv.phi, tv.dphi  # [nq, nlv], [nq, nlv, dim]
        self.phiQ = tabulation(Q, rule_degree).on(dtype, device).phi
        self.wq = tv.w  # the same rule for both tabulations

    def __call__(self, U1, P1, U0=None, dt=None):
        """Force vector [dim]. U0/dt give the rho du/dt term (omit for the
        steady functional). Body forces are zero on this path."""
        phiV, dphiV = self.phiV, self.dphiV
        Uloc = U1[self.cell_dofs_V]  # [ns, nlv, m]
        Ploc = P1[self.cell_dofs_Q]  # [ns, nlq]

        # values and physical gradients at the quadrature points
        uq = torch.einsum("ql,slm->sqm", phiV, Uloc)
        gq = torch.einsum("qlk,sdk,slm->sqmd", dphiV, self.G, Uloc)
        pq = torch.einsum("ql,sl->sq", self.phiQ, Ploc)
        # physical test-function gradients dphi_i/dx_d [s, q, i, d]
        gphi = torch.einsum("qlk,sdk->sqld", dphiV, self.G)
        wd = self.wq[None, :] * self.detJ[:, None]  # [s, q]

        # material acceleration rho (du/dt + (u.grad)u) [s, q, m]
        acc = torch.einsum("sqmd,sqd->sqm", gq, uq)
        if U0 is not None:
            u0q = torch.einsum("ql,slm->sqm", phiV, U0[self.cell_dofs_V])
            acc = acc + (uq - u0q) / dt
        loc = self.rho * torch.einsum("sqm,sq,qi->sim", acc, wd, phiV)
        # (mu (grad u + grad u^T), grad(phi_i e_d))
        sig = self.mu * (gq + gq.transpose(2, 3))  # [s, q, m, d]
        loc = loc + torch.einsum("sqmk,sq,sqik->sim", sig, wd, gphi)
        # -(p, div(phi_i e_d)) = -p dphi_i/dx_d
        loc = loc - torch.einsum("sq,sq,sqid->sid", pq, wd, gphi)
        # contract with the body mask (the w_d test field). The functional
        # is the traction integral with the fluid-outward normal; the force
        # on the body (body-outward normal) is its negative.
        return -torch.einsum("sim,si->m", loc, self.wmask)
