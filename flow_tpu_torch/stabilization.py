# SUPG stabilization for convection-dominated transport. Port of
# flow_tpu/stabilization.py: per quadrature point
#     tau = h^2 / (4 eps p) * xi(Pe),  Pe = ||b|| h / (2 p eps),
# with h the cell diameter along the convection b,
#     h = 4 ||b|| area / sum_edges |e x b|          (triangles),
#     h = 2 ||b|| / sum_i |b . grad(psi_i)|         (tets, P1 vertex basis),
# and xi(Pe) = (1/tanh(Pe) - 1/Pe)/Pe, Taylor-expanded for small Pe.
# Branch-free over all cells and quadrature points, on b's device.
from __future__ import annotations

import numpy as np
import torch

__all__ = ["supg", "supg_tau", "check_tau"]


def check_tau(tau, limit=1.0e3):
    """Raise if any tau exceeds `limit` (the reference's sanity guard)."""
    tmax = float(torch.max(tau))
    if tmax > limit:
        raise RuntimeError(
            f"SUPG tau sanity check failed: max tau = {tmax:.3e} > {limit:.0e}"
        )
    return tau


def _tau(bnorm, h, eps, element_degree):
    pe = 0.5 * bnorm * h / (element_degree * eps)
    big = pe > 1.0e-5
    pe_safe = torch.where(big, pe, torch.ones_like(pe))
    xi_full = (1.0 / torch.tanh(pe_safe) - 1.0 / pe_safe) / pe_safe
    xi_taylor = 1.0 / 3.0 - pe**2 / 45.0 + 2.0 / 945.0 * pe**4
    xi = torch.where(big, xi_full, xi_taylor)
    tau = h * h / (4.0 * eps * element_degree) * xi
    return torch.where(bnorm < 1.0e-10, torch.zeros_like(tau), tau)


def supg_tau(mesh, conv_at_qp, diffusion, element_degree):
    """tau [nc, nq] from the convection at the quadrature points,
    conv_at_qp [nc, nq, dim] (a tensor)."""
    b = conv_at_qp
    if getattr(mesh, "dim", 2) == 3:
        return _supg_tau_3d(mesh, b, diffusion, element_degree)
    p = torch.as_tensor(mesh.points_np, dtype=b.dtype, device=b.device)
    c = torch.as_tensor(mesh.cells_np.astype(np.int64), device=b.device)
    # the three edges (i<j vertex pairs)
    e01 = p[c[:, 0]] - p[c[:, 1]]
    e02 = p[c[:, 0]] - p[c[:, 2]]
    e12 = p[c[:, 1]] - p[c[:, 2]]
    d0 = p[c[:, 1]] - p[c[:, 0]]
    d1 = p[c[:, 2]] - p[c[:, 0]]
    area = 0.5 * (d0[:, 0] * d1[:, 1] - d0[:, 1] * d1[:, 0])

    bnorm = torch.sqrt(b[..., 0] ** 2 + b[..., 1] ** 2)  # [nc, nq]

    def cross(e):
        return torch.abs(e[:, None, 1] * b[..., 0] - e[:, None, 0] * b[..., 1])

    s = cross(e01) + cross(e02) + cross(e12)
    s = torch.where(s == 0, torch.ones_like(s), s)
    h = 4.0 * bnorm * area[:, None] / s
    return _tau(bnorm, h, diffusion, element_degree)


def _supg_tau_3d(mesh, b, diffusion, element_degree):
    from .fem.assembly import geometry

    G = torch.as_tensor(geometry(mesh).G, dtype=b.dtype, device=b.device)
    # P1 reference gradients dlam [4, 3]; grad psi_i = G dlam_i
    dlam = torch.as_tensor(
        np.concatenate([-np.ones((1, 3)), np.eye(3)], axis=0),
        dtype=b.dtype, device=b.device,
    )
    gpsi = torch.einsum("edk,ik->eid", G, dlam)  # [nc, 4, 3]
    bnorm = torch.sqrt(torch.sum(b * b, dim=-1))
    s = torch.sum(torch.abs(torch.einsum("eqd,eid->eqi", b, gpsi)), dim=-1)
    s = torch.where(s == 0, torch.ones_like(s), s)
    h = 2.0 * bnorm / s
    return _tau(bnorm, h, diffusion, element_degree)


def supg(mesh, convection, diffusion, element_degree):
    """A callable tau(conv_at_qp) for callers that already have the
    convection at the quadrature points (heat.Heat calls supg_tau)."""

    def tau(conv_at_qp):
        return supg_tau(mesh, conv_at_qp, diffusion, element_degree)

    return tau
