# Projection, interpolation and norms. Port of flow_tpu/fem/interpolate.py.
#
# Everything runs on the space's mesh device in its dtype. project's mass
# solve sums its element contributions with fem/gathersum.GatherSum (a
# fixed order), so a projection repeats bitwise from run to run on the
# card. The JAX package runs projection on its host CPU backend
# (utils/hostsetup.setup_on_cpu); the port has no such split.
from __future__ import annotations

import torch

from . import assembly
from .gathersum import gather_sum_of
from .spaces import Function, FunctionSpace
from ..solvers import krylov

__all__ = ["project", "interpolate", "errornorm", "norm", "eval_callable"]


def eval_callable(f, x):
    """Evaluate a user field at physical points x [..., dim] (a tensor).

    f may be: a callable f(x) -> values [...] or [..., m]; a scalar; a
    tuple/list of per-component callables or scalars.
    """
    if isinstance(f, (tuple, list)):
        comps = [eval_callable(fi, x) for fi in f]
        return torch.stack([torch.broadcast_to(torch.as_tensor(c, dtype=x.dtype,
                                                               device=x.device),
                                               x.shape[:-1]) for c in comps], dim=-1)
    if callable(f):
        return f(x)
    return torch.full(x.shape[:-1], float(f), dtype=x.dtype, device=x.device)


def interpolate(f, space: FunctionSpace) -> Function:
    """Nodal interpolation: evaluate f at the dof points."""
    mesh = space.mesh
    x = torch.as_tensor(space.dof_points_np, dtype=mesh.dtype, device=mesh.device)
    return Function(space, eval_callable(f, x))


def _qp_points(space, tab):
    """Physical quadrature points [nc, nq, dim] of `tab`'s rule on the
    space's mesh, as a tensor on its device."""
    mesh = space.mesh
    xq = assembly.geometry(mesh).physical_points(tab.ref_pts)
    return torch.as_tensor(xq, dtype=mesh.dtype, device=mesh.device)


def _values_of(u, tab_of):
    """A Function's values at the quadrature points of tab_of(space)."""
    t = tab_of(u.space).on(u.vector.dtype, u.vector.device)
    return assembly.values_at_qp(t, u.space.gather(u.vector))


def project(f, space: FunctionSpace, rtol=1e-14, maxiter=2000) -> Function:
    """L2 projection: solve M x = (f, phi_i) by Jacobi-preconditioned CG."""
    mesh = space.mesh
    dtype, device = mesh.dtype, mesh.device
    geom = assembly.geometry_on(mesh, dtype, device)
    rule = 2 * space.degree + 2
    tab = assembly.tabulation(space, rule)
    t = tab.on(dtype, device)
    if isinstance(f, Function):
        fq = _values_of(f, lambda s: assembly.tabulation(s, rule))
    else:
        fq = eval_callable(f, _qp_points(space, tab))
    gsum = gather_sum_of(space, device)
    wd = t.w[None, :] * geom.detJ[:, None]
    if fq.dim() == 2:
        b = gsum(torch.einsum("eq,qi->ei", wd * fq, t.phi))
    else:
        b = gsum(torch.einsum("eqm,eq,qi->eim", fq, wd, t.phi))

    diag = torch.as_tensor(assembly.mass_diag(space, assembly.geometry(mesh)),
                           dtype=dtype, device=device)
    if space.n_components > 1:
        diag = diag[:, None]
    Mref = torch.as_tensor(assembly.ref_mass(space.degree, assembly._dim(space)),
                           dtype=dtype, device=device)

    def A(x):
        eq = "ij,ej,e->ei" if x.dim() == 1 else "ij,ejm,e->eim"
        return gsum(torch.einsum(eq, Mref, space.gather(x), geom.detJ))

    x, _ = krylov.cg(A, b, M=lambda r: r / diag, rtol=rtol, maxiter=maxiter)
    return Function(space, x)


def errornorm(exact, uh: Function, norm_type="L2", rule_degree=6):
    """|| exact - uh ||_{L2(Omega)} by high-order quadrature; `exact` is a
    callable (or tuple of callables) of the physical quadrature points."""
    assert norm_type == "L2"
    space = uh.space
    v = uh.vector
    geom = assembly.geometry_on(space.mesh, v.dtype, v.device)
    tab = assembly.tabulation(space, rule_degree)
    t = tab.on(v.dtype, v.device)
    xq = _qp_points(space, tab).to(v.dtype)
    diff = eval_callable(exact, xq) - assembly.values_at_qp(t, space.gather(v))
    sq = torch.sum(diff * diff, dim=-1) if diff.dim() == 3 else diff * diff
    return float(torch.sqrt(torch.einsum("eq,q,e->", sq, t.w, geom.detJ)))


def norm(u, norm_type="L2", rule_degree=6):
    """norm(u, 'L2'): the L2 function norm of a Function (the l2 norm of a
    raw dof vector); norm(v, 'linf'): the max-abs of a dof vector."""
    if norm_type == "linf":
        v = u.vector if isinstance(u, Function) else u
        return float(torch.max(torch.abs(v)))
    assert norm_type in ("L2", "l2")
    if not isinstance(u, Function):
        return float(torch.sqrt(torch.sum(u * u)))
    space, v = u.space, u.vector
    geom = assembly.geometry_on(space.mesh, v.dtype, v.device)
    t = assembly.tabulation(space, rule_degree).on(v.dtype, v.device)
    uq = assembly.values_at_qp(t, space.gather(v))
    sq = torch.sum(uq * uq, dim=-1) if uq.dim() == 3 else uq * uq
    return float(torch.sqrt(torch.einsum("eq,q,e->", sq, t.w, geom.detJ)))
