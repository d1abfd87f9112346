# Weak-form operators of the incompressible-flow forms. Port of
# flow_tpu/fem/forms.py, cut to what FastStepper's window and einsum routes
# (2-D Karman, 3-D cavity), the packed-patch route (fem/patchpack.py:
# ref_p1_integrals; its tests: sym_grad_apply, pressure_grad_rhs), the
# public schemes (navier_stokes/pressure_correction.py: the full skew
# convection and the body force), steady Stokes (vector_laplacian_apply)
# and AB2TR (skew_convection_combined_rhs) call; every form takes triangles
# and tets alike.
#
# Torch on the state's device: `geom` is an assembly.geometry_on view
# (detJ, G, C tensors), tabulations come from assembly.Tab.on. Vector fields
# are [n_dofs, dim]; scalar fields [n_dofs]. Constant-coefficient forms use
# exact factored reference tensors; coefficient-dependent forms evaluate at
# quadrature points.
from __future__ import annotations

import numpy as np
import torch

from . import assembly, elements, quadrature
from .assembly import ref_mixed, ref_stiffness

__all__ = [
    "vector_laplacian_apply",
    "skew_convection_combined_rhs",
    "mass_loc",
    "sym_grad_loc",
    "pressure_grad_loc",
    "skew_convection_combined_loc",
    "skew_convection_lagged_loc",
    "body_force_loc",
    "skew_convection_tangent_loc",
    "stiffness_scalar_loc",
    "sym_grad_transpose_loc",
    "conv_lagged_jacobian_loc",
    "div_rhs",
    "grad_div_ustar",
    "grad_div_ustar_rhs",
    "grad_phi_rhs",
    "sym_grad_apply",
    "pressure_grad_rhs",
    "ref_p1_integrals",
]

_CONST = {}


def _const(key, make, like):
    """Device copy of a small host reference tensor, cached per
    (key, dtype, device)."""
    k = (key, like.dtype, like.device)
    t = _CONST.get(k)
    if t is None:
        t = torch.as_tensor(np.asarray(make()), dtype=like.dtype,
                            device=like.device)
        _CONST[k] = t
    return t


def _dim(V):
    return assembly._dim(V)


def _Mref(V, like):
    return _const(("mass", V.degree, _dim(V)),
                  lambda: assembly.ref_mass(V.degree, _dim(V)), like)


def _Kref(V, like):
    return _const(("stiff", V.degree, _dim(V)),
                  lambda: ref_stiffness(V.degree, _dim(V)), like)


def _Bref(V, Q, like):
    return _const(("mixed", Q.degree, V.degree, _dim(V)),
                  lambda: ref_mixed(Q.degree, V.degree, _dim(V)), like)


def vector_laplacian_apply(V, geom, U, coeff=None, dof_sum=None):
    """y[(i,a)] = int c grad(u_a) . grad(v_a): the component-wise stiffness,
    Stokes' full-gradient viscous term (c = coeff: None, a constant or
    per-cell [nc]). dof_sum: V.dof_sum unless given (a fem/gathersum table
    sums in a fixed order), as in div_rhs and pressure_grad_rhs."""
    loc = torch.einsum("ekl,klij,ejm->eim", assembly._scaled(geom.C, coeff),
                       _Kref(V, U), V.gather(U))
    return (dof_sum or V.dof_sum)(loc)


def skew_convection_combined_rhs(V, geom, U, rule_degree=5):
    """The skew convection of the velocity by itself, assembled:
    0.5 [((u.grad)u, v) - ((u.grad)v, u)] at the dof level."""
    return V.dof_sum(skew_convection_combined_loc(V, geom, V.gather(U), rule_degree))


def mass_loc(V, geom, Uloc):
    return torch.einsum("ij,ejm,e->eim", _Mref(V, Uloc), Uloc, geom.detJ)


def sym_grad_loc(V, geom, Uloc, mu):
    """2 mu eps(u):eps(v) local contributions [nc, nl, dim]."""
    Kref = _Kref(V, Uloc)
    loc = torch.einsum("ekl,klij,eja->eia", geom.C, Kref, Uloc)
    loc = loc + torch.einsum(
        "e,eak,ebl,klji,ejb->eia", geom.detJ, geom.G, geom.G, Kref, Uloc
    )
    return mu * loc


def pressure_grad_loc(V, Q, geom, Ploc):
    """int p d_a(v_i) local contributions [nc, nl, dim] (exact)."""
    return torch.einsum(
        "e,eak,kmi,em->eia", geom.detJ, geom.G, _Bref(V, Q, Ploc), Ploc
    )


def skew_convection_combined_loc(V, geom, Wloc, rule_degree=5):
    """The skew convection 0.5 [((w.grad)w, v) - ((w.grad)v, w)] of the
    velocity itself at the element level [nc, nl, dim]: the lagged form
    with the velocity as its own transport."""
    return skew_convection_lagged_loc(V, geom, Wloc, Wloc, rule_degree)


def body_force_loc(V, geom, Fq, rule_degree=6):
    """int f . v_i local contributions [nc, nl, dim] from the force at the
    quadrature points of the given rule, Fq [nc, nq, dim]."""
    tab = assembly.tabulation(V, rule_degree).on(Fq.dtype, Fq.device)
    wd = tab.w[None, :] * geom.detJ[:, None]
    return torch.einsum("eqm,eq,qi->eim", Fq, wd, tab.phi)


def skew_convection_lagged_loc(V, geom, Tloc, Uloc, rule_degree=5):
    """Skew convection with a fixed transport field T (linear in U):
    0.5 [((T.grad)u, v) - ((T.grad)v, u)] at the element level."""
    tab = assembly.tabulation(V, rule_degree).on(Uloc.dtype, Uloc.device)
    Tq = assembly.values_at_qp(tab, Tloc)  # [e,q,d]
    Uq = assembly.values_at_qp(tab, Uloc)  # [e,q,a]
    gradU = assembly.grads_at_qp(tab, geom, Uloc)  # [e,q,a,d]
    val = 0.5 * torch.einsum("eqd,eqad->eqa", Tq, gradU)
    grad = -0.5 * torch.einsum("eqd,eqa->eqad", Tq, Uq)
    wd = tab.w[None, :] * geom.detJ[:, None]
    loc = torch.einsum("eqm,eq,qi->eim", val, wd, tab.phi)
    loc = loc + torch.einsum("eqmd,eq,qik,edk->eim", grad, wd, tab.dphi, geom.G)
    return loc


def skew_convection_tangent_loc(V, geom, Vloc, Xq, gradX, rule_degree=5):
    """Directional derivative at x of the skew convection c(x; x) in the
    direction v: c(x; v) + c(v; x), from x's values Xq [nc, nq, dim] and
    physical gradients gradX [nc, nq, dim, dim] at the quadrature points
    (the tangent of the Newton residual's convection)."""
    tab = assembly.tabulation(V, rule_degree).on(Vloc.dtype, Vloc.device)
    Vq = assembly.values_at_qp(tab, Vloc)  # [e,q,a]
    gradV = assembly.grads_at_qp(tab, geom, Vloc)  # [e,q,a,d]
    val = 0.5 * (torch.einsum("eqd,eqad->eqa", Xq, gradV)
                 + torch.einsum("eqd,eqad->eqa", Vq, gradX))
    grad = -0.5 * (torch.einsum("eqd,eqa->eqad", Xq, Vq)
                   + torch.einsum("eqd,eqa->eqad", Vq, Xq))
    wd = tab.w[None, :] * geom.detJ[:, None]
    loc = torch.einsum("eqm,eq,qi->eim", val, wd, tab.phi)
    loc = loc + torch.einsum("eqmd,eq,qik,edk->eim", grad, wd, tab.dphi, geom.G)
    return loc


def stiffness_scalar_loc(V, geom):
    """The component-diagonal scalar element tensor of the stress form,
    Kscal[e, i, j] = C[e, k, l] Kref[k, l, i, j]: the grad(u):grad(v) half
    of 2 eps(u):eps(v) as a per-cell [nl, nl] matrix (exact, affine
    geometry), in geom's dtype on its device. The transpose half couples
    components and stays factored (sym_grad_transpose_loc)."""
    return torch.einsum("ekl,klij->eij", geom.C, _Kref(V, geom.C))


def sym_grad_transpose_loc(V, geom, Xloc):
    """loc[e,i,a] = detJ[e] G[e,a,k] G[e,b,l] Kref[k,l,j,i] X[e,j,b]: the
    component-coupling grad(u)^T:grad(v) half of the stress form, through
    its factored reference tensor."""
    w = torch.einsum("ebl,ejb->elj", geom.G, Xloc)
    u = torch.einsum("klji,elj->eki", _Kref(V, Xloc), w)
    return torch.einsum("e,eak,eki->eia", geom.detJ, geom.G, u)


def conv_lagged_jacobian_loc(V, geom, Tloc, rule_degree=5):
    """Element Jacobian of skew_convection_lagged_loc with respect to the
    velocity dofs at the transport T, frozen: the component-diagonal scalar
    [nc, nl, nl]

        J[e, i, j] = 0.5 int [ phi_i (T.grad phi_j) - phi_j (T.grad phi_i) ].
    """
    tab = assembly.tabulation(V, rule_degree).on(Tloc.dtype, Tloc.device)
    Tq = assembly.values_at_qp(tab, Tloc)  # [e,q,d]
    wd = tab.w[None, :] * geom.detJ[:, None]
    A = torch.einsum("eqd,qmk,edk->eqm", Tq, tab.dphi, geom.G)  # T.grad phi_m
    s = torch.einsum("eq,qi,eqj->eij", wd, tab.phi, A)
    return 0.5 * (s - s.transpose(1, 2))


def div_rhs(V, Q, geom, U, dof_sum=None):
    """b[m] = int div(u) q_m (exact; u in V=P2 vector, q in Q=P1); summed
    by dof_sum, Q.dof_sum unless given."""
    Uloc = V.gather(U)
    loc = torch.einsum(
        "e,ebk,kmj,ejb->em", geom.detJ, geom.G, _Bref(V, Q, U), Uloc
    )
    return (dof_sum or Q.dof_sum)(loc)


def grad_div_ustar(V, geom, U):
    """Per-element constant grad(div u*) [nc, dim] for P2 u*."""
    Href = _const(("hess", V.degree, _dim(V)),
                  lambda: elements.hessian_ref(V.degree, _dim(V)), U)
    Uloc = V.gather(U)
    return torch.einsum("eak,edl,jkl,eja->ed", geom.G, geom.G, Href, Uloc)


def grad_div_ustar_rhs(V, Q, geom, U):
    """b[m] = int grad(div u*) . grad(q_m) (exact; q in P1)."""
    dim = _dim(V)
    v = grad_div_ustar(V, geom, U)  # [e,dim]
    dref = _const(
        ("p1grad", Q.degree, dim),
        lambda: elements.tabulate(Q.degree, np.zeros((1, dim)), dim=dim)[1][0],
        U,
    )
    # grad q_m = G[d,k] dref[m,k]; simplex volume = detJ / dim!
    volfac = 0.5 if dim == 2 else (1.0 / 6.0)
    loc = volfac * torch.einsum("e,ed,edk,mk->em", geom.detJ, v, geom.G, dref)
    return Q.dof_sum(loc)


def grad_phi_rhs(V, Q, geom, phi, div_part=None, rule_degree=3):
    """b[(i,a)] = int grad(phi)_a v_i, phi in Q (P1), plus an optional
    per-element-constant gradient `div_part` [nc, dim]."""
    tab = assembly.tabulation(V, rule_degree).on(phi.dtype, phi.device)
    qtab = assembly.tabulation(Q, rule_degree).on(phi.dtype, phi.device)
    gphi = assembly.grads_at_qp(qtab, geom, Q.gather(phi))  # [e,q,dim]
    if div_part is not None:
        gphi = gphi + div_part[:, None, :]
    return assembly.integrate_rhs(V, tab, geom, val=gphi)


def sym_grad_apply(V, geom, U, mu):
    """y = 2 mu int eps(u):eps(v), the viscous part of the stress form:
    2 eps(u):eps(v) = grad(u):grad(v) + grad(u)^T:grad(v)."""
    return V.dof_sum(sym_grad_loc(V, geom, V.gather(U), mu))


def pressure_grad_rhs(V, Q, geom, P, dof_sum=None):
    """b[(i,a)] = int p d_a(v_i) (exact): the `+ p div(v)` part of the
    stress form and Stokes' B^T block; summed by dof_sum, V.dof_sum unless
    given."""
    return (dof_sum or V.dof_sum)(pressure_grad_loc(V, Q, geom, Q.gather(P)))


def ref_p1_integrals(degree, dim=2):
    """int_ref phi_i for the given degree (exact), host numpy."""
    pts, w = quadrature.simplex_rule(degree + 1, dim)
    phi, _ = elements.tabulate(degree, pts, dim=dim)
    return np.einsum("q,qi->i", w, phi)
