# Assembly primitives. Port of flow_tpu/fem/assembly.py, cut to what the
# 3-D box path calls. Every caller is setup code (diagonal preconditioners,
# the stencil probe, boundary rows, the coarse dense matrix), so everything
# here is host numpy in float64; callers cast and move the results to their
# device once.
#
# Per-element geometry is two tiny tensors: detJ [nc] and G = J^{-T}
# [nc,3,3]; constant-coefficient forms use exact factored reference tensors.
from __future__ import annotations

from functools import lru_cache

import numpy as np

from . import elements, quadrature
from .spaces import FunctionSpace

# quadrature degree for the trilinear convection terms
CONV_RULE = 5

__all__ = [
    "CONV_RULE",
    "Geometry",
    "geometry",
    "ref_mass",
    "ref_stiffness",
    "ref_mixed",
    "stiffness_apply",
    "mass_diag",
    "stiffness_diag",
    "stiffness_local",
]


class Geometry:
    """Per-element affine geometry of a tet mesh: detJ [nc], G = J^{-T}
    [nc,3,3] (grad_phys[d] = G[d,k] grad_ref[k]) and the exact stiffness
    factor C = detJ * G^T G."""

    def __init__(self, mesh):
        p = mesh.points_np
        c = mesh.cells_np
        # edge vectors J columns: dvec[:, :, k] = p_{k+1} - p_0
        dvecs = np.stack(
            [p[c[:, k + 1]] - p[c[:, 0]] for k in range(3)], axis=-1
        )  # [nc, dim(space), dim(ref)]
        d0, d1, d2 = dvecs[:, :, 0], dvecs[:, :, 1], dvecs[:, :, 2]
        c0 = np.cross(d1, d2)
        c1 = np.cross(d2, d0)
        c2 = np.cross(d0, d1)
        detJ = np.einsum("ed,ed->e", d0, c0)
        # J^{-T} columns are the cross products / det
        inv = np.stack([c0, c1, c2], axis=-1) / detJ[:, None, None]
        self.detJ = detJ
        self.G = inv
        self.C = np.einsum("edk,edl->ekl", inv, inv) * detJ[:, None, None]


def geometry(mesh) -> Geometry:
    # cached on the mesh itself
    if not hasattr(mesh, "_geom_cache"):
        mesh._geom_cache = Geometry(mesh)
    return mesh._geom_cache


def _dim(space):
    return getattr(space.mesh, "dim", 2)


# ---------------------------------------------------------------------------
# Exact reference tensors (small numpy, computed once)
# ---------------------------------------------------------------------------
@lru_cache(maxsize=None)
def ref_mass(degree, dim=2):
    """Mref[i,j] = int_ref phi_i phi_j (exact)."""
    pts, w = quadrature.simplex_rule(2 * degree, dim)
    phi, _ = elements.tabulate(degree, pts, dim=dim)
    return np.einsum("q,qi,qj->ij", w, phi, phi)


@lru_cache(maxsize=None)
def ref_stiffness(degree, dim=2):
    """Kref[k,l,i,j] = int_ref d_k phi_i d_l phi_j (exact)."""
    pts, w = quadrature.simplex_rule(max(1, 2 * (degree - 1)), dim)
    _, dphi = elements.tabulate(degree, pts, dim=dim)
    return np.einsum("q,qik,qjl->klij", w, dphi, dphi)


@lru_cache(maxsize=None)
def ref_mixed(deg_test, deg_trial, dim=2):
    """Bref[k,i,j] = int_ref phi^test_i d_k phi^trial_j (exact).

    Used for div/grad coupling between velocity (P2) and pressure (P1)."""
    pts, w = quadrature.simplex_rule(deg_test + deg_trial, dim)
    phi_t, _ = elements.tabulate(deg_test, pts, dim=dim)
    _, dphi_u = elements.tabulate(deg_trial, pts, dim=dim)
    return np.einsum("q,qi,qjk->kij", w, phi_t, dphi_u)


# ---------------------------------------------------------------------------
# Exact constant-coefficient operators (applies + diagonals), host numpy
# ---------------------------------------------------------------------------
def stiffness_apply(space: FunctionSpace, geom: Geometry, U):
    """y = K U with K_ij = int grad(phi_i).grad(phi_j)."""
    Kref = ref_stiffness(space.degree, _dim(space))
    Uloc = space.gather(np.asarray(U, dtype=np.float64))
    if Uloc.ndim == 2:
        loc = np.einsum("ekl,klij,ej->ei", geom.C, Kref, Uloc)
    else:
        loc = np.einsum("ekl,klij,ejm->eim", geom.C, Kref, Uloc)
    return space.dof_sum(loc)


def mass_diag(space, geom):
    Mref = np.diag(ref_mass(space.degree, _dim(space)))
    return space.dof_sum(Mref[None, :] * geom.detJ[:, None])


def stiffness_diag(space, geom):
    Kd = np.einsum("klii->kli", ref_stiffness(space.degree, _dim(space)))
    return space.dof_sum(np.einsum("ekl,kli->ei", geom.C, Kd))


def stiffness_local(space, geom):
    """Explicit element stiffness matrices [nc, nl, nl]."""
    Kref = ref_stiffness(space.degree, _dim(space))
    return np.einsum("ekl,klij->eij", geom.C, Kref)
