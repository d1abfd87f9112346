# Assembly primitives. Port of flow_tpu/fem/assembly.py, cut to what the
# 3-D box path, the window routes (2-D Karman, 3-D cavity) and the form
# compiler (fem/formlang.py) call.
#
# Setup (geometry, reference tensors, diagonals, element matrices) is host
# numpy in float64; callers cast and move the results to their device once.
# The per-step quadrature evaluations (values_at_qp, grads_at_qp,
# integrate_rhs, BoundaryTab, BoundaryFaceTab) are torch on the state's
# device, over device copies of the geometry (geometry_on) and of the
# tabulations (Tab.on) made once per (dtype, device).
#
# Per-element geometry is two tiny tensors: detJ [nc] and G = J^{-T}
# [nc,dim,dim]; constant-coefficient forms use exact factored reference
# tensors.
from __future__ import annotations

import copy
from functools import lru_cache
from types import SimpleNamespace

import numpy as np
import torch

from . import elements, quadrature
from .spaces import FunctionSpace

# quadrature degree for the trilinear convection terms
CONV_RULE = 5

__all__ = [
    "CONV_RULE",
    "Geometry",
    "geometry",
    "geometry_on",
    "Tab",
    "tabulation",
    "values_at_qp",
    "grads_at_qp",
    "integrate_rhs",
    "BoundaryTab",
    "BoundaryFaceTab",
    "ref_mass",
    "ref_stiffness",
    "ref_mixed",
    "stiffness_apply",
    "mass_apply",
    "mass_diag",
    "stiffness_diag",
    "stiffness_local",
]


class Geometry:
    """Per-element affine geometry of a triangle or tet mesh: detJ [nc],
    G = J^{-T} [nc,dim,dim] (grad_phys[d] = G[d,k] grad_ref[k]), the
    exact stiffness factor C = detJ * G^T G, and the affine map's origin
    cell_x0 [nc,dim] and columns dvecs [nc,dim,dim]. Host float64."""

    def __init__(self, mesh):
        p = mesh.points_np
        c = mesh.cells_np
        dim = getattr(mesh, "dim", 2)
        # edge vectors J columns: dvec[:, :, k] = p_{k+1} - p_0
        dvecs = np.stack(
            [p[c[:, k + 1]] - p[c[:, 0]] for k in range(dim)], axis=-1
        )  # [nc, dim(space), dim(ref)]
        if dim == 2:
            d0, d1 = dvecs[:, :, 0], dvecs[:, :, 1]
            detJ = d0[:, 0] * d1[:, 1] - d0[:, 1] * d1[:, 0]  # > 0 (CCW)
            inv = np.stack(
                [
                    np.stack([d1[:, 1], -d0[:, 1]], axis=-1),
                    np.stack([-d1[:, 0], d0[:, 0]], axis=-1),
                ],
                axis=-2,
            ) / detJ[:, None, None]
        else:
            d0, d1, d2 = dvecs[:, :, 0], dvecs[:, :, 1], dvecs[:, :, 2]
            c0 = np.cross(d1, d2)
            c1 = np.cross(d2, d0)
            c2 = np.cross(d0, d1)
            detJ = np.einsum("ed,ed->e", d0, c0)
            # J^{-T} columns are the cross products / det
            inv = np.stack([c0, c1, c2], axis=-1) / detJ[:, None, None]
        self.dim = dim
        self.detJ = detJ
        self.G = inv
        self.C = np.einsum("edk,edl->ekl", inv, inv) * detJ[:, None, None]
        self.cell_x0 = p[c[:, 0]]
        self.dvecs = dvecs

    def physical_points(self, ref_pts):
        """Map reference points [nq,dim] to physical [nc,nq,dim]."""
        r = np.asarray(ref_pts, dtype=np.float64)
        return self.cell_x0[:, None, :] + np.einsum("qk,edk->eqd", r, self.dvecs)


def geometry(mesh) -> Geometry:
    # cached on the mesh itself
    if not hasattr(mesh, "_geom_cache"):
        mesh._geom_cache = Geometry(mesh)
    return mesh._geom_cache


def geometry_on(mesh, dtype, device):
    """Device copy (detJ, G, C as tensors) of the mesh geometry, cached on
    the mesh per (dtype, device)."""
    cache = mesh.__dict__.setdefault("_geom_dev", {})
    key = (dtype, torch.device(device))
    g = cache.get(key)
    if g is None:
        host = geometry(mesh)
        g = SimpleNamespace(
            **{
                k: torch.as_tensor(getattr(host, k), dtype=dtype, device=device)
                for k in ("detJ", "G", "C")
            }
        )
        cache[key] = g
    return g


class Tab:
    """Tabulation of a basis at a quadrature rule (a degree, or
    quadrature.VERTEX): host float64 arrays (ref_pts, w, phi, dphi), and
    device copies of w, phi, dphi through on()."""

    def __init__(self, degree, rule_degree, dim=2):
        pts, w = quadrature.simplex_rule(rule_degree, dim)
        phi, dphi = elements.tabulate(degree, pts, dim=dim)
        self.ref_pts = np.asarray(pts, dtype=np.float64)
        self.w = np.asarray(w, dtype=np.float64)
        self.phi = np.asarray(phi, dtype=np.float64)
        self.dphi = np.asarray(dphi, dtype=np.float64)
        self.nq = len(w)
        self.nl = phi.shape[1]
        self._dev = {}

    def on(self, dtype, device):
        key = (dtype, torch.device(device))
        t = self._dev.get(key)
        if t is None:
            t = SimpleNamespace(
                **{
                    k: torch.as_tensor(getattr(self, k), dtype=dtype,
                                       device=device)
                    for k in ("w", "phi", "dphi")
                }
            )
            self._dev[key] = t
        return t


@lru_cache(maxsize=None)
def _tab_cached(degree, rule_degree, dim):
    return Tab(degree, rule_degree, dim=dim)


def tabulation(space, rule_degree) -> Tab:
    return _tab_cached(space.degree, rule_degree, _dim(space))


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
def _scaled(factor, coeff):
    """A per-cell geometry factor times coeff (None, a constant or per-cell
    [nc]), broadcast over the factor's trailing axes."""
    if coeff is None:
        return factor
    if isinstance(factor, torch.Tensor):
        coeff = torch.as_tensor(coeff, dtype=factor.dtype, device=factor.device)
        return factor * coeff.reshape(coeff.shape + (1,) * (factor.dim() - coeff.dim()))
    coeff = np.asarray(coeff, dtype=np.float64)
    return factor * coeff.reshape(coeff.shape + (1,) * (factor.ndim - coeff.ndim))


def stiffness_apply(space: FunctionSpace, geom: Geometry, U, coeff=None):
    """y = K U with K_ij = int c grad(phi_i).grad(phi_j), c = coeff (None:
    1, a constant or per-cell [nc]), for scalar U [n] or vector U [n, m]:
    host numpy, or torch on U's device for a tensor U (geom then a
    geometry_on view)."""
    Kref = ref_stiffness(space.degree, _dim(space))
    C = _scaled(geom.C, coeff)
    if isinstance(U, torch.Tensor):
        Kt = torch.as_tensor(Kref, dtype=U.dtype, device=U.device)
        eq = "ekl,klij,ej->ei" if U.dim() == 1 else "ekl,klij,ejm->eim"
        return space.dof_sum(torch.einsum(eq, C, Kt, space.gather(U)))
    Uloc = space.gather(np.asarray(U, dtype=np.float64))
    if Uloc.ndim == 2:
        loc = np.einsum("ekl,klij,ej->ei", C, Kref, Uloc)
    else:
        loc = np.einsum("ekl,klij,ejm->eim", C, Kref, Uloc)
    return space.dof_sum(loc)


def mass_apply(space: FunctionSpace, geom, U, coeff=None):
    """y = M U with M_ij = int c phi_i phi_j, c = coeff (None: 1, a constant
    or per-cell [nc]), for a scalar tensor U [n] or a vector one [n, m], on
    U's device (geom a geometry_on view): the window mass kernel's reference
    and the velocity correction's operator."""
    Mref = torch.as_tensor(ref_mass(space.degree, _dim(space)), dtype=U.dtype,
                           device=U.device)
    scale = _scaled(geom.detJ, coeff)
    eq = "ij,ej,e->ei" if U.dim() == 1 else "ij,ejm,e->eim"
    return space.dof_sum(torch.einsum(eq, Mref, space.gather(U), scale))


def mass_diag(space, geom):
    Mref = np.diag(ref_mass(space.degree, _dim(space)))
    return space.dof_sum(Mref[None, :] * geom.detJ[:, None])


def stiffness_diag(space, geom):
    Kd = np.einsum("klii->kli", ref_stiffness(space.degree, _dim(space)))
    return space.dof_sum(np.einsum("ekl,kli->ei", geom.C, Kd))


# ---------------------------------------------------------------------------
# Quadrature-point evaluation (torch, on the state's device); `tab` is a
# Tab.on(...) view and `geom` a geometry_on(...) view
# ---------------------------------------------------------------------------
def values_at_qp(tab, Uloc):
    """Uloc [nc,nl(,m)] -> values at qp [nc,nq(,m)]."""
    if Uloc.dim() == 2:
        return torch.einsum("ql,el->eq", tab.phi, Uloc)
    return torch.einsum("ql,elm->eqm", tab.phi, Uloc)


def grads_at_qp(tab, geom, Uloc):
    """Uloc [nc,nl(,m)] -> physical gradients [nc,nq(,m),dim]."""
    if Uloc.dim() == 2:
        return torch.einsum("qlk,edk,el->eqd", tab.dphi, geom.G, Uloc)
    return torch.einsum("qlk,edk,elm->eqmd", tab.dphi, geom.G, Uloc)


def integrate_rhs(space, tab, geom, val=None, grad=None):
    """Assemble sum_e int_e (val . phi_i + grad : grad(phi_i)) into
    [n_dofs(,m)]. val: [nc,nq(,m)]; grad: [nc,nq(,m),dim]."""
    wd = tab.w[None, :] * geom.detJ[:, None]  # [nc, nq]
    loc = None
    if val is not None:
        if val.dim() == 2:
            loc = torch.einsum("eq,qi->ei", wd * val, tab.phi)
        else:
            loc = torch.einsum("eqm,eq,qi->eim", val, wd, tab.phi)
    if grad is not None:
        if grad.dim() == 3:
            g = torch.einsum("eqd,eq,qik,edk->ei", grad, wd, tab.dphi, geom.G)
        else:
            g = torch.einsum(
                "eqmd,eq,qik,edk->eim", grad, wd, tab.dphi, geom.G
            )
        loc = g if loc is None else loc + g
    return space.dof_sum(loc)


def stiffness_local(space, geom, coeff=None):
    """Explicit element stiffness matrices [nc, nl, nl] of
    int c grad(phi_i).grad(phi_j), c = coeff (None: 1, a constant or
    per-cell [nc])."""
    Kref = ref_stiffness(space.degree, _dim(space))
    return np.einsum("ekl,klij->eij", _scaled(geom.C, coeff), Kref)


# ---------------------------------------------------------------------------
# Boundary (facet) tabulations -- for ds-integrals: edges of a 2-D space
# (BoundaryTab), triangle faces of a 3-D one (BoundaryFaceTab)
# ---------------------------------------------------------------------------
class BoundaryTab:
    """The basis on each boundary edge at 1-D Gauss points, as device
    tensors in `dtype` on `device` (defaults: the mesh's):

      phi  [nb, nq1, nl]      basis values at facet quadrature points
      dphi [nb, nq1, nl, 2]   reference gradients there
      wl   [nb, nq1]          quadrature weight * facet length
      normals [nb, 2], Gb [nb, 2, 2] (the facet cell's G), cell_dofs [nb, nl]

    and, on the host, x_np [nb, nq1, 2]: the physical facet quadrature
    points.
    """

    def __init__(self, space: FunctionSpace, rule_degree=4, dtype=None,
                 device=None):
        mesh = space.mesh
        dtype = mesh.dtype if dtype is None else dtype
        device = mesh.device if device is None else torch.device(device)
        s, w1 = quadrature.edge_rule(rule_degree)
        nq1 = len(s)
        # reference coords of edge k at parameter s: v_{k+1}(1-s) + v_{k+2}s
        ref_v = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
        phi_k = np.empty((3, nq1, space.n_local))
        dphi_k = np.empty((3, nq1, space.n_local, 2))
        pts_k = np.empty((3, nq1, 2))
        for k in range(3):
            a, b = (k + 1) % 3, (k + 2) % 3
            pts_k[k] = ref_v[a][None] * (1 - s)[:, None] + ref_v[b][None] * s[:, None]
            phi_k[k], dphi_k[k] = elements.tabulate(space.degree, pts_k[k])

        loc = mesh.boundary_local_np
        cells = mesh.boundary_cells_np.astype(np.int64)
        ref_pts = pts_k[loc]  # [nb, nq1, 2]
        p = mesh.points_np[mesh.cells_np[cells]]  # [nb, 3, 2]
        self.x_np = (p[:, None, 0] + ref_pts[:, :, 0, None] * (p[:, None, 1] - p[:, None, 0])
                     + ref_pts[:, :, 1, None] * (p[:, None, 2] - p[:, None, 0]))

        def dev(a, dt=dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                   device=device)

        self.phi = dev(phi_k[loc])
        self.dphi = dev(dphi_k[loc])
        self.wl = dev(w1[None, :] * mesh.boundary_lengths_np[:, None])
        self.normals = dev(mesh.boundary_normals_np)
        self.Gb = dev(geometry(mesh).G[cells])
        self.cell_dofs_np = space.cell_dofs_np[cells]
        self.cell_dofs = dev(self.cell_dofs_np, torch.int64)
        self.space = space
        self.nq1 = nq1

    def permuted(self, inv):
        """A copy whose dof indices are renumbered by `inv` (old -> new), for
        operators that live in a permuted numbering."""
        out = copy.copy(self)
        out.cell_dofs_np = np.asarray(inv)[self.cell_dofs_np]
        out.cell_dofs = torch.as_tensor(out.cell_dofs_np, dtype=torch.int64,
                                        device=self.cell_dofs.device)
        return out

    def gather(self, U):
        return U[self.cell_dofs]  # [nb,nl(,m)]

    def values(self, U):
        Uloc = self.gather(U)
        if Uloc.dim() == 2:
            return torch.einsum("bql,bl->bq", self.phi, Uloc)
        return torch.einsum("bql,blm->bqm", self.phi, Uloc)

    def grads(self, U):
        Uloc = self.gather(U)
        if Uloc.dim() == 2:
            return torch.einsum("bqlk,bdk,bl->bqd", self.dphi, self.Gb, Uloc)
        return torch.einsum("bqlk,bdk,blm->bqmd", self.dphi, self.Gb, Uloc)

    def integrate_rhs(self, val):
        """sum_facets int (val . phi_i) ds -> [n_dofs(,m)]; val [nb,nq1(,m)]."""
        if val.dim() == 2:
            loc = torch.einsum("bq,bq,bqi->bi", val, self.wl, self.phi)
        else:
            loc = torch.einsum("bqm,bq,bqi->bim", val, self.wl, self.phi)
        flat = loc.reshape((-1,) + loc.shape[2:])
        out = flat.new_zeros((self.space.n_dofs,) + flat.shape[1:])
        return out.index_add_(0, self.cell_dofs.reshape(-1), flat)

    def integrate_scalar(self, val):
        """sum_facets int val ds (a 0-d tensor); val [nb, nq1]."""
        return torch.einsum("bq,bq->", val, self.wl)


class BoundaryFaceTab(BoundaryTab):
    """The 3-D facet (triangle face) tabulation of a tet-mesh space, for
    ds-integrals on TetMesh boundaries: the same tensors and methods as
    BoundaryTab, with nq1 points of triangle_rule(rule_degree) per face,
    wl = w_q * 2 * face area (the rule's weights sum to 1/2), outward unit
    normals [nb, 3] and physical quadrature points x_np [nb, nq1, 3]."""

    _TET_FACES = [(1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2)]
    _REF_V = np.array(
        [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
    )

    def __init__(self, space: FunctionSpace, rule_degree=4, dtype=None,
                 device=None):
        mesh = space.mesh
        assert getattr(mesh, "dim", 2) == 3
        dtype = mesh.dtype if dtype is None else dtype
        device = mesh.device if device is None else torch.device(device)
        tpts, tw = quadrature.triangle_rule(rule_degree)
        nq = len(tw)
        # reference tet coords of face k at the triangle's points
        phi_k = np.empty((4, nq, space.n_local))
        dphi_k = np.empty((4, nq, space.n_local, 3))
        pts_k = np.empty((4, nq, 3))
        lam_a = 1.0 - tpts[:, 0] - tpts[:, 1]
        for k, (a, b, c) in enumerate(self._TET_FACES):
            pts_k[k] = (lam_a[:, None] * self._REF_V[a] + tpts[:, 0:1] * self._REF_V[b]
                        + tpts[:, 1:2] * self._REF_V[c])
            phi_k[k], dphi_k[k] = elements.tabulate(space.degree, pts_k[k], dim=3)

        loc = mesh.boundary_local_np
        cells = mesh.boundary_cells_np.astype(np.int64)
        p = mesh.points_np
        f = mesh.boundary_faces_np  # sorted triples; orientation fixed below
        cr = np.cross(p[f[:, 1]] - p[f[:, 0]], p[f[:, 2]] - p[f[:, 0]])
        area2 = np.linalg.norm(cr, axis=1)  # 2 * area
        n = cr / area2[:, None]
        # outward: away from the cell centroid
        cent_cell = p[mesh.cells_np[cells]].mean(axis=1)
        flip = np.einsum("bd,bd->b", n, p[f].mean(axis=1) - cent_cell) < 0
        n[flip] *= -1.0
        x0 = p[mesh.cells_np[cells][:, 0]]
        dv = np.stack([p[mesh.cells_np[cells][:, k + 1]] - x0 for k in range(3)],
                      axis=-1)
        self.x_np = x0[:, None, :] + np.einsum("bqk,bdk->bqd", pts_k[loc], dv)

        def dev(a, dt=dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                   device=device)

        self.phi = dev(phi_k[loc])
        self.dphi = dev(dphi_k[loc])
        self.wl = dev(tw[None, :] * area2[:, None])
        self.normals = dev(n)
        self.Gb = dev(geometry(mesh).G[cells])
        self.cell_dofs_np = space.cell_dofs_np[cells]
        self.cell_dofs = dev(self.cell_dofs_np, torch.int64)
        self.space = space
        self.nq1 = nq
