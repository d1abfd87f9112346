"""Plain P2/P1 Taylor-Hood finite elements on simplices (triangles and
tetrahedra), written from the weak forms alone: the yardstick that judges
the projection steps of the program.

Everything here is matrix-free and per cell: a field is gathered at the
cell's dofs, evaluated at quadrature points of a collapsed Gauss rule
(exact for the degree-5 convection integrand), and the cell integrals are
summed back with index_add. Cells run in blocks so that a 5M-cell mesh fits
beside the program's freed memory. Nothing here reads a table of the
program: the edges, dofs, geometry and boundary facets are derived from the
points and cells alone.

Weak forms (v a P2 test vector, q a P1 test function, s = dt / rho):

  momentum  A(T) x = (x, v) + dt/2 [(T.grad x, v) - (T.grad v, x)]
                     + s mu (grad x + grad x^T, grad v)
                     - s <mu (grad x)^T n - rho/2 (T.n)^+ x, v>   (2-D ds)
  rhs       b = (u0, v) + s (p, div v) - s <p n, v>               (2-D ds)
  pressure  K phi = (grad phi, grad q), L2 = -(rho/dt)(div u, q)
                    - mu (grad div u, grad q)
  correction (d, v) = -(dt/rho) (grad phi + mu grad div u, v)
"""
from __future__ import annotations

import numpy as np
import torch

# cells a block of the per-cell loops, by dimension
BLOCK = {2: 1 << 18, 3: 1 << 16}

# edges of the reference simplex, as vertex pairs, in this module's local
# P2 order (vertices first, then these edges)
EDGES = {2: [(1, 2), (0, 2), (0, 1)],
         3: [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]}
FACETS = {2: [(1, 2), (0, 2), (0, 1)],
          3: [(1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2)]}


def gauss_line(n):
    """Gauss-Legendre on [0, 1]: (points [n], weights [n])."""
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


def simplex_rule(dim, n=4):
    """Collapsed (Duffy) Gauss-Legendre rule on the reference simplex with n
    points a direction; with n = 4 exact to degree 6 on the triangle and 5
    on the tetrahedron. Weights sum to 1/2 or 1/6."""
    g, w = gauss_line(n)
    if dim == 2:
        a, b = np.meshgrid(g, g, indexing="ij")
        wa, wb = np.meshgrid(w, w, indexing="ij")
        pts = np.stack([a, b * (1 - a)], -1).reshape(-1, 2)
        wts = (wa * wb * (1 - a)).reshape(-1)
        return pts, wts
    a, b, c = np.meshgrid(g, g, g, indexing="ij")
    wa, wb, wc = np.meshgrid(w, w, w, indexing="ij")
    pts = np.stack([a, b * (1 - a), c * (1 - a) * (1 - b)], -1).reshape(-1, 3)
    wts = (wa * wb * wc * (1 - a) ** 2 * (1 - b)).reshape(-1)
    return pts, wts


def p2_basis(pts):
    """P2 Lagrange basis on the reference simplex at pts [nq, dim]:
    values [nq, nl], reference gradients [nq, nl, dim] and the constant
    reference Hessians [nl, dim, dim]; vertex i: l_i (2 l_i - 1), edge
    (i, j): 4 l_i l_j with the barycentrics l."""
    nq, dim = pts.shape
    lam = np.concatenate([1.0 - pts.sum(1, keepdims=True), pts], 1)  # [nq, d+1]
    dlam = np.concatenate([-np.ones((1, dim)), np.eye(dim)], 0)  # [d+1, dim]
    vals, grads, hess = [], [], []
    for i in range(dim + 1):
        vals.append(lam[:, i] * (2 * lam[:, i] - 1))
        grads.append((4 * lam[:, i] - 1)[:, None] * dlam[i][None])
        hess.append(4 * np.outer(dlam[i], dlam[i]))
    for i, j in EDGES[dim]:
        vals.append(4 * lam[:, i] * lam[:, j])
        grads.append(4 * (lam[:, i, None] * dlam[j][None] + lam[:, j, None] * dlam[i][None]))
        hess.append(4 * (np.outer(dlam[i], dlam[j]) + np.outer(dlam[j], dlam[i])))
    return np.stack(vals, 1), np.stack(grads, 1), np.stack(hess, 0)


def p1_ref_grads(dim):
    return np.concatenate([-np.ones((1, dim)), np.eye(dim)], 0)  # [d+1, dim]


class SimplexP2:
    """The P2/P1 pair on a simplex mesh (points [nv, dim], cells [nc, dim+1])
    on `device` in float64 for the geometry; operators run in `dtype`.

    P2 dofs: the vertices, then one per edge (edges numbered by their sorted
    vertex pair); P1 dofs: the vertices. Vector fields are [n2, dim]."""

    def __init__(self, points, cells, device, dtype=torch.float64):
        dev = torch.device(device)
        self.device, self.dtype = dev, dtype
        P = torch.as_tensor(np.asarray(points, dtype=np.float64), device=dev)
        C = torch.as_tensor(np.asarray(cells, dtype=np.int64), device=dev)
        self.dim = dim = P.shape[1]
        self.block = BLOCK[dim]
        self.nv, self.nc = P.shape[0], C.shape[0]
        self.points, self.cells = P, C
        # edges by their sorted vertex pair
        pairs = torch.stack([C[:, list(e)] for e in EDGES[dim]], 1)  # [nc, ne, 2]
        lo, hi = pairs.min(-1).values, pairs.max(-1).values
        key = lo * self.nv + hi
        ukey, inv = torch.unique(key.reshape(-1), return_inverse=True)
        self.edges = torch.stack([ukey // self.nv, ukey % self.nv], 1)
        self.ne = len(ukey)
        self.n2 = self.nv + self.ne
        self.cd2 = torch.cat([C, self.nv + inv.view(self.nc, -1)], 1)  # [nc, nl]
        self.dof_points = torch.cat(
            [P, 0.5 * (P[self.edges[:, 0]] + P[self.edges[:, 1]])], 0)
        edge_len = (P[self.edges[:, 0]] - P[self.edges[:, 1]]).norm(dim=1)
        self.hmax = float(edge_len.max())
        # affine geometry: x = p0 + J xi, grad_x = G grad_xi with G = J^-T
        J = torch.stack([P[C[:, k + 1]] - P[C[:, 0]] for k in range(dim)], -1)
        self.detJ = torch.linalg.det(J).abs()
        self.G = torch.linalg.inv(J).transpose(1, 2).contiguous()
        # boundary facets: those of one cell only
        fl = torch.stack([C[:, list(f)] for f in FACETS[dim]], 1)  # [nc, nf, dim]
        fs = fl.sort(-1).values.reshape(-1, dim)
        fkey = fs[:, 0]
        for k in range(1, dim):
            fkey = fkey * self.nv + fs[:, k]
        _, finv, fcnt = torch.unique(fkey, return_inverse=True, return_counts=True)
        once = torch.nonzero(fcnt[finv] == 1).view(-1)
        self.bcell = once // (dim + 1)
        self.blocal = once % (dim + 1)  # the facet opposite this local vertex
        on2 = torch.zeros(self.n2, dtype=torch.bool, device=dev)
        bverts = fs[once].reshape(-1)
        on2[bverts] = True
        # the edges of a boundary facet: those without its opposite vertex
        for k, e in enumerate(EDGES[dim]):
            on_facet = (torch.tensor(e, device=dev)[None] != self.blocal[:, None]).all(1)
            on2[self.cd2[self.bcell[on_facet], dim + 1 + k]] = True
        self.on_boundary2 = on2
        self.on_boundary1 = on2[: self.nv]
        # reference tables
        pts, w = simplex_rule(dim)
        phi, dphi, hess = p2_basis(pts)
        t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)  # noqa: E731
        self.qw, self.phi, self.dphi, self.hess = t(w), t(phi), t(dphi), t(hess)
        self.dlam = t(p1_ref_grads(dim))
        self.vol_ref = 0.5 if dim == 2 else 1.0 / 6.0
        self._bnd = None

    # -- helpers ---------------------------------------------------------------
    def _blocks(self):
        for c0 in range(0, self.nc, self.block):
            yield slice(c0, min(c0 + self.block, self.nc))

    def _cast(self, *a):
        return [x.to(self.dtype) for x in a]

    def _geo(self, sl):
        return self._cast(self.detJ[sl], self.G[sl])

    # -- vector P2 operators ---------------------------------------------------
    def mass(self, x):
        """(x, v) for a P2 vector field x [n2, dim]."""
        qw, phi = self._cast(self.qw, self.phi)
        out = torch.zeros_like(x)
        for sl in self._blocks():
            dJ, _ = self._geo(sl)
            cd = self.cd2[sl]
            wd = qw[None] * dJ[:, None]
            xq = torch.einsum("ql,cla->cqa", phi, x[cd])
            y = torch.einsum("cqa,qi->cia", wd[:, :, None] * xq, phi)
            out.index_add_(0, cd.reshape(-1), y.reshape(-1, self.dim))
        return out

    def mass_diag(self):
        """The diagonal of the scalar P2 mass matrix [n2]."""
        qw, phi = self._cast(self.qw, self.phi)
        out = torch.zeros(self.n2, dtype=self.dtype, device=self.device)
        for sl in self._blocks():
            dJ, _ = self._geo(sl)
            y = dJ[:, None] * torch.einsum("q,qi->i", qw, phi * phi)[None]
            out.index_add_(0, self.cd2[sl].reshape(-1), y.reshape(-1))
        return out

    def momentum(self, T, x, dt, rho, mu):
        """Volume part of A(T) x: mass, skew convection and the symmetric
        viscous stress."""
        qw, phi, dphi = self._cast(self.qw, self.phi, self.dphi)
        s_mu = dt * mu / rho
        out = torch.zeros_like(x)
        for sl in self._blocks():
            dJ, G = self._geo(sl)
            cd = self.cd2[sl]
            xl, Tl = x[cd], T[cd]
            xq = torch.einsum("ql,cla->cqa", phi, xl)
            Tq = torch.einsum("ql,cla->cqa", phi, Tl)
            gref = torch.einsum("qlk,cla->cqak", dphi, xl)
            gx = torch.einsum("cqak,cmk->cqam", gref, G)  # d x_a / d x_m
            conv = torch.einsum("cqm,cqam->cqa", Tq, gx)
            TG = torch.einsum("cqm,cmk->cqk", Tq, G)  # T.grad phi_i = TG . dphi_i
            wd = (qw[None] * dJ[:, None])[:, :, None]  # [C, nq, 1]
            y = torch.einsum("cqa,qi->cia", wd * (xq + 0.5 * dt * conv), phi)
            # the terms tested with grad v: viscous stress, skew transport
            stress = gx + gx.transpose(2, 3)  # [C, nq, a, m]
            F = s_mu * torch.einsum("cqam,cmk->cqak", stress, G)
            F = F - 0.5 * dt * xq[:, :, :, None] * TG[:, :, None, :]
            y = y + torch.einsum("cqak,qik->cia", wd[..., None] * F, dphi)
            out.index_add_(0, cd.reshape(-1), y.reshape(-1, self.dim))
        return out

    def pressure_grad(self, p):
        """(p, div v) for a P1 field p [nv]."""
        qw, phi, dphi = self._cast(self.qw, self.phi, self.dphi)
        lamq = self._p1_at_qp()
        out = torch.zeros(self.n2, self.dim, dtype=p.dtype, device=p.device)
        for sl in self._blocks():
            dJ, G = self._geo(sl)
            cd = self.cd2[sl]
            pq = torch.einsum("qm,cm->cq", lamq, p[self.cells[sl]])
            t = torch.einsum("cq,qik->cik", (qw[None] * dJ[:, None]) * pq, dphi)
            y = torch.einsum("cik,cak->cia", t, G)
            out.index_add_(0, cd.reshape(-1), y.reshape(-1, self.dim))
        return out

    def _p1_at_qp(self):
        pts = simplex_rule(self.dim)[0]
        lam = np.concatenate([1.0 - pts.sum(1, keepdims=True), pts], 1)
        return torch.as_tensor(lam, dtype=self.dtype, device=self.device)

    def grad_div_cell(self, x, sl):
        """Per-cell constant grad(div x) [C, dim] of a P2 vector field."""
        hess = self._cast(self.hess)[0]
        _, G = self._geo(sl)
        # d_m d_a phi_l = G[m,k] H[l,k,k'] G[a,k']
        Hp = torch.einsum("cmk,lkj,caj->clma", G, hess, G)
        return torch.einsum("clma,cla->cm", Hp, x[self.cd2[sl]])

    def correction_rhs(self, phi_p, x, mu):
        """(grad phi + mu grad div x, v) for P1 phi and a P2 vector x."""
        qw, phi = self._cast(self.qw, self.phi)
        dlam = self._cast(self.dlam)[0]
        out = torch.zeros(self.n2, self.dim, dtype=x.dtype, device=x.device)
        intphi = torch.einsum("q,qi->i", qw, phi)  # reference integrals
        for sl in self._blocks():
            dJ, G = self._geo(sl)
            gp = torch.einsum("cm,mk,cak->ca", phi_p[self.cells[sl]], dlam, G)
            g = gp + mu * self.grad_div_cell(x, sl)
            y = (dJ[:, None, None] * intphi[None, :, None]) * g[:, None, :]
            out.index_add_(0, self.cd2[sl].reshape(-1), y.reshape(-1, self.dim))
        return out

    # -- scalar P1 operators ---------------------------------------------------
    def stiffness1(self, p):
        """(grad p, grad q) for a P1 field p [nv]."""
        dlam = self._cast(self.dlam)[0]
        out = torch.zeros_like(p)
        for sl in self._blocks():
            dJ, G = self._geo(sl)
            gl = torch.einsum("mk,cak->cma", dlam, G)  # grad lambda_m
            gp = torch.einsum("cm,cma->ca", p[self.cells[sl]], gl)
            y = (self.vol_ref * dJ)[:, None] * torch.einsum("ca,cma->cm", gp, gl)
            out.index_add_(0, self.cells[sl].reshape(-1), y.reshape(-1))
        return out

    def div1(self, x):
        """(div x, q) for a P2 vector x."""
        qw, dphi = self._cast(self.qw, self.dphi)
        lamq = self._p1_at_qp()
        out = torch.zeros(self.nv, dtype=x.dtype, device=x.device)
        for sl in self._blocks():
            dJ, G = self._geo(sl)
            gref = torch.einsum("qlk,cla->cqak", dphi, x[self.cd2[sl]])
            dv = torch.einsum("cqak,cak->cq", gref, G)
            y = torch.einsum("cq,qm->cm", (qw[None] * dJ[:, None]) * dv, lamq)
            out.index_add_(0, self.cells[sl].reshape(-1), y.reshape(-1))
        return out

    def grad_div1(self, x):
        """(grad div x, grad q) for a P2 vector x."""
        dlam = self._cast(self.dlam)[0]
        out = torch.zeros(self.nv, dtype=x.dtype, device=x.device)
        for sl in self._blocks():
            dJ, G = self._geo(sl)
            gd = self.grad_div_cell(x, sl)
            gl = torch.einsum("mk,cak->cma", dlam, G)
            y = (self.vol_ref * dJ)[:, None] * torch.einsum("ca,cma->cm", gd, gl)
            out.index_add_(0, self.cells[sl].reshape(-1), y.reshape(-1))
        return out

    # -- 2-D boundary (ds) terms -----------------------------------------------
    def _boundary(self):
        """Boundary edges of a triangle mesh at 4 Gauss points (the program
        states its ds rule as degree 6, which is this 4-point rule)."""
        if self._bnd is None:
            assert self.dim == 2
            s, w = gauss_line(4)
            ref_v = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
            tabs = []
            for k in range(3):
                a, b = ref_v[[1, 2, 0][k]], ref_v[[2, 0, 1][k]]
                pts = a[None] * (1 - s)[:, None] + b[None] * s[:, None]
                ph, dph, _ = p2_basis(pts)
                tabs.append((ph, dph))
            t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=self.device)  # noqa: E731
            phi = t(np.stack([tabs[k][0] for k in range(3)]))[self.blocal]
            dphi = t(np.stack([tabs[k][1] for k in range(3)]))[self.blocal]
            cells = self.cells[self.bcell]
            va = cells.gather(1, ((self.blocal + 1) % 3)[:, None])[:, 0]
            vb = cells.gather(1, ((self.blocal + 2) % 3)[:, None])[:, 0]
            vo = cells.gather(1, self.blocal[:, None])[:, 0]
            tang = self.points[vb] - self.points[va]
            length = tang.norm(dim=1)
            n = torch.stack([tang[:, 1], -tang[:, 0]], 1) / length[:, None]
            # outward: away from the opposite vertex
            side = ((self.points[vo] - self.points[va]) * n).sum(1)
            n = torch.where(side[:, None] > 0, -n, n)
            self._bnd = dict(phi=phi, dphi=dphi, n=n, wl=t(w)[None] * length[:, None],
                             G=self.G[self.bcell], cd=self.cd2[self.bcell],
                             cd1=self.cells[self.bcell])
        return {k: (v.to(self.dtype) if v.is_floating_point() else v)
                for k, v in self._bnd.items()}

    def boundary_momentum(self, T, x, dt, rho, mu):
        """The ds part of A(T) x: -s <mu (grad x)^T n - rho/2 (T.n)^+ x, v>."""
        b = self._boundary()
        xl, Tl = x[b["cd"]], T[b["cd"]]
        xq = torch.einsum("bql,bla->bqa", b["phi"], xl)
        Tq = torch.einsum("bql,bla->bqa", b["phi"], Tl)
        gx = torch.einsum("bqak,bmk->bqam",
                          torch.einsum("bqlk,bla->bqak", b["dphi"], xl), b["G"])
        gtn = torch.einsum("bqma,bm->bqa", gx, b["n"])  # ((grad x)^T n)_a
        tn = torch.clamp(torch.einsum("bqa,ba->bq", Tq, b["n"]), min=0.0)
        val = mu * gtn - 0.5 * rho * tn[:, :, None] * xq
        y = torch.einsum("bqa,bq,bqi->bia", val, b["wl"], b["phi"])
        out = torch.zeros_like(x)
        out.index_add_(0, b["cd"].reshape(-1), y.reshape(-1, 2))
        return -(dt / rho) * out

    def boundary_pressure(self, p, dt, rho):
        """The ds part of the momentum right-hand side: -s <p n, v>."""
        b = self._boundary()
        lam_edge = b["phi"]  # P2 values; p is P1: interpolate p through its vertices
        pv = p[b["cd1"]]  # [nb, 3]
        # P1 at the P2 nodes: vertices as is, edge (i, j) the mean
        p2 = torch.cat([pv] + [0.5 * (pv[:, i] + pv[:, j])[:, None]
                               for i, j in EDGES[2]], 1)
        pq = torch.einsum("bql,bl->bq", lam_edge, p2)
        y = torch.einsum("bq,ba,bq,bqi->bia", pq, b["n"], b["wl"], b["phi"])
        out = torch.zeros(self.n2, 2, dtype=p.dtype, device=p.device)
        out.index_add_(0, b["cd"].reshape(-1), y.reshape(-1, 2))
        return -(dt / rho) * out


def match_dofs(ref_points, prog_points, tol=1e-9):
    """For dof coordinates of the reference [n, dim] (tensor) and of the
    program [n, dim] (numpy or tensor), the index map prog_of_ref with
    prog_points[prog_of_ref] == ref_points, or None where the two sets of
    points differ (by count, or by more than tol times the extent)."""
    R = ref_points.to(torch.float64)
    Q = torch.as_tensor(np.asarray(prog_points), dtype=torch.float64, device=R.device)
    if R.shape != Q.shape:
        return None
    lo = torch.minimum(R.min(0).values, Q.min(0).values)
    ext = float((torch.maximum(R.max(0).values, Q.max(0).values) - lo).max())
    step = tol * ext

    def order(X):
        q = torch.round((X - lo) / step).to(torch.int64)
        idx = torch.arange(len(X), device=X.device)
        for k in reversed(range(X.shape[1])):
            idx = idx[torch.sort(q[idx, k], stable=True).indices]
        return idx

    r, p = order(R), order(Q)
    prog_of_ref = torch.empty_like(r)
    prog_of_ref[r] = p
    if float((Q[prog_of_ref] - R).abs().max()) > 10 * step:
        return None
    return prog_of_ref
