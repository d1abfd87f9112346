# The component-major ("packed") layout of FastStepper's 2-D Taylor-Hood
# projection step: the velocity state is one flat vector [2 n] (component
# blocks), and every per-cell table puts the cell axis last. Port of
# flow_tpu/fem/packed.py::PackedContext.
#
# The JAX module exists for the TPU's (8, 128) tile padding, and unrolls
# every small axis (component a/b, local dof i/j, derivative k/l,
# quadrature point q) into Python loops over [nc] vectors. Here those small
# axes stay tensor dimensions in front of the cell axis: a gathered field is
# [2, nl, nc], a local accumulator loc is [2, nlV, nc] (loc[a, i] is the JAX
# list entry loc[a][i]), the geometry is G [d, k, nc], C [k, l, nc] and
# detJ [nc]. A JAX loop nest becomes one tensor expression: contractions
# with a constant reference table are matrix products, and the per-cell
# ones are broadcast products summed over the small axis (an einsum with
# the cell axis as a batch turns into a batched GEMM of 2x2 to 6x6 blocks,
# ~50x slower on the card at 7.6M DoF). Every dof sum reads a
# fem/gathersum member table (both components of the velocity in one
# gather), so the sums repeat bit for bit on the card.
#
# Scope: the 2-D P2/P1 pair. Exactness against the JAX methods and the
# einsum layout is pinned in tests/test_torch_fast_packed.py.
from __future__ import annotations

import numpy as np
import torch

from . import assembly, elements, quadrature
from .assembly import ref_mass, ref_mixed, ref_stiffness
from .gathersum import GatherSum

__all__ = ["PackedContext"]


class _Sum(GatherSum):
    """GatherSum over targets of any shape, the local values summed flat."""

    def __call__(self, vals):
        return super().__call__(vals.reshape(self.n_local_entries, 1))


class PackedContext:
    """Tables of one 2-D (V = P2 vector, Q = P1) Taylor-Hood pair in the
    packed layout, in `dtype` on `device` (defaults: the mesh's)."""

    def __init__(self, V, Q, conv_rule=5, dtype=None, device=None):
        mesh = V.mesh
        if not (getattr(mesh, "dim", 2) == 2 and V.degree == 2 and Q.degree == 1):
            raise ValueError("PackedContext: 2-D P2/P1 Taylor-Hood only")
        self.V, self.Q = V, Q
        self.dtype = dtype = mesh.dtype if dtype is None else dtype
        self.device = device = mesh.device if device is None else torch.device(device)
        self.n = n = V.n_dofs
        self.nc = nc = mesh.n_cells
        self.nlV, self.nlQ = V.n_local, Q.n_local

        def dev(a, dt=dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)

        geom = assembly.geometry(mesh)
        self.detJ = dev(geom.detJ)  # [nc]
        self.G = dev(np.transpose(geom.G, (1, 2, 0)))  # [d, k, nc]
        self.C = dev(np.transpose(geom.C, (1, 2, 0)))  # [k, l, nc]
        # transposed dof tables: [nl, nc]
        cdV = V.cell_dofs_np.T
        cdQ = Q.cell_dofs_np.T
        self.cdV = dev(cdV, torch.int64)
        self.cdQ = dev(cdQ, torch.int64)
        # dof sums: the velocity's two components in one table over
        # a * n + dof, the pressure's over its dofs; local entries i-major
        two = np.stack([cdV, cdV + n])  # [2, nlV, nc]
        self._sumV2 = _Sum(two, 2 * n, device)
        self._sumV = _Sum(cdV, n, device)
        self._sumQ = _Sum(cdQ, Q.n_dofs, device)

        self.Mref = dev(ref_mass(2, 2))  # [i, j]
        self.Kref = dev(ref_stiffness(2, 2))  # [k, l, i, j]
        self.Bref = dev(ref_mixed(1, 2))  # [k, m(Q), j(V)]
        self.Href = dev(elements.hessian_ref(2, 2))  # [j, k, l]
        pts4, w4 = quadrature.simplex_rule(4, 2)
        phi4, _ = elements.tabulate(2, pts4)
        self.intV_ref = dev(np.einsum("q,qi->i", w4, phi4))  # int_ref phi_i
        self.drefQ = dev(elements.tabulate(1, np.zeros((1, 2)))[1][0])  # [m, k]
        pts, w = quadrature.simplex_rule(conv_rule, 2)
        phi, dphi = elements.tabulate(2, pts)
        self.cq_w, self.cq_phi, self.cq_dphi = dev(w), dev(phi), dev(dphi)
        self.nq = len(w)
        # physical basis gradients at the convection points [d, q, i, nc]
        self._gphi = torch.einsum("dke,qik->dqie", self.G, self.cq_dphi)
        # the stress form's constant grad:grad pairs [nl, nl, nc]
        self.kscal = torch.einsum("kle,klij->ije", self.C, self.Kref)
        self._btab_sums = {}

    # -- layout converters -----------------------------------------------------
    def pack(self, U):
        """[n, 2] -> flat [2n] (component blocks)."""
        return U.t().reshape(-1)

    def unpack(self, Uf):
        """flat [2n] -> [n, 2]."""
        return Uf.view(2, self.n).t().contiguous()

    def comps(self, Uf):
        """flat [2n] -> [2, n] (a view; row a is component a)."""
        return Uf.view(2, self.n)

    # -- gather / dof sum ------------------------------------------------------
    def gatherV(self, Uc):
        """[n] -> [nlV, nc], or [2, n] -> [2, nlV, nc]."""
        return Uc[..., self.cdV]

    def gatherQ(self, Pc):
        return Pc[self.cdQ]

    def dof_sum_V(self, loc):
        """[nlV, nc] -> [n]."""
        return self._sumV(loc)

    def dof_sum_Q(self, loc):
        """[nlQ, nc] -> [n_Q]."""
        return self._sumQ(loc)

    def dof_sum_V2(self, loc):
        """[2, nlV, nc] -> flat [2n]."""
        return self._sumV2(loc)

    def _zero_loc(self, like):
        return like.new_zeros((2, self.nlV, self.nc))

    # -- momentum-residual volume terms (loc [2, nlV, nc] accumulators) --------
    def mass_loc_acc(self, loc, Ul, scale=1.0):
        """loc[a,i] += scale detJ Mref[i,j] Ul[a,j]."""
        return loc + scale * self.detJ * torch.einsum("ij,aje->aie", self.Mref, Ul)

    @staticmethod
    def _cell_apply(A, U):
        """out[a, i] = sum_j A[i, j] U[a, j] per cell: A [nl, nl, nc], U
        [2, nl, nc], summed over j in order."""
        out = A[None, :, 0] * U[:, None, 0]
        for j in range(1, A.shape[1]):
            out = out + A[None, :, j] * U[:, None, j]
        return out

    def _g_apply(self, u):
        """out[a, ...] = sum_k G[a, k] u[k, ...] per cell (u [2, ..., nc])."""
        G = self.G.reshape((2, 2) + (1,) * (u.dim() - 2) + (self.nc,))
        return G[:, 0] * u[0] + G[:, 1] * u[1]

    def _gt_apply(self, u):
        """out[l, ...] = sum_b G[b, l] u[b, ...] per cell."""
        G = self.G.reshape((2, 2) + (1,) * (u.dim() - 2) + (self.nc,))
        return G[0] * u[0] + G[1] * u[1]

    def _sym_grad_transpose(self, Ul, Kref=None):
        """detJ G[a,k] G[b,l] Kref[k,l,j,i] Ul[b,j] -> [2, nlV, nc]."""
        w = self._gt_apply(Ul)  # [l, j, nc]
        u = torch.einsum("klji,lje->kie", self.Kref if Kref is None else Kref, w)
        return self.detJ * self._g_apply(u)

    def sym_grad_loc_acc(self, loc, Ul, mu):
        """loc[a,i] += mu [C[k,l] Kref[k,l,i,j] Ul[a,j]
                          + detJ G[a,k] G[b,l] Kref[k,l,j,i] Ul[b,j]]."""
        s = self._cell_apply(self.kscal, Ul) + self._sym_grad_transpose(Ul)
        return loc + mu * s

    def pressure_grad_loc_acc(self, loc, Pl, scale=1.0):
        """loc[a,i] += scale detJ G[a,k] Bref[k,m,i] Pl[m]."""
        cm = torch.einsum("kmi,me->kie", self.Bref, Pl)
        return loc + scale * self.detJ * self._g_apply(cm)

    def _qp(self, Ul):
        """Values [2, q, nc] and physical gradients gU[a, d, q, nc] (du_a/dx_d)
        at the convection points."""
        Uq = torch.einsum("qi,aie->aqe", self.cq_phi, Ul)
        rg = torch.einsum("qik,aie->kaqe", self.cq_dphi, Ul)  # reference gradients
        G = self.G[:, :, None, None]  # [d, k, 1, 1, nc]
        gU = G[:, 0] * rg[0] + G[:, 1] * rg[1]  # [d, a, q, nc]
        return Uq, gU.transpose(0, 1)

    @staticmethod
    def _dot2(W, g):
        """sum_d W[d] g[.., d, ..]: W [2, q, nc], g [a, d, q, nc] -> [a, q, nc]."""
        return W[0] * g[:, 0] + W[1] * g[:, 1]

    def _tgrad(self, W):
        """(W . grad phi_i) at the convection points: [q, nlV, nc]."""
        return W[0][:, None] * self._gphi[0] + W[1][:, None] * self._gphi[1]

    def _conv_integrate(self, loc, val, flux, scale):
        """loc[m,i] += scale sum_q w_q detJ [val[m,q] phi[q,i]
                                          - 0.5 flux[m,q,i]]."""
        wd = (scale * self.cq_w)[:, None] * self.detJ  # [q, nc]
        c = val[:, :, None, :] * self.cq_phi[None, :, :, None] - 0.5 * flux
        return loc + (wd[None, :, None, :] * c).sum(dim=1)

    def skew_conv_loc_acc(self, loc, Ul, scale=1.0):
        """loc[a,i] += scale * the skew convection of W = U by itself (the
        exact quadrature of forms.skew_convection_combined_loc)."""
        Wq, gW = self._qp(Ul)
        val = 0.5 * self._dot2(Wq, gW)
        flux = Wq[:, :, None, :] * self._tgrad(Wq)[None]
        return self._conv_integrate(loc, val, flux, scale)

    def skew_conv_lagged_loc_acc(self, loc, Tl, Ul, scale=1.0):
        """loc[a,i] += scale * 0.5 [((T.grad)u, v) - ((T.grad)v, u)], the
        transport T fixed (forms.skew_convection_lagged_loc; linear in U)."""
        Tq = torch.einsum("qi,die->dqe", self.cq_phi, Tl)
        Uq, gU = self._qp(Ul)
        val = 0.5 * self._dot2(Tq, gU)
        flux = Uq[:, :, None, :] * self._tgrad(Tq)[None]
        return self._conv_integrate(loc, val, flux, scale)

    def skew_conv_tangent_loc_acc(self, loc, state, Vl, scale=1.0):
        """loc += scale * the tangent of skew_conv_loc_acc at the state
        W (state = self._qp of W's local values) in the direction V:
        0.5 [(V.grad)W + (W.grad)V] against phi, minus 0.5 (V_m W + W_m V)
        against grad phi."""
        Wq, gW = state
        Vq, gV = self._qp(Vl)
        val = 0.5 * (self._dot2(Vq, gW) + self._dot2(Wq, gV))
        flux = (Vq[:, :, None, :] * self._tgrad(Wq)[None]
                + Wq[:, :, None, :] * self._tgrad(Vq)[None])
        return self._conv_integrate(loc, val, flux, scale)

    # -- the momentum residual's volume part ----------------------------------
    def residual_volume(self, Uf_i, Uf_0, Pf, rho, mu, dt, w_im, Tf=None):
        """F = M (ui - u0) - (dt/rho) w_im [-rho conv(ui) - stress(ui)
        + pgrad(p0)] -> flat [2n]: the JAX package's packed residual, which
        carries no explicit (w_ex) terms. Tf (flat [2n]): a fixed transport
        (the lagged residual, affine in Uf_i)."""
        Uli = self.gatherV(self.comps(Uf_i))
        Ul0 = self.gatherV(self.comps(Uf_0))
        s = dt / rho * w_im
        loc = self.mass_loc_acc(self._zero_loc(Uf_i), Uli - Ul0)
        if Tf is None:
            loc = self.skew_conv_loc_acc(loc, Uli, scale=s * rho)
        else:
            Tl = self.gatherV(self.comps(Tf))
            loc = self.skew_conv_lagged_loc_acc(loc, Tl, Uli, scale=s * rho)
        loc = self.sym_grad_loc_acc(loc, Uli, mu=s * mu)
        loc = self.pressure_grad_loc_acc(loc, self.gatherQ(Pf), scale=-s)
        return self.dof_sum_V2(loc)

    # -- the lagged solve's element-matrix apply (EMA) -------------------------
    def stiffness_scalar_pairs(self):
        """Kscal[i, j] = C[k,l] Kref[k,l,i,j] -> [nlV, nlV, nc] (constant)."""
        return self.kscal

    def lagged_scalar_tensor(self, Tl, alpha_mass, c_visc, c_conv, kscal):
        """S[i, j] = alpha_mass detJ Mref[i,j] + c_visc Kscal[i,j]
        + c_conv 0.5 int [phi_i (T.grad phi_j) - phi_j (T.grad phi_i)]
        -> [nlV, nlV, nc]."""
        S = alpha_mass * self.Mref[:, :, None] * self.detJ + c_visc * kscal
        Tq = torch.einsum("qi,die->dqe", self.cq_phi, Tl)
        tg = self._tgrad(Tq)  # [q, j, nc]
        wd = (0.5 * c_conv * self.cq_w)[:, None] * self.detJ
        a = None
        for q in range(self.nq):
            t = (wd[q] * self.cq_phi[q][:, None])[:, None, :] * tg[q][None]
            a = t if a is None else a + t
        return S + (a - a.transpose(0, 1))

    def ema_scalar_apply(self, loc, S, Vl):
        """loc[a,i] += S[i,j] Vl[a,j]."""
        # a reduced-precision S (ema_bf16) meets Vl rounded to its precision,
        # the products exact in loc's
        Vr = Vl.to(S.dtype).to(loc.dtype)
        return loc + self._cell_apply(S.to(loc.dtype), Vr)

    def sym_grad_transpose_loc_acc(self, loc, Ul, mu, kref_dtype=None):
        """loc[a,i] += mu detJ G[a,k] G[b,l] Kref[k,l,j,i] Ul[b,j] (Kref
        rounded to kref_dtype where given: the bfloat16 EMA tangent's)."""
        K = None if kref_dtype is None else self.Kref.to(kref_dtype).to(self.Kref.dtype)
        return loc + mu * self._sym_grad_transpose(Ul.to(loc.dtype), K)

    # -- pressure-step pieces --------------------------------------------------
    def div_rhs(self, Uf):
        """b[m] = int div(u) q_m -> [n_Q] (forms.div_rhs)."""
        Ul = self.gatherV(self.comps(Uf))
        cj = torch.einsum("kmj,bje->bkme", self.Bref, Ul)
        G = self.G[:, :, None]  # [b, k, 1, nc]
        return self.dof_sum_Q(self.detJ * (G * cj).sum(dim=(0, 1)))

    def grad_div_cell(self, Uf):
        """The cellwise constant grad(div u) -> [2, nc] (forms.grad_div_ustar)."""
        Ul = self.gatherV(self.comps(Uf))
        h = torch.einsum("jkl,aje->akle", self.Href, Ul)
        t = (self.G[:, :, None] * h).sum(dim=(0, 1))  # [l, nc]
        return self.G[:, 0] * t[0] + self.G[:, 1] * t[1]

    def grad_div_rhs(self, Uf):
        """b[m] = int grad(div u).grad(q_m) (forms.grad_div_ustar_rhs)."""
        v = self.grad_div_cell(Uf)
        gk = torch.einsum("dke,mk->dme", self.G, self.drefQ)
        return self.dof_sum_Q(0.5 * self.detJ * (v[0] * gk[0] + v[1] * gk[1]))

    # -- boundary (ds) terms: surface-sized --------------------------------------
    def _bsum(self, btab):
        s = self._btab_sums.get(id(btab))
        if s is None:
            cd = btab.cell_dofs_np.T  # [nl, nb]
            s = (_Sum(np.stack([cd, cd + self.n]), 2 * self.n, self.device), btab)
            self._btab_sums[id(btab)] = s
        return s[0]

    def _bvals(self, btab, Uf):
        """[2, nb, q] facet values of a flat state."""
        return torch.einsum("bql,alb->abq", btab.phi, self.comps(Uf)[:, btab.cell_dofs.t()])

    def _bgrads(self, btab, Uf):
        """[2, nb, q, d] facet gradients du_a/dx_d of a flat state."""
        Ub = self.comps(Uf)[:, btab.cell_dofs.t()]  # [2, nl, nb]
        return torch.einsum("bqlk,bdk,alb->abqd", btab.dphi, btab.Gb, Ub)

    def boundary_integrate(self, btab, val):
        """sum over facets of int val[a] phi_i ds, val [2, nb, q] -> flat [2n]."""
        loc = torch.einsum("abq,bq,bqi->aib", val, btab.wl, btab.phi)
        return self._bsum(btab)(loc)

    def boundary_rhs(self, btabV, btabQ, Uf, Pf, rho, mu, ds_stress=True,
                     ds_dn=True, Tf=None):
        """The packed twin of NSContext._rhs_weak_bnd -> flat [2n]: -p0 n.v
        + mu (grad u)^T n . v - 0.5 rho (T.n)+ u.v, T = u or the fixed Tf."""
        nrm = btabV.normals.t()  # [d, nb]
        p0b = btabQ.values(Pf)  # [nb, q]
        vals = self._bvals(btabV, Uf)
        val = -p0b[None] * nrm[:, :, None]
        if ds_stress:
            gw = self._bgrads(btabV, Uf)  # [m, nb, q, a]
            val = val + mu * torch.einsum("mbqa,mb->abq", gw, nrm)
        if ds_dn:
            tvals = vals if Tf is None else self._bvals(btabV, Tf)
            wn = torch.einsum("mbq,mb->bq", tvals, nrm)
            val = val - 0.5 * rho * torch.clamp(wn, min=0.0)[None] * vals
        return self.boundary_integrate(btabV, val)

    def boundary_tangent(self, btabV, rho, mu, Tf, newton):
        """v -> the tangent at Tf of the state-dependent ds-terms, flat [2n]:
        mu (grad v)^T n, and the do-nothing term -(rho/2)(T.n)+ v, which with
        T = x (newton) differentiates into -(rho/2)[(x.n)+ v + H(x.n)(v.n) x]."""
        nrm = btabV.normals.t()
        tb = self._bvals(btabV, Tf)
        tn = torch.einsum("mbq,mb->bq", tb, nrm)
        tnp = torch.clamp(tn, min=0.0)
        pos = (tn > 0.0).to(tb.dtype) if newton else None

        def bnd(vf):
            val = mu * torch.einsum("mbqa,mb->abq", self._bgrads(btabV, vf), nrm)
            wb = self._bvals(btabV, vf)
            t = tnp[None] * wb
            if pos is not None:
                wn = torch.einsum("mbq,mb->bq", wb, nrm)
                t = t + (pos * wn)[None] * tb
            return self.boundary_integrate(btabV, val - 0.5 * rho * t)

        return bnd

    # -- velocity-correction pieces --------------------------------------------
    def mass_apply(self, Uf):
        """flat [2n] -> flat [2n], the component-diagonal consistent mass."""
        Ul = self.gatherV(self.comps(Uf))
        return self.dof_sum_V2(self.detJ * torch.einsum("ij,aje->aie", self.Mref, Ul))

    def grad_phi_rhs(self, Pf, div_part=None):
        """b[(i,a)] = int (grad(phi) + div_part) . v -> flat [2n]; phi in the
        P1 space (a cellwise constant gradient, integrated exactly),
        div_part an optional per-cell [2, nc] extra gradient."""
        Pl = self.gatherQ(Pf)
        t = torch.einsum("mk,me->ke", self.drefQ, Pl)
        g = self.G[:, 0] * t[0] + self.G[:, 1] * t[1]
        if div_part is not None:
            g = g + div_part
        loc = self.intV_ref[None, :, None] * (self.detJ * g)[:, None, :]
        return self.dof_sum_V2(loc)
