# Box-packed 3-D layout for P2/P1 Taylor-Hood on structured Kuhn boxes
# (mesh3d.box_mesh). Port of flow_tpu/fem/boxpack.py.
#
# STRUCTURE. Every grid cube (I, J, K) of box_mesh carries the same 6 tets,
# so the P2 dof set (vertices + edge midpoints) is the complete doubled grid
# (2N+1)^3, every cell-local dof address is index arithmetic (tet type t of
# cube (I,J,K) reaches doubled-grid point 2(I,J,K) + o(t,l), o in {0,1,2}^3),
# and the geometry is uniform per type: 6 constant Jacobians, no per-cell
# geometry arrays. Storage splits the doubled grid into its 8 parity blocks
# (even/odd per axis), so every cell window is a stride-1 [N,N,N] slice.
# The flat layout is a permutation of the standard dof vector. P1 (pressure)
# fields stay in the standard lexicographic grid numbering, the vector that
# ops/structured.StructuredLaplacian and solvers/structured_mg consume.
#
# The JAX package's functional `.at[window].add(val)` becomes an in-place
# `+=` on a slice view of a zero-initialised output buffer that this module
# allocates and owns; the block views of one flat buffer also make the
# final concatenation unnecessary.
from __future__ import annotations

import numpy as np
import torch

from . import assembly, elements, quadrature
from .assembly import CONV_RULE
from ..mesh3d import _device
from ..ops import boxmom

__all__ = ["BoxPack"]

_KUHN = [
    (0, 1, 3, 7),
    (0, 1, 5, 7),
    (0, 2, 3, 7),
    (0, 2, 6, 7),
    (0, 4, 5, 7),
    (0, 4, 6, 7),
]
_TET_EDGES = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]


def _corner(c):
    return np.array([c & 1, (c >> 1) & 1, (c >> 2) & 1], dtype=np.int64)


class BoxPack:
    """Layout + hot operators for P2/P1 Taylor-Hood on box_mesh(Nx, Ny, Nz).

    Constant tables live on `device` (default: the mesh's) in `dtype`
    (default: the mesh's)."""

    def __init__(self, mesh, dtype=None, device=None):
        assert getattr(mesh, "dim", 0) == 3 and hasattr(mesh, "grid_shape")
        gx, gy, gz = mesh.grid_shape
        self.Ns = (gx - 1, gy - 1, gz - 1)  # cells per axis (anisotropic ok)
        self.mesh = mesh
        self.dtype = mesh.dtype if dtype is None else dtype
        self.device = _device(mesh.device if device is None else device)
        self.h = mesh.grid_spacing
        self._build_types(self.h)
        self._build_tabs()
        self._build_maps(mesh)
        self._build_constants()
        self._momentum_launch = None

    # -- per-type constant geometry -------------------------------------------
    def _build_types(self, h):
        scale = np.diag(h)
        self.types = []
        for tet in _KUHN:
            vs = [_corner(c) for c in tet]
            # orient positively (TetMesh convention) by swapping v1<->v2
            J = scale @ np.stack(
                [(vs[k + 1] - vs[0]).astype(float) for k in range(3)], axis=-1
            )
            if np.linalg.det(J) < 0:
                vs = [vs[0], vs[2], vs[1], vs[3]]
                J = scale @ np.stack(
                    [(vs[k + 1] - vs[0]).astype(float) for k in range(3)],
                    axis=-1,
                )
            detJ = float(np.linalg.det(J))
            assert detJ > 0
            G = np.linalg.inv(J).T  # G[d, k]: grad_phys[d] = G[d,k] grad_ref[k]
            # C[k, l] = detJ sum_d G[d,k] G[d,l] (assembly.Geometry's metric)
            C = detJ * (G.T @ G)
            # local dof -> doubled-grid offset o in {0,1,2}^3
            offs = [2 * v for v in vs] + [vs[a] + vs[b] for a, b in _TET_EDGES]
            self.types.append(
                {
                    "detJ": detJ,
                    "G": G,
                    "C": C,
                    "off2": np.stack(offs),  # [10, 3]
                    "off1": np.stack(vs),  # [4, 3]
                }
            )

    def _build_tabs(self):
        pts, w = quadrature.simplex_rule(CONV_RULE, 3)
        phi, dphi = elements.tabulate(2, pts, dim=3)
        self.qw = np.asarray(w)
        self.phi = np.asarray(phi)  # [nq, 10]
        self.dphi = np.asarray(dphi)  # [nq, 10, 3]
        self.nq = len(w)
        self.Mref = assembly.ref_mass(2, 3)  # [10, 10]
        self.Kref = assembly.ref_stiffness(2, 3)  # [3,3,10,10]
        self.Bref = assembly.ref_mixed(1, 2, 3)  # [3, 4, 10]
        self.Href = elements.hessian_ref(2, 3)  # [10, 3, 3]
        _, dphi1 = elements.tabulate(1, np.zeros((1, 3)), dim=3)
        self.dref1 = dphi1[0]  # [4, 3]
        p2, w2 = quadrature.simplex_rule(2, 3)
        phi2, _ = elements.tabulate(2, p2, dim=3)
        self.refint = np.einsum("q,qi->i", w2, phi2)
        # constant grad:grad scalar pairs per type
        for t in self.types:
            t["Kscal"] = np.einsum("kl,klij->ij", t["C"], self.Kref)

    # -- dof <-> layout maps (setup only) -------------------------------------
    def _build_maps(self, mesh):
        Nx, Ny, Nz = self.Ns
        # parity blocks of the doubled grid, order p = (px, py, pz) lex
        self.block_dims = []
        sizes = []
        for px in (0, 1):
            for py in (0, 1):
                for pz in (0, 1):
                    d = (Nx + 1 - px, Ny + 1 - py, Nz + 1 - pz)
                    self.block_dims.append(d)
                    sizes.append(d[0] * d[1] * d[2])
        self.offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        self.n2 = int(self.offsets[-1])
        assert self.n2 == (2 * Nx + 1) * (2 * Ny + 1) * (2 * Nz + 1)

        # doubled-grid index of every P2 dof (vertices then edge midpoints)
        lo = mesh.points_np.min(axis=0)
        step = np.asarray(self.h) / 2.0
        vpts = mesh.points_np
        epts = 0.5 * (vpts[mesh.edges_np[:, 0]] + vpts[mesh.edges_np[:, 1]])
        allpts = np.concatenate([vpts, epts], axis=0)
        dgi = np.rint((allpts - lo) / step).astype(np.int64)  # [n2, 3]
        assert dgi.min() >= 0
        assert (dgi.max(axis=0) <= 2 * np.asarray(self.Ns)).all()

        par = dgi % 2
        base = dgi // 2
        pidx = (par[:, 0] * 2 + par[:, 1]) * 2 + par[:, 2]
        dims = np.asarray(self.block_dims)[pidx]
        local = (base[:, 0] * dims[:, 1] + base[:, 1]) * dims[:, 2] + base[:, 2]
        slot = self.offsets[pidx] + local
        # slot_of_dof: standard dof id -> flat packed slot (a bijection)
        assert len(np.unique(slot)) == self.n2
        self.slot_of_dof = slot
        self.dof_of_slot = np.empty(self.n2, dtype=np.int64)
        self.dof_of_slot[slot] = np.arange(self.n2)
        self.slot_of_dof_t = torch.as_tensor(self.slot_of_dof, device=self.device)
        self.dof_of_slot_t = torch.as_tensor(self.dof_of_slot, device=self.device)

        self.n1 = (Nx + 1) * (Ny + 1) * (Nz + 1)
        self.grid1 = (Nx + 1, Ny + 1, Nz + 1)

    # -- per-type contraction matrices on the device ---------------------------
    def _build_constants(self):
        def dev(a):
            return torch.as_tensor(np.asarray(a), dtype=self.dtype, device=self.device)

        self.phi_t = dev(self.phi)
        self.qw_t = dev(self.qw)
        self.wphi_t = dev(self.qw[:, None] * self.phi)  # [nq, 10]
        for ty in self.types:
            dJ, G = ty["detJ"], ty["G"]
            c = {}
            c["mass"] = dev(dJ * self.Mref)
            c["Kscal"] = dev(ty["Kscal"])
            # div_rhs: out_m = dJ B[k,m,j] G[b,k] x_j^b
            c["div"] = dev(np.einsum("kmj,bk->mbj", self.Bref, G) * dJ)
            # pressure_grad_rhs: out_i^a = dJ G[a,k] B[k,m,i] p_m
            c["pgrad"] = dev(np.einsum("ak,kmi->aim", G, self.Bref) * dJ)
            # grad_div_cell: v_d = G[d,k] Href[j,k,l] G[b,l] x_j^b
            c["graddiv"] = dev(np.einsum("dk,jkl,bl->dbj", G, self.Href, G))
            # grad_div_rhs: loc_m = (dJ/6) dref[m,k] G[d,k] v_d
            c["graddiv_rhs"] = dev(
                np.einsum("mk,dk->md", self.dref1, G) * (dJ / 6.0)
            )
            # grad_phi_rhs: ga_a = G[a,k] dref[m,k] p_m; out_i^a = refint_i dJ ga_a
            c["gradphi"] = dev(np.einsum("ak,mk->am", G, self.dref1))
            c["refint"] = dev(dJ * self.refint)
            # conv_tables: (dphi[q,m,k] G[d,k]) per d
            c["conv"] = dev(np.einsum("qmk,dk->qmd", self.dphi, G))
            # momentum transpose stress: G[a,k] Kref[k,l,j,i] G[b,l] (x s_mu dJ)
            c["stressT"] = dev(np.einsum("ak,klji,bl->aibj", G, self.Kref, G))
            ty["t"] = c

    # -- plane plumbing --------------------------------------------------------
    def unflatten(self, X):
        """Flat packed [n2(,...)] -> the 8 parity blocks as views."""
        t = tuple(X.shape[1:])
        return [
            X[self.offsets[p]:self.offsets[p + 1]].view(self.block_dims[p] + t)
            for p in range(8)
        ]

    def to_packed(self, x):
        x = torch.as_tensor(x, dtype=self.dtype, device=self.device)
        return x[self.dof_of_slot_t]

    def from_packed(self, X):
        return X[self.slot_of_dof_t]

    def _window_slices(self, b):
        Nx, Ny, Nz = self.Ns
        return (
            slice(int(b[0]), int(b[0]) + Nx),
            slice(int(b[1]), int(b[1]) + Ny),
            slice(int(b[2]), int(b[2]) + Nz),
        )

    def _parity(self, o):
        return (int(o[0] % 2) * 2 + int(o[1] % 2)) * 2 + int(o[2] % 2)

    def window2(self, blocks, t, l):
        o = self.types[t]["off2"][l]
        return blocks[self._parity(o)][self._window_slices(o // 2)]

    def acc_window2(self, blocks, t, l, val):
        o = self.types[t]["off2"][l]
        blocks[self._parity(o)][self._window_slices(o // 2)] += val

    def window1(self, grid, t, m):
        return grid[self._window_slices(self.types[t]["off1"][m])]

    def acc_window1(self, grid, t, m, val):
        grid[self._window_slices(self.types[t]["off1"][m])] += val

    def comps(self, Xf, n_comp=3):
        n = self.n2
        return [Xf[c * n:(c + 1) * n] for c in range(n_comp)]

    def _zeros_vec(self, dtype, n_comp=3):
        """Zero packed output [n_comp*n2] and each component's block views."""
        out = torch.zeros(n_comp * self.n2, dtype=dtype, device=self.device)
        return out, [self.unflatten(c) for c in self.comps(out, n_comp)]

    # stacked windows: [nl, N, N, N] tensors so the local-dof couplings are
    # single einsum contractions
    def stack2_blocks(self, blocks, t):
        return torch.stack([self.window2(blocks, t, l) for l in range(10)])

    def acc_stack2(self, acc, t, V):
        for i in range(10):
            self.acc_window2(acc, t, i, V[i])

    def stack1(self, grid, t):
        return torch.stack([self.window1(grid, t, m) for m in range(4)])

    def acc_stack1(self, grid, t, V):
        for m in range(4):
            self.acc_window1(grid, t, m, V[m])

    def _stack_comps(self, blocks_all, t):
        return torch.stack([self.stack2_blocks(b, t) for b in blocks_all])

    # ------------------------------------------------------------------------
    # hot operators (all volume terms; the cavity workloads have no ds terms)
    # ------------------------------------------------------------------------
    def mass_apply_vec(self, Xf):
        out, accs = self._zeros_vec(Xf.dtype)
        for xc, acc in zip(self.comps(Xf), accs):
            blocks = self.unflatten(xc)
            for t in range(6):
                xw = self.stack2_blocks(blocks, t)
                y = torch.einsum("ij,j...->i...", self.types[t]["t"]["mass"], xw)
                self.acc_stack2(acc, t, y)
        return out

    def div_rhs(self, Xf):
        """b[m] = int div(u) q_m -> P1 grid (standard dof order)."""
        xw_all = [self.unflatten(xc) for xc in self.comps(Xf)]
        acc = torch.zeros(self.grid1, dtype=Xf.dtype, device=self.device)
        for t in range(6):
            xw = self._stack_comps(xw_all, t)  # [3(b), 10(j), N, N, N]
            y = torch.einsum("mbj,bj...->m...", self.types[t]["t"]["div"], xw)
            self.acc_stack1(acc, t, y)
        return acc.reshape(-1)

    def pressure_grad_rhs(self, pvec):
        """b[(i,a)] = int p d_a v_i -> packed P2 vector flat."""
        grid = pvec.reshape(self.grid1)
        out, accs = self._zeros_vec(pvec.dtype)
        for t in range(6):
            pw = self.stack1(grid, t)  # [4, N, N, N]
            y = torch.einsum("aim,m...->ai...", self.types[t]["t"]["pgrad"], pw)
            for a in range(3):
                self.acc_stack2(accs[a], t, y[a])
        return out

    def grad_div_cell(self, Xf):
        """Per-cell constant grad(div u): out[t] = [3(d), N, N, N]."""
        xw_all = [self.unflatten(xc) for xc in self.comps(Xf)]
        out = []
        for t in range(6):
            xw = self._stack_comps(xw_all, t)  # [3(b), 10(j), ...]
            C = self.types[t]["t"]["graddiv"]
            out.append(torch.einsum("dbj,bj...->d...", C, xw))
        return out

    def grad_div_rhs(self, Xf):
        """b[m] = int grad(div u) . grad(q_m) -> P1 grid vector
        (rotational pressure term; ref volume factor 1/6)."""
        v = self.grad_div_cell(Xf)
        acc = torch.zeros(self.grid1, dtype=Xf.dtype, device=self.device)
        for t in range(6):
            C = self.types[t]["t"]["graddiv_rhs"]
            self.acc_stack1(acc, t, torch.einsum("md,d...->m...", C, v[t]))
        return acc.reshape(-1)

    def grad_phi_rhs(self, pvec, div_part=None, mu=0.0):
        """b[(i,a)] = int (grad(phi)_a [+ mu grad(div u*)_a]) v_i -> packed
        P2 vector flat (grad(phi) per-cell constant for P1 phi;
        int_cell v_i = detJ * refint_i)."""
        grid = pvec.reshape(self.grid1)
        out, accs = self._zeros_vec(pvec.dtype)
        for t in range(6):
            c = self.types[t]["t"]
            pw = self.stack1(grid, t)
            ga = torch.einsum("am,m...->a...", c["gradphi"], pw)
            if div_part is not None:
                ga = ga + mu * div_part[t]
            y = torch.einsum("i,a...->ai...", c["refint"], ga)
            for a in range(3):
                self.acc_stack2(accs[a], t, y[a])
        return out

    # -- lagged momentum operator ---------------------------------------------
    def conv_tables(self, Tf):
        """Per-type transport tables for the collapsed skew convection:
        A[t] = [nq, 10, N, N, N], A_qm = dphi[q,m,k] G[d,k] T_d(q),
        T_d(q) = phi[q,l] Tw_d[l]. Computed once per step (the lagged
        transport is frozen during the Krylov solve)."""
        Tw_all = [self.unflatten(Tc) for Tc in self.comps(Tf)]
        A = []
        for t in range(6):
            Tw = self._stack_comps(Tw_all, t)  # [3(d), 10(l), ...]
            C = self.types[t]["t"]["conv"]  # [nq, 10, 3]
            Td = torch.einsum("ql,dl...->qd...", self.phi_t, Tw)
            # explicit d-sum with the spatial axes minor, as in the JAX package
            A.append(
                sum(
                    C[:, :, d][:, :, None, None, None] * Td[:, d][:, None]
                    for d in range(3)
                )
            )
        return A

    def momentum_apply(self, A, Xf, s_mu, s_rho):
        """y = [M + s_mu*(stress) + s_rho*skew-conv(T)] x on the packed
        vector flat. Component-diagonal scalar part (mass + C:Kref stress
        + collapsed-quadrature skew convection
        y_i += 0.5 s_rho dJ sum_q w_q (phi_qi <A_q, x> - A_qi <phi_q, x>))
        plus the factored grad-transpose stress coupling."""
        xw_all_blocks = [self.unflatten(xc) for xc in self.comps(Xf)]
        out, accs = self._zeros_vec(Xf.dtype)
        for t in range(6):
            ty = self.types[t]
            c = ty["t"]
            dJ = ty["detJ"]
            xw = self._stack_comps(xw_all_blocks, t)  # [3(a), 10(j), ...]
            S = c["mass"] + s_mu * c["Kscal"]  # [10, 10]
            y = torch.einsum("ij,aj...->ai...", S, xw)
            # collapsed convection (component-diagonal)
            At = A[t]  # [nq, 10, ...]
            xA = torch.einsum("qj...,aj...->qa...", At, xw)
            xP = torch.einsum("qj,aj...->qa...", self.phi_t, xw)
            conv = torch.einsum("qi,qa...->ai...", self.wphi_t, xA) - torch.einsum(
                "q,qi...,qa...->ai...", self.qw_t, At, xP
            )
            y = y + (0.5 * s_rho * dJ) * conv
            # transpose stress coupling:
            # out_i^a += s_mu dJ G[a,k] Kref[k,l,j,i] G[b,l] x_j^b
            C = c["stressT"] * (s_mu * dJ)
            y = y + torch.einsum("aibj,bj...->ai...", C, xw)
            for a in range(3):
                self.acc_stack2(accs[a], t, y[a])
        return out

    def momentum_launch(self):
        """The hand-written kernel of the momentum operator on this layout's
        card (ops/boxmom.BoxMomentum), built at the first call."""
        if self._momentum_launch is None:
            self._momentum_launch = boxmom.BoxMomentum(self)
        return self._momentum_launch

    def momentum_operator(self, Tf, s_mu, s_rho):
        """x -> momentum_apply(conv_tables(Tf), x, s_mu, s_rho) for the
        lagged transport Tf: on the card the kernel of ops/boxmom.py, which
        builds no table; on the CPU the plain version, its tables built once
        here."""
        if Tf.device.type == "cpu":
            A = self.conv_tables(Tf)
            return lambda x: self.momentum_apply(A, x, s_mu, s_rho)
        return lambda x: boxmom.box_momentum_apply(self, Tf, x, s_mu, s_rho)
