# Window-blocked momentum operator on a vector-P2 space (2-D or 3-D):
#
#   A v = mass_w M v + s_rho c(T; v) + s_mu sym_grad(v)          (lagged)
#   J v = A v + s_rho c(v; x)                                   (Newton)
#
# (mass, skew convection with the transport T frozen, the stress form
# 2 eps(u):eps(v), and in Newton mode the reaction term of the skew
# convection about the state x, which makes J the exact volume tangent with
# T = x), on the uniform-stride layout of attic/window.py: the hand-written
# CUDA kernels that replace the Pallas kernel
# flow_tpu/attic/winmom.py::momentum_tables_apply (K3) - csrc/winmom.cu for
# its _mom_kernel_2d and _mom_newton_kernel_2d (DIM=2, NL=6, NQ=7) and
# csrc/winmom3d.cu for its _mom_kernel_3d and _mom_newton_kernel_3d (DIM=3,
# NL=10, NQ=27) - and their plain PyTorch version. It computes in float32
# whatever the caller's dtype, as the JAX package does.
#
# Blocked-table row layouts (all [nb, rows, C]):
#   geometry G    row DIM*d + k         = G[c, d, k]
#   geometry Cg   row DIM*k + l         = C[c, k, l]
#   transport Tq  row d*nq + q          = T_d(x_q)
#   state Uq      row m*nq + q          = x_m(x_q)        (Newton; is Tq)
#   grads Gu      row (d*DIM + m)*nq + q = d_d x_m (x_q)  (Newton)
# Small tables (one float32 buffer, see smem_tables): phi [nq, NL]; dphi
# row k*nq+q -> dphi[q, :, k]; w [nq]; mref [NL, NL]; kref row
# (DIM*k+l)*NL+i -> Kref[k, l, i, :].
#
# momentum_windows launches the kernel for CUDA tensors and takes the plain
# version only for CPU tensors. It counts its launches in WINMOM.launches
# (2-D lagged), WINMOM_NEWTON.launches (2-D Newton), WINMOM3D.launches (3-D
# lagged) and WINMOM3D_NEWTON.launches (3-D Newton). All four run the
# cluster walk of csrc/wincluster.cuh (attic/winkernel.cluster_launch,
# momentum_plan) on the layout's compressed rows and positions
# (window.compact_lists), two components a position in 2-D and three in
# 3-D. WindowLaggedMomentum checks its tables and resolves its launches
# once (_MomentumLaunch), and checks the transport and gradient tables only
# when a call hands new ones, so that an apply costs the host little more
# than the launch itself.
from __future__ import annotations

import ctypes
import time

import numpy as np
import torch

from .._build import Kernel
from ..fem import assembly
from ..mesh3d import _device
from .window import build_window_layout, compact_lists
from .winkernel import _cluster_launch, _launch_consts, check_window_input

__all__ = ["WindowLaggedMomentum", "momentum_windows", "momentum_windows_plain",
           "momentum_local_plain", "smem_tables", "WINMOM", "WINMOM_NEWTON",
           "WINMOM3D", "WINMOM3D_NEWTON"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# K3's variants: a library for 2-D and one for 3-D, an entry point and a
# count each. Every entry takes the launch's fixed arguments as one struct
# (_WinmomArgs), then x, the three weights, out and the stream; each
# library also has its occupancy query
WINMOM = Kernel("winmom", {
    "winmom_p2_2d_lagged": [_P] * 5,
    "winmom_p2_2d_clusters": [_I] * 4 + [_P],
})
WINMOM_NEWTON = Kernel("winmom", {
    "winmom_p2_2d_newton": [_P] * 5,
    "winmom_p2_2d_clusters": [_I] * 4 + [_P],
})
WINMOM3D = Kernel("winmom3d", {
    "winmom_p2_3d_lagged": [_P] * 5,
    "winmom_p2_3d_clusters": [_I] * 4 + [_P],
})
WINMOM3D_NEWTON = Kernel("winmom3d", {
    "winmom_p2_3d_newton": [_P] * 5,
    "winmom_p2_3d_clusters": [_I] * 4 + [_P],
})

# the configurations the kernels are built for, P2 with the degree-5 rule:
# (DIM, NL, NQ) -> ((lagged kernel, entry), (Newton kernel, entry))
_ENTRIES = {
    (2, 6, 7): ((WINMOM, "winmom_p2_2d_lagged"),
                (WINMOM_NEWTON, "winmom_p2_2d_newton")),
    (3, 10, 27): ((WINMOM3D, "winmom_p2_3d_lagged"),
                  (WINMOM3D_NEWTON, "winmom_p2_3d_newton")),
}


def smem_tables(tab, degree, dim):
    """The small tables (phi, dphi, w, mref, kref) of a tabulation, flat in
    one float64 numpy buffer in the layout the kernel reads."""
    nq, nl = tab.phi.shape
    dphi = np.transpose(tab.dphi, (2, 0, 1)).reshape(dim * nq, nl)
    return np.concatenate([
        tab.phi.ravel(),
        dphi.ravel(),
        tab.w.ravel(),
        assembly.ref_mass(degree, dim).ravel(),
        assembly.ref_stiffness(degree, dim).reshape(dim * dim * nl, nl).ravel(),
    ])


def _split_tables(tabs, DIM, NL, NQ):
    sizes = [NQ * NL, DIM * NQ * NL, NQ, NL * NL, DIM * DIM * NL * NL]
    phi, dphi, w, mref, kref = torch.split(tabs, sizes)
    return (phi.view(NQ, NL), dphi.view(DIM, NQ, NL), w, mref.view(NL, NL),
            kref.view(DIM, DIM, NL, NL))


def momentum_local_plain(U, valid, detj, g4, cg4, Tq, tabs, scal, Uq=None,
                         Gu=None):
    """Element contributions loc [DIM, nb, NL, C] of the momentum apply from
    the local dof values U [DIM, nb, NL, C] of each block's cells (the
    tables as in momentum_windows_plain); with Uq, Gu the Newton tangent."""
    DIM, nb, NL, C = U.shape
    NQ = Tq.shape[1] // DIM
    phi, dphi, w, mref, kref = _split_tables(tabs, DIM, NL, NQ)
    mass_w, s_rho, s_mu = scal[0], scal[1], scal[2]
    G = g4.view(nb, DIM, DIM, C)
    Cg = cg4.view(nb, DIM, DIM, C)
    T = Tq.view(nb, DIM, NQ, C)
    dj = detj[:, None, :]  # [b, 1, c]
    wd = w[None, :, None] * dj  # [b, q, c]

    vq = torch.einsum("qj,mbjc->mbqc", phi, U)
    rg = torch.einsum("kqj,mbjc->mbkqc", dphi, U)
    gv = torch.einsum("bdkc,mbkqc->mbdqc", G, rg)
    # skew convection c(T; v): 0.5 (T.grad v) phi - 0.5 (T.grad phi) v
    wv = wd * 0.5 * torch.einsum("bdqc,mbdqc->mbqc", T, gv)
    wg = (wd[:, None] * -0.5) * T * vq[:, :, None]  # [m, b, d, q, c]
    loc = mass_w * dj * torch.einsum("ij,mbjc->mbic", mref, U)
    conv = torch.einsum("mbqc,qi->mbic", wv, phi)
    conv = conv + torch.einsum("bdkc,mbdqc,kqi->mbic", G, wg, dphi)
    loc = loc + s_rho * conv
    # stress, component-diagonal part: Cg[k,l] Kref[k,l,i,j] u_j
    loc = loc + s_mu * torch.einsum("bklc,klij,mbjc->mbic", Cg, kref, U)
    # stress coupling: loc[a][i] += s_mu detj G[a,k] G[n,l] K[k,l,j,i] u_n_j
    loc = loc + (s_mu * dj) * torch.einsum(
        "bakc,bnlc,klji,nbjc->abic", G, G, kref, U
    )
    if Uq is not None:
        # Newton reaction c(v; x), skew form:
        #   0.5 [(v.grad x)_m phi_i - (v.grad phi_i) x_m]
        X = Uq.view(nb, DIM, NQ, C)  # [b, m, q, c]
        GX = Gu.view(nb, DIM, DIM, NQ, C)  # [b, d, m, q, c] = d_d x_m
        wt2a = 0.5 * wd * torch.einsum("dbqc,bdmqc->mbqc", vq, GX)
        ws2 = (0.5 * wd[:, None]) * torch.einsum("dbqc,bmqc->mbdqc", vq, X)
        re = torch.einsum("mbqc,qi->mbic", wt2a, phi)
        re = re - torch.einsum("bdkc,mbdqc,kqi->mbic", G, ws2, dphi)
        loc = loc + s_rho * re
    return loc * valid[:, None, :]


def momentum_windows_plain(x_pad, lidx, valid, detj, g4, cg4, Tq, tabs, scal,
                           S, W, Uq=None, Gu=None):
    """Per-block output windows [DIM, nb, W] of the momentum apply.

    x_pad [DIM, nb*S + W] float32 (permuted, zero padded components);
    lidx [nb, NL, C] int32; valid, detj [nb, C]; g4, cg4 [nb, DIM*DIM, C];
    Tq [nb, DIM*NQ, C]; tabs the smem_tables buffer; scal [3] =
    (mass_w, s_rho, s_mu). Newton mode: the state Uq [nb, DIM*NQ, C] and its
    gradients Gu [nb, DIM*DIM*NQ, C] add the reaction term."""
    DIM = x_pad.shape[0]
    nb = lidx.shape[0]
    dev = lidx.device
    base = (torch.arange(nb, device=dev) * S)[:, None, None]
    U = x_pad[:, (base + lidx).long()]  # [m, b, j, c]
    loc = momentum_local_plain(U, valid, detj, g4, cg4, Tq, tabs, scal, Uq, Gu)
    out = x_pad.new_zeros((DIM, nb * W))
    rows = (torch.arange(nb, device=dev) * W)[:, None, None] + lidx
    out.index_add_(1, rows.reshape(-1).long(), loc.reshape(DIM, -1))
    return out.view(DIM, nb, W)


class _WinmomArgs(ctypes.Structure):
    """The fixed arguments of a K3 launch (csrc/winmom.cuh, struct
    WinmomArgs): the tables' pointers, the layout and the cluster launch."""
    _fields_ = ([(name, ctypes.c_void_p) for name in
                 ("lidx", "valid", "detj", "g4", "cg4", "tq", "gu", "tabs", "rptr", "rows",
                  "pos")]
                + [(name, ctypes.c_int) for name in
                   ("nb", "S", "W", "C", "R", "n_pad", "clusters", "cl", "threads", "cap")])


def _check_tensors(device, ints=(), floats=()):
    """The kernels' tensors: contiguous, on `device`, int32 or float32."""
    for t in (*ints, *floats):
        if t.device != device or not t.is_contiguous():
            raise ValueError("momentum_windows: tensors must be contiguous and on one device")
    if any(t.dtype != torch.float32 for t in floats):
        raise TypeError("momentum_windows: float tensors must be float32")
    if any(t.dtype != torch.int32 for t in ints):
        raise TypeError("momentum_windows: index tensors must be int32")


class _MomentumLaunch:
    """K3's launch at fixed layout tables (see momentum_windows): lidx,
    valid, detj, g4, cg4, the small tables and the compressed rows and
    positions are checked once, here, and their pointers kept in a
    _WinmomArgs struct per variant with its cluster launch. The transport
    (and, Newton, gradient) tables are checked when a call hands tables
    other than the last ones, and the weights `scal` are the caller's
    (WindowLaggedMomentum._scal builds them); a call then checks only
    x_pad and allocates only the output. The launch follows the module's
    launch constants: a call that finds them changed plans again. The
    tables must not change while the launch lives (it holds them, and
    their pointers)."""

    def __init__(self, lidx, valid, detj, g4, cg4, tabs, S, W, positions, DIM, NQ):
        nb, NL, C = lidx.shape
        if (DIM, NL, NQ) not in _ENTRIES:
            raise ValueError(
                f"momentum_windows: the kernels take (DIM, NL, NQ) = (2, 6, 7) or "
                f"(3, 10, 27), got ({DIM}, {NL}, {NQ})"
            )
        if positions is None:
            raise ValueError("momentum_windows: the kernel needs the layout's lists")
        _check_tensors(lidx.device, (lidx, *positions), (valid, detj, g4, cg4, tabs))
        rptr, rows, pos = positions
        R = rows.shape[-1]
        ntab = NQ * NL + DIM * NQ * NL + NQ + NL * NL + DIM * DIM * NL * NL
        if (tuple(rptr.shape) != (nb, R + 1)
                or tuple(rows.shape) != (nb, R) or tuple(pos.shape) != (nb, NL * C)
                or W % 4 or tuple(valid.shape) != (nb, C) or tuple(detj.shape) != (nb, C)
                or tuple(g4.shape) != (nb, DIM * DIM, C)
                or tuple(cg4.shape) != (nb, DIM * DIM, C) or tabs.numel() != ntab
                or DIM * (nb * S + W) >= 2**31 or DIM * DIM * NQ * nb * C >= 2**31):
            raise ValueError("momentum_windows: inconsistent layout shapes")
        self.device = lidx.device
        self.DIM, self.NQ = DIM, NQ
        self.layout = (nb, C, NL)
        self.n_pad = nb * S + W
        self.tables = (lidx, valid, detj, g4, cg4, tabs, *positions)
        self.entries = _ENTRIES[(DIM, NL, NQ)]
        self.args = tuple(_WinmomArgs(
            lidx.data_ptr(), valid.data_ptr(), detj.data_ptr(), g4.data_ptr(),
            cg4.data_ptr(), None, None, tabs.data_ptr(), rptr.data_ptr(), rows.data_ptr(),
            pos.data_ptr(), nb, S, W, C, R, self.n_pad) for _ in self.entries)
        self.argp = tuple(ctypes.c_void_p(ctypes.addressof(a)) for a in self.args)
        self.consts = [None, None]
        self.Tq = self.Gu = None
        # the output by empty_like of one value expanded to its shape:
        # contiguous, at a fraction of torch.empty's host cost
        one = torch.empty(1, dtype=torch.float32, device=self.device)
        self.out_like = one.expand(DIM, nb, W)

    def _transport(self, Tq, Gu):
        """Check and take the transport (and gradient) tables of a call."""
        nb, C, _ = self.layout
        DIM, NQ = self.DIM, self.NQ
        _check_tensors(self.device, floats=(Tq,) if Gu is None else (Tq, Gu))
        if (tuple(Tq.shape) != (nb, DIM * NQ, C)
                or (Gu is not None and tuple(Gu.shape) != (nb, DIM * DIM * NQ, C))):
            raise ValueError("momentum_windows: inconsistent layout shapes")
        for a in self.args:
            a.tq = Tq.data_ptr()
            a.gu = None if Gu is None else Gu.data_ptr()
        self.Tq, self.Gu = Tq, Gu

    def _plan(self, newton, consts):
        nb, C, NL = self.layout
        kernel = self.entries[newton][0]
        plan = _cluster_launch(kernel, nb, C, NL, self.device.index, consts)
        a = self.args[newton]
        a.clusters, a.cl, a.threads, a.cap = (plan.clusters, plan.cl, plan.threads,
                                              plan.cap)
        self.consts[newton] = consts

    def __call__(self, x_pad, Tq, scal, Uq=None, Gu=None):
        if (Uq is None) != (Gu is None) or (Uq is not None and Uq is not Tq):
            raise ValueError("momentum_windows: the Newton kernel takes Uq that is "
                             "Tq (the state is the transport) and Gu")
        device = self.device
        if (x_pad.device != device or x_pad.dtype != torch.float32
                or not x_pad.is_contiguous() or x_pad.numel() != self.DIM * self.n_pad):
            check_window_input("momentum_windows", x_pad, device, self.DIM * self.n_pad)
        if Tq is not self.Tq or (Gu is not None and Gu is not self.Gu):
            self._transport(Tq, Gu)
        newton = int(Gu is not None)
        kernel, entry = self.entries[newton]
        consts = _launch_consts(kernel)
        if consts != self.consts[newton]:
            self._plan(newton, consts)
        out = torch.empty_like(self.out_like)
        args = (self.argp[newton], x_pad.data_ptr(), scal.data_ptr(), out.data_ptr())
        index = device.index
        if index == torch.cuda.current_device():
            kernel.launch(entry, *args, torch._C._cuda_getCurrentRawStream(index))
        else:
            with torch.cuda.device(index):
                kernel.launch(entry, *args, torch._C._cuda_getCurrentRawStream(index))
        return out


def momentum_windows(x_pad, lidx, valid, detj, g4, cg4, Tq, tabs, scal, S, W,
                     positions=None, Uq=None, Gu=None):
    """Per-block output windows [DIM, nb, W] of the momentum apply (see
    momentum_windows_plain). CPU tensors take the plain version; CUDA
    tensors launch the kernel, after checking every argument. The kernels
    read `positions` = (rptr, rows, pos), the layout's compressed rows and
    the lists' inverse (window.compact_lists): each cell stores its local
    results, all components each, at their list positions in the shared
    memory of a cluster of blocks (winkernel.cluster_launch,
    momentum_plan), in passes where they exceed it, and each listed row
    sums its positions in order; the other rows are zero. The Newton
    kernels read the state values from Tq, so they take only Uq that is Tq
    (as state_qp returns them)."""
    if x_pad.device.type == "cpu":
        return momentum_windows_plain(x_pad, lidx, valid, detj, g4, cg4, Tq,
                                      tabs, scal, S, W, Uq, Gu)
    if x_pad.device.type != "cuda":
        raise ValueError(f"momentum_windows: no kernel for device {x_pad.device}")
    DIM = x_pad.shape[0]
    launch = _MomentumLaunch(lidx, valid, detj, g4, cg4, tabs, S, W, positions, DIM,
                             Tq.shape[1] // DIM)
    _check_tensors(launch.device, floats=(scal,))
    if scal.numel() != 3 or tuple(x_pad.shape) != (DIM, launch.n_pad):
        raise ValueError("momentum_windows: inconsistent layout shapes")
    return launch(x_pad, Tq, scal, Uq, Gu)


class WindowLaggedMomentum:
    """The momentum volume operator (lagged, or with Uq/Gu the Newton
    tangent) on the window layout of a vector-P2 space on triangles or
    tets. Tables live in float32 on `device` (default: the mesh's). State
    convention: [n, DIM] in the original numbering (apply), or in the
    layout's permuted row order (apply_perm_rows, the solve-side path).
    The operator holds the lists its kernel reads, `positions` (see
    momentum_windows), and on the card its launch (_MomentumLaunch),
    whose tables are checked once, here: windows() then checks only its
    input, and the transport tables when they change.
    layout_seconds: the host seconds of the layout, its tables and lists."""

    def __init__(self, V, S=None, device=None):
        self.V = V
        t0 = time.perf_counter()
        self.wl = wl = build_window_layout(V, S=S)
        self.device = V.mesh.device if device is None else _device(device)
        dim = assembly._dim(V)
        # the component loops assume velocity components == mesh dim
        assert V.n_components == dim, (V.n_components, dim)
        self.dim = dim
        geom = assembly.geometry(V.mesh)
        cells = np.asarray(wl.cells, dtype=np.int64)
        nb = wl.nb

        def dev(a, dtype=torch.float32):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=self.device)

        self.detj = dev(geom.detJ[cells])
        # [nb, dim^2, C] with row dim*a+k
        self.G4 = dev(np.transpose(geom.G[cells], (0, 2, 3, 1)).reshape(nb, dim * dim, -1))
        self.Cg4 = dev(np.transpose(geom.C[cells], (0, 2, 3, 1)).reshape(nb, dim * dim, -1))
        self.lidx = dev(np.transpose(wl.lidx, (0, 2, 1)), torch.int32)
        self.valid = dev(wl.valid)
        self.perm = dev(wl.perm, torch.int64)
        self.inv = dev(wl.inv, torch.int64)
        self._cells = dev(cells, torch.int64)
        self._G = assembly.geometry_on(V.mesh, torch.float32, self.device).G
        self.tab = assembly.tabulation(V, assembly.CONV_RULE)
        self.nq = self.tab.nq
        self.tabs = dev(smem_tables(self.tab, V.degree, dim))
        # the compressed rows and positions the kernels read (the plain
        # version reads none of them)
        self.positions = tuple(dev(a, torch.int32) for a in compact_lists(wl))
        self._launch = None
        if self.device.type == "cuda":
            self._launch = _MomentumLaunch(self.lidx, self.valid, self.detj, self.G4,
                                           self.Cg4, self.tabs, wl.S, wl.W, self.positions,
                                           dim, self.nq)
        self._scal_cache = {}
        self.layout_seconds = time.perf_counter() - t0

    # -- per-step transport ------------------------------------------------
    def transport_qp(self, T):
        """T [n, DIM] (original numbering) -> Tq [nb, DIM*nq, C] float32
        (row d*nq+q holds component d at quadrature point q)."""
        tab = self.tab.on(T.dtype, T.device)
        Xq = assembly.values_at_qp(tab, self.V.gather(T))  # [nc, nq, DIM]
        Tqb = Xq.to(torch.float32)[self._cells]  # [nb, C, nq, DIM]
        Tq = Tqb.permute(0, 3, 2, 1).reshape(self.wl.nb, self.dim * self.nq, -1)
        return Tq.contiguous()

    def state_qp(self, x):
        """x [n, DIM] (original numbering) -> the Newton tables (Tq, Uq, Gu):
        values at the quadrature points (Uq is Tq) and their physical
        gradients, Gu [nb, DIM*DIM*nq, C] float32 with row (d*DIM+m)*nq+q
        holding d_d x_m. The gradients are taken in float32, as the JAX
        package takes them."""
        Tq = self.transport_qp(x)
        dphi = self.tab.on(torch.float32, x.device).dphi  # [nq, NL, dim]
        rgrad = torch.einsum("cjm,qjk->cqkm", self.V.gather(x).to(torch.float32),
                             dphi)
        gU = torch.einsum("cdk,cqkm->cdmq", self._G, rgrad)  # [nc, d, m, q]
        Gu = gU[self._cells].permute(0, 2, 3, 4, 1)  # [nb, d, m, q, C]
        Gu = Gu.reshape(self.wl.nb, self.dim * self.dim * self.nq, -1)
        return Tq, Tq, Gu.contiguous()  # the kernel reads contiguous rows

    def zero_transport(self):
        return torch.zeros((self.wl.nb, self.dim * self.nq, self.wl.C),
                           dtype=torch.float32, device=self.device)

    def _scal(self, mass_w, s_rho, s_mu):
        vals = (mass_w, s_rho, s_mu)
        if all(isinstance(v, (int, float)) for v in vals):
            t = self._scal_cache.get(vals)
            if t is None:
                t = torch.tensor(vals, dtype=torch.float32, device=self.device)
                self._scal_cache[vals] = t
            return t
        return torch.stack([
            torch.as_tensor(v, device=self.device).to(torch.float32)
            for v in vals
        ])

    # -- applies -------------------------------------------------------------
    def windows(self, x_pad, Tq, mass_w, s_rho, s_mu, Uq=None, Gu=None):
        """[DIM, n_pad] float32 permuted, padded components -> [DIM, nb, W]."""
        scal = self._scal(mass_w, s_rho, s_mu)
        if self._launch is not None:
            return self._launch(x_pad, Tq, scal, Uq, Gu)
        wl = self.wl
        return momentum_windows(
            x_pad, self.lidx, self.valid, self.detj, self.G4, self.Cg4, Tq,
            self.tabs, scal, wl.S, wl.W, self.positions, Uq, Gu,
        )

    def apply_perm_rows(self, v, Tq, mass_w, s_rho, s_mu, Uq=None, Gu=None):
        """v [n, DIM] in permuted row order -> A v (with Uq/Gu: J v), same
        layout and dtype."""
        wl = self.wl
        xp = v.new_zeros((self.dim, wl.n_pad), dtype=torch.float32)
        xp[:, :wl.n] = v.T
        y = wl.overlap_add(self.windows(xp, Tq, mass_w, s_rho, s_mu, Uq, Gu))
        return y.T.to(v.dtype)

    def apply(self, x, Tq, mass_w, s_rho, s_mu, Uq=None, Gu=None):
        """x [n, DIM] in the original numbering -> A x, same numbering."""
        return self.apply_perm_rows(x[self.perm], Tq, mass_w, s_rho, s_mu, Uq,
                                    Gu)[self.inv]
