# The window route of the halo projection step: one rank's momentum matvec
# by K3. Port of flow_tpu/attic/halo_win.py.
#
# Each rank builds a WindowLayout (attic/window.py) over its EXTENDED dof
# set (owned, then ghosts from the left and the right, then the dummy slot:
# the HaloSpace numbering) from its own cells, with its blocked geometry
# tables and the compressed rows and positions K3 reads. The JAX package
# pads every device's tables to common shapes because a shard_map body is
# one program; a rank here builds its tables at its own size. The matvec is
#     forward halo exchange -> this rank's window apply -> backward exchange,
# where the einsum route gathers, runs the forms and sums by dof
# (parallel/halo_step.py). On the card the apply launches K3
# (csrc/winmom.cu in 2-D, csrc/winmom3d.cu in 3-D) through the launch that
# attic/winmom.WindowLaggedMomentum uses (_MomentumLaunch, built once
# here); on the CPU it takes momentum_windows_plain. K3 computes in
# float32, as the JAX package's kernel does. The boundary ds-terms stay
# einsum.
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ..fem import assembly
from ..fem.assembly import CONV_RULE
from .window import build_window_layout, compact_lists, overlap_add_fn
from .winmom import _MomentumLaunch, momentum_windows, smem_tables

__all__ = ["build_halo_window_tables", "halo_window_momentum",
           "halo_transport_q", "halo_state_q"]


def build_halo_window_tables(Vh, detJ_np, G_np, C_np, dim, device=None):
    """This rank's window layout over its extended dof set, as tensors on
    `device` (default: Vh's).

    Vh: the HaloSpace of the velocity space; detJ/G/C: numpy geometry of
    the rank's cells, in Vh's cell order. Returns (meta: Python ints, tabs:
    dict of tensors (and, on the card, K3's launch), the small tables
    buffer, the tabulation)."""
    device = Vh.device if device is None else torch.device(device)
    cd = np.asarray(Vh.cell_dofs_ext_np)  # [c_loc, nl]
    n_ext, dummy = Vh.n_ext, Vh.dummy
    nl = cd.shape[1]
    real = np.where(~np.all(cd == dummy, axis=1))[0]
    empty = len(real) == 0
    if empty:
        # a rank that owns no cells (a tiny mesh over many ranks): one
        # fully masked block
        real = np.zeros(1, dtype=np.int64)
        cd = np.full((1, nl), dummy, dtype=np.int64)
    wl = build_window_layout(SimpleNamespace(cell_dofs_np=cd[real], n_dofs=n_ext))
    nb, C = wl.nb, wl.C
    loc_cells = real[np.asarray(wl.cells, dtype=np.int64)]  # [nb, C]
    valid = np.zeros((nb, C)) if empty else wl.valid

    def dev(a, dt=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)

    detJ = np.asarray(detJ_np)
    G = np.asarray(G_np)
    Cg = np.asarray(C_np)
    if empty:
        detJ, G, Cg = (np.zeros((1,) + a.shape[1:]) for a in (detJ, G, Cg))
    tab = assembly.tabulation(Vh.space, CONV_RULE)
    tabs = dict(
        lidx=dev(np.transpose(wl.lidx, (0, 2, 1)), torch.int32),
        valid=dev(valid),
        detj=dev(detJ[loc_cells]),
        g4=dev(np.transpose(G[loc_cells], (0, 2, 3, 1)).reshape(nb, dim * dim, C)),
        cg4=dev(np.transpose(Cg[loc_cells], (0, 2, 3, 1)).reshape(nb, dim * dim, C)),
        cells=dev(np.asarray(wl.cells, dtype=np.int64), torch.int64),
        perm=dev(wl.perm, torch.int64),
        inv=dev(wl.inv, torch.int64),
        positions=tuple(dev(a, torch.int32) for a in compact_lists(wl)),
    )
    sm = dev(smem_tables(tab, Vh.space.degree, dim))
    meta = dict(S=wl.S, W=wl.W, nb=nb, C=C, NL=nl, NQ=tab.nq, DIM=dim,
                n_pad=wl.n_pad, n_ext=n_ext)
    if device.type == "cuda":
        tabs["launch"] = _MomentumLaunch(
            tabs["lidx"], tabs["valid"], tabs["detj"], tabs["g4"], tabs["cg4"], sm,
            wl.S, wl.W, tabs["positions"], dim, tab.nq)
    return meta, tabs, sm, tab


def halo_transport_q(meta, tab, cells, cd_V, T_ext):
    """Blocked transport at the quadrature points, on one rank:
    T_ext [n_ext, DIM] -> Tq [nb, DIM*nq, C] float32."""
    t = tab.on(T_ext.dtype, T_ext.device)
    Xq = assembly.values_at_qp(t, T_ext[cd_V])  # [nc, nq, DIM]
    Tq = Xq.to(torch.float32)[cells]  # [nb, C, nq, DIM]
    return Tq.permute(0, 3, 2, 1).reshape(meta["nb"], meta["DIM"] * meta["NQ"],
                                          -1).contiguous()


def halo_state_q(meta, tab, cells, cd_V, G_cells, x_ext):
    """(Tq, Uq, Gu): the blocked Newton tables of one rank (Uq is Tq; Gu
    row (d*DIM+m)*nq+q holds d_d x_m, taken in float32). G_cells
    [c_loc, dim, dim] is the rank's geometry."""
    Tq = halo_transport_q(meta, tab, cells, cd_V, x_ext)
    dphi = tab.on(torch.float32, x_ext.device).dphi  # [nq, NL, dim]
    rgrad = torch.einsum("cjm,qjk->cqkm", x_ext[cd_V].to(torch.float32), dphi)
    gU = torch.einsum("cdk,cqkm->cdmq", G_cells.to(torch.float32), rgrad)
    Gu = gU[cells].permute(0, 2, 3, 4, 1)  # [nb, d, m, q, C]
    D, nq = meta["DIM"], meta["NQ"]
    return Tq, Tq, Gu.reshape(meta["nb"], D * D * nq, -1).contiguous()


def halo_window_momentum(meta, sm_tabs, t, v_ext, Tq, mass_w, s_rho, s_mu,
                         Uq=None, Gu=None):
    """One rank's momentum volume apply on its extended state:
    v_ext [n_ext, DIM] -> A v [n_ext, DIM] (the element contributions; the
    caller does the backward exchange). t: the rank's tables."""
    n_ext, DIM, n_pad = meta["n_ext"], meta["DIM"], meta["n_pad"]
    dev = v_ext.device
    xp = torch.zeros((DIM, n_pad), dtype=torch.float32, device=dev)
    xp[:, :n_ext] = v_ext[t["perm"]].T
    scal = torch.stack([torch.as_tensor(v, device=dev).to(torch.float32)
                        for v in (mass_w, s_rho, s_mu)])
    launch = t.get("launch")
    if launch is not None:
        out = launch(xp, Tq, scal, Uq, Gu)
    else:
        out = momentum_windows(xp, t["lidx"], t["valid"], t["detj"], t["g4"], t["cg4"],
                               Tq, sm_tabs, scal, meta["S"], meta["W"], t["positions"],
                               Uq, Gu)
    y = overlap_add_fn(out, meta["S"], meta["W"], n_ext)  # [DIM, n_ext] permuted
    return y[:, t["inv"]].T.contiguous().to(v_ext.dtype)
