# Window-blocked scalar operators on the uniform-stride layout of
# attic/window.py: the hand-written CUDA kernels that replace the Pallas
# kernels of flow_tpu/attic/winkernel.py, and their plain PyTorch versions:
#   - the consistent mass apply y = M x (WindowMassOperator, K4a,
#     csrc/winmass.cu), the mass right-hand side of implicit steps;
#   - the stiffness apply y = K x with K = int grad(u).grad(v)
#     (WindowStiffnessOperator, K4b, csrc/winstiff.cu), the pressure
#     operator of the window route (navier_stokes/fast.py, 2-D and 3-D) and
#     the operator of every large P1Hierarchy level (solvers/multigrid.py).
# Both take P1 and P2 spaces on triangles and tets. Like the JAX package, an
# apply computes in float32 whatever the caller's dtype and casts at the
# boundary.
#
# mass_windows and stiffness_windows launch their kernels for CUDA tensors
# and take the plain versions only for CPU tensors. K4a and the stiffness
# variants but 2-D P1 run as thread-block clusters (csrc/wincluster.cuh,
# shared with K5 in attic/winform.py and K3 in attic/winmom.py, whose
# launches cluster_launch plans too) that stage the local results in their
# shared memory at their scatter-list positions (the lists' inverse, the
# operators' `positions`; cluster_launch); the 2-D P1 stiffness (the Karman
# pressure operator) writes them to a device scratch and reads them back
# along the scatter lists (WindowStiffnessOperator.scatter). They count their
# launches in WINMASS.launches (K4a) and WINSTIFF.launches (K4b 2-D P1),
# WINSTIFF3D.launches (3-D P1), WINSTIFF_P2.launches (2-D P2) and
# WINSTIFF3D_P2.launches (3-D P2). WindowStiffnessOperator checks its
# tables and resolves its launch once, at construction (_StiffnessLaunch),
# so that an apply costs the host little more than the launch itself.
from __future__ import annotations

import ctypes
import functools
import time
from typing import NamedTuple

import numpy as np
import torch

from .._build import Kernel
from ..fem import assembly
from ..mesh3d import _device
from .window import build_scatter_lists, build_window_layout, position_lists

__all__ = ["WindowStiffnessOperator", "stiffness_windows",
           "stiffness_windows_plain", "cluster_plan", "window_plan", "momentum_plan",
           "cluster_launch", "ClusterLaunch", "MOMENTUM_CLUSTER", "MOMENTUM_THREADS",
           "MOMENTUM_LOC_BYTES",
           "WINSTIFF", "WINSTIFF3D", "WINSTIFF_P2", "WINSTIFF3D_P2",
           "CLUSTER_3D", "THREADS_3D", "LOC_BYTES_3D", "WINDOW_LOC_BYTES",
           "WINDOW_THREADS", "WINDOW_THREADS_FEW", "MAX_CLUSTER",
           "WindowMassOperator", "mass_windows", "mass_windows_plain", "WINMASS"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# K4b's variants: one library, an entry point and a count each. Every entry
# takes the launch's fixed arguments as one struct (_WinstiffArgs), then x,
# (2-D P1: its device scratch for the local results,) out and the stream;
# the cluster variants also have their occupancy query
WINSTIFF = Kernel("winstiff", {
    "winstiff_p1_2d": [_P] * 5,
})
WINSTIFF3D = Kernel("winstiff", {
    "winstiff_p1_3d": [_P] * 4,
    "winstiff_p1_3d_clusters": [_I] * 3 + [_P],
})
# the P2 variants (NL = 6 triangles, 10 tets)
WINSTIFF_P2 = Kernel("winstiff", {
    "winstiff_p2_2d": [_P] * 4,
    "winstiff_p2_2d_clusters": [_I] * 3 + [_P],
})
WINSTIFF3D_P2 = Kernel("winstiff", {
    "winstiff_p2_3d": [_P] * 4,
    "winstiff_p2_3d_clusters": [_I] * 3 + [_P],
})
# (DIM^2, NL) -> (kernel, entry point)
_ENTRIES = {
    (4, 3): (WINSTIFF, "winstiff_p1_2d"),
    (9, 4): (WINSTIFF3D, "winstiff_p1_3d"),
    (4, 6): (WINSTIFF_P2, "winstiff_p2_2d"),
    (9, 10): (WINSTIFF3D_P2, "winstiff_p2_3d"),
}
# winstiff_p1_3d's launch: blocks per cluster (one cluster per window
# block), threads per block (at most 512, the kernel's launch bounds), and
# the local results a block stages in one pass, in bytes. Chosen on the card
# at the cavity's N=64 pressure layout (chip_smoke.py's sweep; device us,
# L2 warm, H100 80GB HBM3, 700 W): 8 x 512 104.1, 8 x 384 108.9, 4 x 512
# 113.1, 8 x 256 129.4, 2 x 512 178.2 (two passes); the budget stages that
# layout's 95,832 local results in one pass of 8 blocks.
CLUSTER_3D = 8
THREADS_3D = 512
LOC_BYTES_3D = 96 * 1024
# K4a's, K5's and K4b P2's cluster launch (csrc/winmass.cu, winform.cu,
# winstiff.cu's P2 variants; window_plan):
# the local results a block stages in one pass (bytes), and the threads of
# a block where the blocks outnumber the card's SMs and where they do not.
# Chosen on the card (scripts/torch_window_cluster_bench.py --sweep; device
# µs of K4a / K5, H100 80GB HBM3, 700 W): at the NL = 10 layout (nb = 68,
# C = 3,038) one block of 1,024 threads a window block 32.1 / 64.6, one of
# 512 38.5 / 87.8, clusters of 2 x 512 38.0 / 72.9, 4 x 256 43.9 / 78.7,
# 2 x 1,024 45.3 / 90.8 (66 of the 68 clusters resident); at NL = 6 (nb =
# 1,026, C = 2,048) blocks of 512 113.8 / 206.3, 256 113.7 / 203.6, 1,024
# 132.3 / 229.0, clusters of 2 x 512 155.4 / 231.5.
WINDOW_LOC_BYTES = 128 * 1024
WINDOW_THREADS = 512
WINDOW_THREADS_FEW = 1024
MAX_CLUSTER = 8  # blocks a cluster, at most (portable cluster size)
# K3's cluster launch (csrc/winmom.cu in 2-D, winmom3d.cu in 3-D,
# attic/winmom.py; momentum_plan): blocks a cluster at least, threads a
# block (at most 512, the kernels' launch bounds), and the bytes a block
# stages in one pass (two or three floats a position; with the 3-D
# kernel's 14.4 KB of tables, at most the 227 KB a block may have). The
# least size binds no layout of the paths: their stages take two blocks in
# 3-D, and one block stages a 2-D window block.
MOMENTUM_CLUSTER = 1
MOMENTUM_THREADS = 512
MOMENTUM_LOC_BYTES = 208 * 1024
WINMASS = Kernel("winmass", {
    "winmass": [_P] * 8 + [_I] * 9 + [_P],
    "winmass_clusters": [_I] * 4 + [_P],
})
# the local-dof counts the window kernels are instantiated for
WINDOW_NL = (3, 4, 6, 10)


def scatter_windows_plain(loc, lidx, W):
    """Sum local results loc [nb, NL, C] into per-block windows [nb, W] at
    the window-local dofs lidx [nb, NL, C] (index_add_)."""
    nb = lidx.shape[0]
    out = loc.new_zeros(nb * W)
    rows = (torch.arange(nb, device=lidx.device) * W)[:, None, None] + lidx
    return out.index_add_(0, rows.reshape(-1).long(), loc.reshape(-1)).view(nb, W)


def gather_windows_plain(x_pad, lidx, S):
    """Window values u [nb, NL, C] = x_pad[b*S + lidx[b, j, c]]."""
    base = (torch.arange(lidx.shape[0], device=lidx.device) * S)[:, None, None]
    return x_pad[(base + lidx).long()]


def check_window_input(name, x_pad, device, n_pad):
    """The checks of a window kernel's input x_pad: contiguous float32 on
    the tables' `device`, n_pad = nb*S + W values."""
    if x_pad.device != device or not x_pad.is_contiguous():
        raise ValueError(f"{name}: tensors must be contiguous and on one device")
    if x_pad.dtype != torch.float32:
        raise TypeError(f"{name}: float tensors must be float32")
    if x_pad.numel() != n_pad:
        raise ValueError(f"{name}: inconsistent layout shapes")


def check_window_tables(name, lidx, valid, floats, lists, S, W):
    """The checks of a window kernel's tables: contiguous tensors on lidx's
    device, float32 and int32 where the kernels read them, and the layout's
    shapes. `floats` are the kernel's per-block tables and small reference
    tensors; `lists` the (rowptr, ent) scatter lists or the (rowptr, pos)
    positions the kernel reads."""
    nb, NL, C = lidx.shape
    if lists is None:
        raise ValueError(f"{name}: the kernel needs the layout's lists")
    rowptr, ent = lists
    for t in (lidx, valid, rowptr, ent, *floats):
        if t.device != lidx.device or not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous and on one device")
    if any(t.dtype != torch.float32 for t in (valid, *floats)):
        raise TypeError(f"{name}: float tensors must be float32")
    if any(t.dtype != torch.int32 for t in (lidx, rowptr, ent)):
        raise TypeError(f"{name}: index tensors must be int32")
    if (tuple(valid.shape) != (nb, C) or tuple(rowptr.shape) != (nb, W + 1)
            or tuple(ent.shape) != (nb, C * NL)
            or max(nb * S + W, ent.numel(), *(t.numel() for t in floats)) >= 2**31):
        raise ValueError(f"{name}: inconsistent layout shapes")


def check_window_args(name, x_pad, lidx, valid, floats, lists, S, W):
    """The checks every window kernel wrapper makes before its launch: those
    of its input (check_window_input) and of its tables
    (check_window_tables)."""
    nb = lidx.shape[0]
    check_window_input(name, x_pad, lidx.device, nb * S + W)
    check_window_tables(name, lidx, valid, floats, lists, S, W)


def stiffness_windows_plain(x_pad, lidx, valid, cg, kref, S, W):
    """Per-block output windows [nb, W] of the scalar stiffness apply.

    x_pad [nb*S + W] float32 (permuted, zero padded); lidx [nb, NL, C] int32;
    valid [nb, C]; cg [nb, DIM*DIM, C] with row DIM*k+l = C[c, k, l];
    kref [DIM*DIM*NL, NL] with row (DIM*k+l)*NL + i = Kref[k, l, i, :]."""
    NL = lidx.shape[1]
    d2 = cg.shape[1]
    u = gather_windows_plain(x_pad, lidx, S)  # [nb, NL, C]
    K = kref.reshape(d2, NL, NL)
    loc = torch.einsum("bkc,kij,bjc->bic", cg, K, u) * valid[:, None, :]
    return scatter_windows_plain(loc, lidx, W)


def cluster_plan(C, NL):
    """The entries one block of K4b 3-D's cluster launch of CLUSTER_3D
    blocks stages in a pass: all of a window block's C*NL at most, shared
    by the blocks, and at most LOC_BYTES_3D of float32."""
    return min(-(-C * NL // CLUSTER_3D), max(1, LOC_BYTES_3D // 4))


def window_plan(nb, C, NL, sms):
    """K4a's, K5's and K4b P2's cluster launch at a layout of nb window
    blocks of C cells on a card of `sms` SMs: (blocks a cluster CL, threads
    a block, entries a block stages in a pass). CL is the least size that
    stages a window block's C*NL local results in one pass of
    WINDOW_LOC_BYTES a block, at most MAX_CLUSTER (a layout whose results exceed MAX_CLUSTER
    blocks' stage runs in passes); blocks of WINDOW_THREADS_FEW threads
    where the nb*CL blocks are no more than the SMs, else WINDOW_THREADS."""
    entries = C * NL
    room = max(1, WINDOW_LOC_BYTES // 4)
    cl = min(MAX_CLUSTER, max(1, -(-entries // room)))
    threads = WINDOW_THREADS_FEW if nb * cl <= sms else WINDOW_THREADS
    return cl, threads, min(-(-entries // cl), room)


def momentum_plan(nb, C, NL, sms, resident=None, nc=3):
    """K3's cluster launch at a layout of nb window blocks of C cells (the
    arguments of window_plan): (blocks a cluster CL, threads a block,
    positions a block stages in a pass). A position holds the nc components
    of a local result (3 in 3-D, 2 in 2-D). CL is, of the sizes from the
    least that stages a window block's C*NL positions in one pass of
    MOMENTUM_LOC_BYTES a block (at least MOMENTUM_CLUSTER; passes compute
    every cell again) up to MAX_CLUSTER, the one whose one-wave grid gives
    a cluster the fewest window blocks, ceil(nb / resident clusters), and
    on a tie the fewest rounds of cells a block, ceil(C / CL /
    MOMENTUM_THREADS) a window block: a window block costs its cluster
    barriers, row sums and first loads on top of its rounds (the card's
    sweeps in PERF.md: at the Karman 1.9M layout one block of 512 a window
    block, 5 window blocks of two rounds, beat clusters of two, 9 of one).
    resident(CL, cap) is how many clusters of CL blocks staging cap
    positions each the card holds at once; where it is None, one block an
    SM."""
    def ceil(a, b):
        return -(-a // b)

    entries = C * NL
    room = max(1, MOMENTUM_LOC_BYTES // (4 * nc))
    least = min(MAX_CLUSTER, max(MOMENTUM_CLUSTER, ceil(entries, room)))
    threads = MOMENTUM_THREADS
    held = resident or (lambda cl, cap: sms // cl)

    def cap(cl):
        return min(ceil(entries, cl), room)

    def cost(cl):
        windows = ceil(nb, max(1, min(nb, held(cl, cap(cl)))))
        return windows, windows * ceil(ceil(C, cl), threads)

    cl = min(range(least, MAX_CLUSTER + 1), key=cost)
    return cl, threads, cap(cl)


class ClusterLaunch(NamedTuple):
    """A cluster kernel's launch at a layout."""
    cl: int  # blocks a cluster
    threads: int  # threads a block
    cap: int  # entries a block stages in a pass
    clusters: int  # clusters launched: one wave, each walks nb / clusters window blocks
    resident: int  # clusters the card holds at once (cudaOccupancyMaxActiveClusters)


def _launch_consts(kernel):
    """The module constants that a cluster kernel's launch follows."""
    if kernel is WINSTIFF3D:
        return CLUSTER_3D, THREADS_3D, LOC_BYTES_3D
    if kernel.name in ("winmom", "winmom3d"):
        return (momentum_plan, MOMENTUM_CLUSTER, MOMENTUM_THREADS, MOMENTUM_LOC_BYTES,
                MAX_CLUSTER)
    return window_plan, WINDOW_LOC_BYTES, WINDOW_THREADS, WINDOW_THREADS_FEW, MAX_CLUSTER


def cluster_launch(kernel, nb, C, NL, device):
    """The launch of a cluster kernel (WINSTIFF3D, WINSTIFF_P2,
    WINSTIFF3D_P2, WINMASS, winform.WINFORM, or K3's winmom.WINMOM,
    WINMOM_NEWTON, WINMOM3D and WINMOM3D_NEWTON) at a layout of nb window
    blocks of C cells on `device`: K4b 3-D P1's constants (CLUSTER_3D,
    THREADS_3D, cluster_plan), K3's rule (momentum_plan, with the card's answer of
    how many clusters of each size it holds), or the rule of K4a, K5 and
    K4b P2 (window_plan). It launches at most the clusters the card holds
    at once, so the grid is one wave and each cluster walks its share of the window
    blocks (csrc/wincluster.cuh); where the card's query refuses the
    configuration, nb clusters, whose launch then reports the error. Cached
    per layout and launch constants."""
    device = torch.device(device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    return _cluster_launch(kernel, nb, C, NL, index, _launch_consts(kernel))


@functools.lru_cache(maxsize=256)
def _cluster_launch(kernel, nb, C, NL, index, consts):
    momentum = kernel.name in ("winmom", "winmom3d")
    # the queries of K4b's variants, each instantiated at one NL, take no NL;
    # K3's takes the variant
    if momentum:
        lead = (int(any(fn.endswith("_newton") for fn in kernel.signatures)),)
    else:
        lead = () if kernel in (WINSTIFF3D, WINSTIFF_P2, WINSTIFF3D_P2) else (NL,)
    query = getattr(kernel.lib(), next(fn for fn in kernel.signatures
                                       if fn.endswith("_clusters")))

    def held(cl, threads, cap):
        """Clusters of the launch the card holds at once, 0 where it refuses."""
        out = ctypes.c_int(0)
        with torch.cuda.device(index):
            err = query(*lead, cl, threads, cap, ctypes.byref(out))
        return out.value if err == 0 else 0

    if kernel is WINSTIFF3D:
        cl, threads, cap = CLUSTER_3D, THREADS_3D, cluster_plan(C, NL)
    elif momentum:
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        cl, threads, cap = momentum_plan(
            nb, C, NL, sms, lambda cl_, cap_: held(cl_, MOMENTUM_THREADS, cap_),
            nc=3 if kernel.name == "winmom3d" else 2)
    else:
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        cl, threads, cap = window_plan(nb, C, NL, sms)
    resident = held(cl, threads, cap)
    return ClusterLaunch(cl, threads, cap, min(nb, resident) if resident > 0 else nb,
                         resident)


class _WinstiffArgs(ctypes.Structure):
    """The fixed arguments of a csrc/winstiff.cu launch (struct
    WinstiffArgs): the tables' pointers, the layout and, for the cluster
    variants, the launch."""
    _fields_ = ([(name, ctypes.c_void_p) for name in
                 ("lidx", "valid", "cg", "kref", "kref_host", "rowptr", "lists")]
                + [(name, ctypes.c_int)
                   for name in ("nb", "S", "W", "C", "clusters", "cl", "threads", "cap")])


class _StiffnessLaunch:
    """K4b's launch at fixed tables (see stiffness_windows): the tables are
    checked once, here, and their pointers kept in a _WinstiffArgs struct
    with the entry point and, for a cluster variant, its launch, so that a
    call checks only x_pad and allocates only the output (and 2-D P1's
    scratch). The P2 kernels take Kref as a kernel parameter, so the launch
    keeps a host copy of it. The launch follows the module's launch
    constants: a call that finds them changed plans again. The tables must
    not change while the launch lives (it holds them, and their
    pointers)."""

    def __init__(self, lidx, valid, cg, kref, S, W, scatter, positions):
        nb, NL, C = lidx.shape
        d2 = cg.shape[1]
        if (d2, NL) not in _ENTRIES:
            raise ValueError(
                f"stiffness_windows: the kernels take P1 and P2 on triangles and "
                f"tets (DIM^2, NL) in {sorted(_ENTRIES)}, got ({d2}, {NL})"
            )
        self.kernel, self.entry = _ENTRIES[(d2, NL)]
        self.cluster = self.kernel is not WINSTIFF
        lists = positions if self.cluster else scatter
        check_window_tables("stiffness_windows", lidx, valid, (cg, kref), lists, S, W)
        if tuple(cg.shape) != (nb, d2, C) or kref.numel() != d2 * NL * NL:
            raise ValueError("stiffness_windows: inconsistent layout shapes")
        # the P2 kernels read Kref from their parameters, copied from host memory
        self.kref_host = (kref.cpu().contiguous()
                          if self.kernel in (WINSTIFF_P2, WINSTIFF3D_P2) else None)
        self.tables = (lidx, valid, cg, kref, *lists)
        self.device = lidx.device
        self.layout = (nb, C, NL)
        self.n_pad = nb * S + W
        # the output (and 2-D P1's scratch) by empty_like of one value
        # expanded to its shape: contiguous, at a fraction of torch.empty's
        # host cost
        one = torch.empty(1, dtype=torch.float32, device=self.device)
        self.out_like = one.expand(nb, W)
        self.scratch_like = None if self.cluster else one.expand(nb, C * NL)
        self.args = _WinstiffArgs(
            lidx.data_ptr(), valid.data_ptr(), cg.data_ptr(), kref.data_ptr(),
            None if self.kref_host is None else self.kref_host.data_ptr(),
            lists[0].data_ptr(), lists[1].data_ptr(), nb, S, W, C)
        self.argp = ctypes.c_void_p(ctypes.addressof(self.args))
        self.consts = None

    def _plan(self, consts):
        nb, C, NL = self.layout
        plan = _cluster_launch(self.kernel, nb, C, NL, self.device.index, consts)
        a = self.args
        a.clusters, a.cl, a.threads, a.cap = (plan.clusters, plan.cl, plan.threads,
                                              plan.cap)
        self.consts = consts

    def __call__(self, x_pad):
        device = self.device
        if (x_pad.device != device or x_pad.dtype != torch.float32
                or not x_pad.is_contiguous() or x_pad.numel() != self.n_pad):
            check_window_input("stiffness_windows", x_pad, device, self.n_pad)
        if self.cluster:
            consts = _launch_consts(self.kernel)
            if consts != self.consts:
                self._plan(consts)
        out = torch.empty_like(self.out_like)
        if self.cluster:
            args = (self.argp, x_pad.data_ptr(), out.data_ptr())
        else:
            scratch = torch.empty_like(self.scratch_like)
            args = (self.argp, x_pad.data_ptr(), scratch.data_ptr(), out.data_ptr())
        index = device.index
        if index == torch.cuda.current_device():
            self.kernel.launch(self.entry, *args, torch._C._cuda_getCurrentRawStream(index))
        else:
            with torch.cuda.device(index):
                self.kernel.launch(self.entry, *args,
                                   torch._C._cuda_getCurrentRawStream(index))
        return out


def stiffness_windows(x_pad, lidx, valid, cg, kref, S, W, scatter=None,
                      positions=None):
    """Per-block output windows [nb, W] of the scalar stiffness apply (see
    stiffness_windows_plain). CPU tensors take the plain version; CUDA
    tensors launch the kernel, after checking every argument. The 2-D P1
    kernel reads `scatter` = (rowptr, ent) tensors: it writes the local
    results to a device scratch [nb, C*NL], so any C fits, and sums each
    window dof along its list. The others read `positions` = (rowptr, pos)
    tensors, pos the inverse of the layout's scatter lists
    (window.scatter_positions): each cell stores its local results at
    their list positions in the shared memory of a cluster of blocks
    (cluster_launch: CLUSTER_3D blocks of THREADS_3D threads for 3-D P1,
    window_plan's rule for P2), in passes where they exceed it, and each
    row sums its positions in order. The P2 kernels take Kref as a kernel
    parameter, so a call copies it to the host (WindowStiffnessOperator
    does so once)."""
    if x_pad.device.type == "cpu":
        return stiffness_windows_plain(x_pad, lidx, valid, cg, kref, S, W)
    if x_pad.device.type != "cuda":
        raise ValueError(f"stiffness_windows: no kernel for device {x_pad.device}")
    return _StiffnessLaunch(lidx, valid, cg, kref, S, W, scatter, positions)(x_pad)


class WindowStiffnessOperator:
    """Scalar stiffness apply on the window layout of a P1 or P2 space on
    triangles or tets (the pressure-Poisson and multigrid-level operator).
    Tables live in float32 on `device` (default: the mesh's) and do not
    change after construction. apply(x) takes x [n] in the original
    numbering, in any float dtype, and returns K x in that dtype. On the
    card the operator holds the lists its kernel reads (see
    stiffness_windows): `scatter` for 2-D P1, `positions` for the others;
    the other is None. Its tables are checked, and its launch resolved,
    once here: windows() then checks only its input. layout_seconds: the
    host seconds of the layout, its tables and scatter lists."""

    def __init__(self, space, S=None, device=None):
        self.space = space
        t0 = time.perf_counter()
        wl = build_window_layout(space, S=S)
        self.wl = wl
        self.device = space.mesh.device if device is None else _device(device)
        dim = assembly._dim(space)
        geom = assembly.geometry(space.mesh)
        cells = np.asarray(wl.cells, dtype=np.int64)
        cg = geom.C[cells]  # [nb, C, dim, dim]
        kref = assembly.ref_stiffness(space.degree, dim)
        nl = kref.shape[-1]

        def dev(a, dtype=torch.float32):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=self.device)

        # [nb, dim^2, C] with row dim*k+l
        self.Cg = dev(np.transpose(cg, (0, 2, 3, 1)).reshape(wl.nb, dim * dim, -1))
        # row (dim*k+l)*NL + i -> Kref[k, l, i, :]
        self.kref = dev(kref.reshape(dim * dim * nl, nl))
        self.lidx = dev(np.transpose(wl.lidx, (0, 2, 1)), torch.int32)
        self.valid = dev(wl.valid)
        self.perm = dev(wl.perm, torch.int64)
        self.inv = dev(wl.inv, torch.int64)
        self.scatter = self.positions = self._launch = None
        if self.device.type == "cuda":
            if _ENTRIES.get((dim * dim, nl), (None,))[0] is WINSTIFF:
                self.scatter = tuple(dev(a, torch.int32) for a in build_scatter_lists(wl))
            else:
                self.positions = tuple(dev(a, torch.int32) for a in position_lists(wl))
            self._launch = _StiffnessLaunch(self.lidx, self.valid, self.Cg, self.kref,
                                            wl.S, wl.W, self.scatter, self.positions)
        self.layout_seconds = time.perf_counter() - t0

    def windows(self, x_pad):
        """[nb*S + W] float32 permuted, padded input -> [nb, W] windows."""
        if self._launch is not None:
            return self._launch(x_pad)
        wl = self.wl
        return stiffness_windows(x_pad, self.lidx, self.valid, self.Cg,
                                 self.kref, wl.S, wl.W, self.scatter, self.positions)

    def apply(self, x):
        wl = self.wl
        x_pad = x.new_zeros(wl.n_pad, dtype=torch.float32)
        x_pad[:wl.n] = x[self.perm]
        yw = wl.overlap_add(self.windows(x_pad))
        return yw[self.inv].to(x.dtype)


def mass_windows_plain(x_pad, lidx, valid, detj, mref, S, W):
    """Per-block output windows [nb, W] of the consistent mass apply.

    x_pad [nb*S + W] float32 (permuted, zero padded); lidx [nb, NL, C]
    int32; valid, detj [nb, C]; mref [NL, NL] = Mref[i, j]."""
    u = gather_windows_plain(x_pad, lidx, S)  # [nb, NL, C]
    loc = torch.einsum("ij,bjc->bic", mref, u) * (detj * valid)[:, None, :]
    return scatter_windows_plain(loc, lidx, W)


def mass_windows(x_pad, lidx, valid, detj, mref, S, W, positions=None):
    """Per-block output windows [nb, W] of the consistent mass apply (see
    mass_windows_plain). CPU tensors take the plain version; CUDA tensors
    launch the kernel (csrc/winmass.cu), which reads `positions` =
    (rowptr, pos) tensors, pos the inverse of the layout's scatter lists
    (window.position_lists): each cell stores its local results at their
    list positions in the shared memory of a cluster of blocks
    (cluster_launch), in passes where they exceed it, and each row sums
    its positions in order."""
    if x_pad.device.type == "cpu":
        return mass_windows_plain(x_pad, lidx, valid, detj, mref, S, W)
    if x_pad.device.type != "cuda":
        raise ValueError(f"mass_windows: no kernel for device {x_pad.device}")
    nb, NL, C = lidx.shape
    if NL not in WINDOW_NL:
        raise ValueError(f"mass_windows: the kernel takes NL in {WINDOW_NL}, got {NL}")
    check_window_args("mass_windows", x_pad, lidx, valid, (detj, mref), positions, S, W)
    if tuple(detj.shape) != (nb, C) or tuple(mref.shape) != (NL, NL):
        raise ValueError("mass_windows: inconsistent layout shapes")
    rowptr, pos = positions
    out = torch.empty((nb, W), dtype=torch.float32, device=x_pad.device)
    plan = cluster_launch(WINMASS, nb, C, NL, x_pad.device)
    with torch.cuda.device(x_pad.device):
        stream = torch.cuda.current_stream().cuda_stream
        WINMASS.launch("winmass", x_pad.data_ptr(), lidx.data_ptr(), valid.data_ptr(),
                       detj.data_ptr(), mref.data_ptr(), rowptr.data_ptr(),
                       pos.data_ptr(), out.data_ptr(), nb, S, W, C, NL, plan.clusters,
                       plan.cl, plan.threads, plan.cap, stream)
    return out


class WindowMassOperator:
    """Consistent scalar mass apply on the window layout of a P1 or P2 space
    on triangles or tets. Tables live in float32 on `device` (default: the
    mesh's). apply(x) takes a scalar x [n] in the original numbering, in any
    float dtype, and returns M x in that dtype (the same vector as
    assembly.mass_apply at float32 level). On the card the operator holds
    the lists its kernel reads, `positions` (see mass_windows).
    layout_seconds: the host seconds of the layout, its tables and lists."""

    def __init__(self, space, S=None, device=None):
        self.space = space
        t0 = time.perf_counter()
        wl = build_window_layout(space, S=S)
        self.wl = wl
        self.device = space.mesh.device if device is None else _device(device)
        geom = assembly.geometry(space.mesh)
        cells = np.asarray(wl.cells, dtype=np.int64)

        def dev(a, dtype=torch.float32):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=self.device)

        self.detj = dev(geom.detJ[cells])
        self.mref = dev(assembly.ref_mass(space.degree, assembly._dim(space)))
        self.lidx = dev(np.transpose(wl.lidx, (0, 2, 1)), torch.int32)
        self.valid = dev(wl.valid)
        self.perm = dev(wl.perm, torch.int64)
        self.inv = dev(wl.inv, torch.int64)
        self.positions = None
        if self.device.type == "cuda":
            self.positions = tuple(dev(a, torch.int32) for a in position_lists(wl))
        self.layout_seconds = time.perf_counter() - t0

    def windows(self, x_pad):
        """[nb*S + W] float32 permuted, padded input -> [nb, W] windows."""
        wl = self.wl
        return mass_windows(x_pad, self.lidx, self.valid, self.detj, self.mref,
                            wl.S, wl.W, self.positions)

    def apply(self, x):
        wl = self.wl
        x_pad = x.new_zeros(wl.n_pad, dtype=torch.float32)
        x_pad[:wl.n] = x[self.perm]
        yw = wl.overlap_add(self.windows(x_pad))
        return yw[self.inv].to(x.dtype)
