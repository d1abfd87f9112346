# The box stepper's lagged momentum operator
#   y = [M + s_mu (grad u + grad u^T : grad v) + s_rho skew-conv(T)] x
# on the box-packed P2 layout of fem/boxpack.py, as one hand-written CUDA
# kernel (csrc/boxmom.cu) beside its plain version, BoxPack.momentum_apply on
# the tables of BoxPack.conv_tables.
#
# box_momentum_apply launches the kernel for CUDA tensors and takes the plain
# version only for CPU tensors; any other device raises. It counts its
# launches in BOX_MOMENTUM.launches, so that a run can show that its main
# path went through the kernel. BoxMomentum is the kernel's launch for one
# BoxPack: its constants on the card and its arguments, fixed once, so that
# a call checks its inputs and allocates the output and the tile sums.
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from .._build import Kernel
from ..fem import elements

__all__ = ["BOX_MOMENTUM", "BoxMomentum", "box_momentum_apply", "momentum_constants",
           "stress_rule"]

_P = ctypes.c_void_p
_ARGS = [_P, _P, _P, _P, _P, _P]  # args struct, x, T, y, tile sums, stream
BOX_MOMENTUM = Kernel("boxmom", {"boxmom_f32": _ARGS, "boxmom_f64": _ARGS})
_ENTRIES = {torch.float32: "boxmom_f32", torch.float64: "boxmom_f64"}
# the cubes of a tile by dtype (csrc/boxmom.cu's entries)
_TILES = {torch.float32: (4, 4, 8), torch.float64: (4, 4, 4)}
# the layout of the constants (csrc/boxmom.cu kQRec, kSRec, kTypeRec)
_QREC, _SREC, _TYPEREC = 52, 32, 12


def stress_rule():
    """(points [4, 3], weights [4]): the 4-point rule on the reference
    tetrahedron, exact for quadratics, so for the products of two P2
    gradients that the stress integrates."""
    a = (5.0 - math.sqrt(5.0)) / 20.0
    b = 1.0 - 3.0 * a
    pts = np.array([[a, a, a], [b, a, a], [a, b, a], [a, a, b]])
    return pts, np.full(4, 1.0 / 24.0)


def momentum_constants(bp):
    """The kernel's tables of a BoxPack, float64 [1604]: a 52-value record
    at each point of the convection rule (phi [10], dphi [10, 3], w phi
    [10], w, 0), a 32-value record at each point of stress_rule (dphi [10,
    3], w, 0) and a 12-value record a tet type (G [3, 3], detJ, 0, 0)."""
    nq = len(bp.qw)
    q = np.zeros((nq, _QREC))
    q[:, :10] = bp.phi
    q[:, 10:40] = bp.dphi.reshape(nq, 30)
    q[:, 40:50] = bp.qw[:, None] * bp.phi
    q[:, 50] = bp.qw
    pts, w = stress_rule()
    _, dphi2 = elements.tabulate(2, pts, dim=3)
    s = np.zeros((len(w), _SREC))
    s[:, :30] = np.asarray(dphi2).reshape(len(w), 30)
    s[:, 30] = w
    ty = np.zeros((len(bp.types), _TYPEREC))
    for t, typ in enumerate(bp.types):
        ty[t, :9] = typ["G"].reshape(9)
        ty[t, 9] = typ["detJ"]
    return np.concatenate([q.ravel(), s.ravel(), ty.ravel()])


def _local_codes(bp):
    """Each type's local dof offsets o in {0, 1, 2}^3 as ox * 9 + oy * 3 + oz,
    after checking the order that the kernel's four phases of adds rely on:
    the four vertices first (even offsets), then six edge midpoints whose
    parities differ from each other and from the vertices'."""
    codes = np.zeros((len(bp.types), 10), dtype=np.uint8)
    for t, typ in enumerate(bp.types):
        o = np.asarray(typ["off2"])
        parity = {tuple(v) for v in o[4:] % 2}
        if (o[:4] % 2).any() or len(parity) != 6 or (0, 0, 0) in parity:
            raise ValueError(f"BoxMomentum: tet type {t} has local dofs {o.tolist()}")
        codes[t] = o[:, 0] * 9 + o[:, 1] * 3 + o[:, 2]
    return codes


class _BoxMomArgs(ctypes.Structure):
    """The arguments of a launch (struct BoxMomArgs of csrc/boxmom.cu)."""
    _fields_ = ([(name, ctypes.c_int) for name in ("nx", "ny", "nz", "ntx", "nty", "ntz", "n2")]
                + [("off", ctypes.c_int * 8), ("loc", (ctypes.c_ubyte * 10) * 6),
                   ("smu", ctypes.c_double), ("srho", ctypes.c_double),
                   ("smu_ptr", ctypes.c_void_p), ("srho_ptr", ctypes.c_void_p),
                   ("consts", ctypes.c_void_p)])


def _cdiv(a, b):
    return -(-a // b)


class BoxMomentum:
    """The kernel's launch for one BoxPack on the card (its dtype, float32
    or float64, and its indexed CUDA device): the constants as a device
    tensor held here, the tiles and the arguments fixed once."""

    def __init__(self, bp):
        dtype, device = bp.dtype, bp.device
        if dtype not in _ENTRIES:
            raise TypeError(f"BoxMomentum: want float32 or float64, got {dtype}")
        if device.type != "cuda":
            raise ValueError(f"BoxMomentum: no kernel for device {device}")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.dtype, self.device, self.n = dtype, device, 3 * bp.n2
        nx, ny, nz = bp.Ns
        tiles = [_cdiv(n, t) for n, t in zip(bp.Ns, _TILES[dtype])]
        self.tile_values = 3 * math.prod(2 * t + 1 for t in _TILES[dtype]) * math.prod(tiles)
        if self.n >= 2**31 or self.tile_values >= 2**31:
            raise ValueError(f"BoxMomentum: box {bp.Ns} is too large for 32-bit indices")
        self.consts = torch.as_tensor(momentum_constants(bp), dtype=dtype, device=device)
        self.args = _BoxMomArgs(nx=nx, ny=ny, nz=nz, ntx=tiles[0], nty=tiles[1], ntz=tiles[2],
                                n2=bp.n2, consts=self.consts.data_ptr())
        self.args.off[:] = [int(o) for o in bp.offsets[:8]]
        for t, row in enumerate(_local_codes(bp)):
            self.args.loc[t][:] = [int(c) for c in row]
        self.entry = _ENTRIES[dtype]

    def _scale(self, v, name):
        """(host value, device pointer, tensor to hold) of a scale: a number
        or a 0-d tensor (a host one is read on the host; a device one is
        read by the kernel, in the state dtype)."""
        if not torch.is_tensor(v):
            return float(v), None, None
        if v.numel() != 1:
            raise ValueError(f"box_momentum_apply: {name} must be one value, got {tuple(v.shape)}")
        if v.device.type == "cpu":
            return float(v), None, None
        if v.device != self.device:
            raise ValueError(f"box_momentum_apply: {name} on {v.device}, the state on {self.device}")
        v = v.to(self.dtype).contiguous()
        return 0.0, v.data_ptr(), v

    def __call__(self, Tf, Xf, s_mu, s_rho):
        for name, v in (("Tf", Tf), ("Xf", Xf)):
            if v.device != self.device:
                raise ValueError(f"box_momentum_apply: {name} on {v.device}, want {self.device}")
            if v.dtype != self.dtype:
                raise TypeError(f"box_momentum_apply: {name} is {v.dtype}, want {self.dtype}")
            if tuple(v.shape) != (self.n,):
                raise ValueError(f"box_momentum_apply: {name} has shape {tuple(v.shape)}, "
                                 f"want ({self.n},)")
            if not v.is_contiguous():
                raise ValueError(f"box_momentum_apply: {name} must be contiguous")
        a = self.args
        # held_* keep the scales' device copies alive through the launch
        a.smu, a.smu_ptr, held_mu = self._scale(s_mu, "s_mu")
        a.srho, a.srho_ptr, held_rho = self._scale(s_rho, "s_rho")
        y = torch.empty(self.n, dtype=self.dtype, device=self.device)
        tile_sums = torch.empty(self.tile_values, dtype=self.dtype, device=self.device)
        index = self.device.index
        with torch.cuda.device(index):
            BOX_MOMENTUM.launch(self.entry, ctypes.addressof(a), Xf.data_ptr(), Tf.data_ptr(),
                                y.data_ptr(), tile_sums.data_ptr(),
                                torch._C._cuda_getCurrentRawStream(index))
        return y


def box_momentum_apply(bp, Tf, Xf, s_mu, s_rho):
    """y = [M + s_mu stress + s_rho skew-conv(Tf)] Xf on BoxPack bp's packed
    layout: Tf, Xf flat [3 n2] in bp's dtype and on its device; s_mu, s_rho
    numbers or 0-d tensors. CUDA tensors go through the hand-written kernel
    (bp.momentum_launch()), CPU tensors through the plain
    bp.momentum_apply(bp.conv_tables(Tf), Xf, s_mu, s_rho); any other
    device raises."""
    if Xf.device.type == "cpu" and Tf.device.type == "cpu":
        return bp.momentum_apply(bp.conv_tables(Tf), Xf, s_mu, s_rho)
    if Xf.device.type != "cuda":
        raise ValueError(f"box_momentum_apply: no kernel for device {Xf.device}")
    return bp.momentum_launch()(Tf, Xf, s_mu, s_rho)
