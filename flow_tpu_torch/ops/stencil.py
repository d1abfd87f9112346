# Constant-coefficient stencils on structured grids: the hand-written CUDA
# kernels that replace the Pallas kernels of flow_tpu/ops/pallas_stencil.py,
# and their plain PyTorch versions:
#   - stencil_apply_3d, 27 points (csrc/stencil3d.cu, K1);
#   - stencil_apply_2d, 9 points (csrc/stencil2d.cu, K2).
#
# Each wrapper launches its kernel for a CUDA tensor and takes the plain
# version only for a CPU tensor; any other device raises. It counts its
# launches in STENCIL_3D.launches or STENCIL_2D.launches, and by grid in
# GRID_LAUNCHES, so a run can show that its main path went through the
# kernel, and on which levels. Both launch on every grid size: the JAX
# package's size gate for the Pallas kernel is a TPU decision.
#
# The kernels march tiles along the slowest axis (plan_2d, plan_3d size
# them); StencilLaunch is the launch of one operator at a fixed grid with
# fixed coefficients, which StructuredLaplacian keeps so that a call checks
# only its input.
from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import itertools
import math
from typing import NamedTuple

import torch

from .._build import Kernel

__all__ = ["stencil_apply_3d", "stencil_apply_3d_plain", "STENCIL_3D",
           "stencil_apply_2d", "stencil_apply_2d_plain", "STENCIL_2D",
           "GRID_LAUNCHES", "StencilPlan", "plan_2d", "plan_3d", "StencilLaunch"]


_P = ctypes.c_void_p
_ARGS = [_P, _P, _P, _P]  # args struct, x, y, stream
STENCIL_3D = Kernel("stencil3d", {"stencil27_f32": _ARGS, "stencil27_f64": _ARGS})
STENCIL_2D = Kernel("stencil2d", {"stencil9_f32": _ARGS, "stencil9_f64": _ARGS})
# launches by grid shape, of both kernels
GRID_LAUNCHES: collections.Counter = collections.Counter()

# dim -> (kernel, {dtype: entry point})
_ENTRIES = {
    3: (STENCIL_3D, {torch.float32: "stencil27_f32", torch.float64: "stencil27_f64"}),
    2: (STENCIL_2D, {torch.float32: "stencil9_f32", torch.float64: "stencil9_f64"}),
}

# The launch rules' constants (from the H100 sweeps of
# scripts/torch_stencil_bench.py, see PERF.md):
# 2-D: threads a tile at most and rows a strip; strips are halved, down to
# STENCIL2D_MIN_ROWS, until the grid has STENCIL_BLOCKS_PER_SM blocks an SM.
STENCIL2D_THREADS = 128
STENCIL2D_ROWS = 16
STENCIL2D_MIN_ROWS = 4
# 3-D: threads of a tile at most and its z-extent at most; x is cut into
# as many chunks (of STENCIL3D_MIN_ROWS planes or more) as one wave of
# STENCIL_BLOCKS_PER_SM blocks an SM holds: at ~110 registers a thread two
# blocks of up to 256 threads fit an SM, and a second wave costs more than
# longer chunks
STENCIL3D_THREADS = 256
STENCIL3D_TILE_Z = 128
STENCIL3D_MIN_ROWS = 2
STENCIL_BLOCKS_PER_SM = 2
# the kernels' limits (csrc/stencil2d.cu, stencil3d.cu)
_MAX_THREADS = {2: 512, 3: 256}
_SLOTS = 4  # staged cells a thread copies a plane (stencil3d.cu kSlots)
_STAGES = 3  # planes of the shared ring (stencil3d.cu kStages)
_MAX_GRID_YZ = 65535
_OWNED = 30  # columns a warp owns (stencil2d.cu kOwned)


class StencilPlan(NamedTuple):
    """A stencil launch: grid and block dims, rows of a strip (2-D) or
    planes of a chunk (3-D), the (y, z) tile a block owns (3-D; 2-D: (1,
    columns)) and the dynamic shared memory a block in items of the
    dtype."""
    grid: tuple
    threads: int
    rows: int
    tile: tuple
    smem_items: int


def _cdiv(a, b):
    return -(-a // b)


def _balanced(n, most):
    """(parts, size): the fewest parts of at most `most` that cover n, each
    of the same size."""
    parts = _cdiv(n, most)
    return parts, _cdiv(n, parts)


def plan_2d(X, Y, sms, tile=None, rows=None):
    """K2's launch on an [X, Y] grid: a block of `tile` threads (a multiple
    of 32; default: the balanced tiles of at most STENCIL2D_THREADS) owns
    30 columns a warp (lanes 1-30; lanes 0 and 31 load the columns either
    side) and marches down a strip of `rows` rows (default: STENCIL2D_ROWS,
    halved down to STENCIL2D_MIN_ROWS while the grid has fewer than
    STENCIL_BLOCKS_PER_SM blocks an SM of the `sms`)."""
    if tile is None:
        warps = _balanced(_cdiv(Y, _OWNED), STENCIL2D_THREADS // 32)[1]
        tile = 32 * warps
    owned = tile // 32 * _OWNED
    nj = _cdiv(Y, owned)
    if rows is None:
        rows = STENCIL2D_ROWS
        while rows > STENCIL2D_MIN_ROWS and nj * _cdiv(X, rows) < STENCIL_BLOCKS_PER_SM * sms:
            rows //= 2
    rows = max(rows, _cdiv(X, _MAX_GRID_YZ))
    if tile % 32 or not 0 < tile <= _MAX_THREADS[2] or rows < 1:
        raise ValueError(f"plan_2d: no launch of {tile} threads and {rows} rows")
    return StencilPlan((nj, _cdiv(X, rows), 1), tile, rows, (1, owned), 0)


def plan_3d(X, Y, Z, sms, tile=None, rows=None):
    """K1's launch on an [X, Y, Z] grid: a block owns a (y, z) `tile`
    (default: z in balanced tiles of at most STENCIL3D_TILE_Z, y in
    balanced tiles of at most STENCIL3D_THREADS / z points) with a thread a
    point (rounded up to a warp), and marches along x over chunks of `rows`
    planes (default: the most chunks of STENCIL3D_MIN_ROWS planes or more
    that one wave of STENCIL_BLOCKS_PER_SM blocks an SM of the `sms`
    holds). Its shared memory is a ring of three planes of the tile
    with a one-point halo."""
    if tile is None:
        _, tz = _balanced(Z, STENCIL3D_TILE_Z)
        _, ty = _balanced(Y, max(1, STENCIL3D_THREADS // tz))
        tile = (ty, tz)
    ty, tz = tile
    tiles = _cdiv(Y, ty) * _cdiv(Z, tz)
    if rows is None:
        chunks = min(X, max(1, STENCIL_BLOCKS_PER_SM * sms // tiles))
        rows = max(STENCIL3D_MIN_ROWS, _cdiv(X, chunks))
    rows = max(rows, _cdiv(X, _MAX_GRID_YZ))
    threads = 32 * _cdiv(ty * tz, 32)
    cells = (ty + 2) * (tz + 2)
    if (threads > _MAX_THREADS[3] or cells > _SLOTS * threads or rows < 1
            or _cdiv(Y, ty) > _MAX_GRID_YZ):
        raise ValueError(f"plan_3d: no launch of tile {tile} and {rows} planes")
    return StencilPlan((_cdiv(Z, tz), _cdiv(Y, ty), _cdiv(X, rows)), threads, rows, tile,
                       _STAGES * cells)


def plan(shape, sms):
    """The launch of the kernel of len(shape) dims on `shape`."""
    return plan_3d(*shape, sms) if len(shape) == 3 else plan_2d(*shape, sms)


@functools.lru_cache(maxsize=None)
def _sms(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


class _StencilArgs(ctypes.Structure):
    """The arguments of a stencil launch (struct StencilArgs of
    csrc/stencil.cuh)."""
    _fields_ = ([("kdev", ctypes.c_void_p)]
                + [(name, ctypes.c_int) for name in
                   ("X", "Y", "Z", "rows", "tile_y", "tile_z", "grid_x", "grid_y",
                    "grid_z", "threads", "smem")])


def _args(shape, p, kernel):
    """A _StencilArgs of launch plan `p` on `shape`, with the coefficients
    of the contiguous device tensor `kernel`."""
    X, Y, Z = (*shape, 1) if len(shape) == 2 else shape
    return _StencilArgs(kdev=kernel.data_ptr(), X=X, Y=Y, Z=Z, rows=p.rows,
                        tile_y=p.tile[0], tile_z=p.tile[1], grid_x=p.grid[0],
                        grid_y=p.grid[1], grid_z=p.grid[2], threads=p.threads,
                        smem=p.smem_items * kernel.element_size())


def _plain(xgrid, kernel):
    """The sum of 3^dim shifted slices of a zero-padded copy, offsets in
    lexicographic order. No convolution library is involved, so it is
    independent of cuDNN and TF32."""
    shape = xgrid.shape
    xp = xgrid.new_zeros(tuple(s + 2 for s in shape))
    xp[(slice(1, -1),) * xgrid.dim()] = xgrid
    y = torch.zeros_like(xgrid)
    for d in itertools.product(range(3), repeat=xgrid.dim()):
        y += kernel[d] * xp[tuple(slice(o, o + s) for o, s in zip(d, shape))]
    return y


def stencil_apply_3d_plain(xgrid, kernel):
    """y[i,j,k] = sum_{d in {-1,0,1}^3} kernel[d] * x[i+d] (zero padded)."""
    return _plain(xgrid, kernel)


def stencil_apply_2d_plain(xgrid, kernel):
    """y[i,j] = sum_{d in {-1,0,1}^2} kernel[d] * x[i+d] (zero padded)."""
    return _plain(xgrid, kernel)


def _apply(name, dim, xgrid, kernel):
    if xgrid.device.type == "cpu" and kernel.device.type == "cpu":
        return _plain(xgrid, kernel)
    if xgrid.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {xgrid.device}")
    if kernel.device != xgrid.device:
        raise ValueError(f"{name}: xgrid and kernel on different devices")
    if xgrid.dim() != dim or tuple(kernel.shape) != (3,) * dim:
        raise ValueError(
            f"{name}: want a {dim}-D xgrid and kernel {(3,) * dim}, got "
            f"{tuple(xgrid.shape)} and {tuple(kernel.shape)}"
        )
    launcher, entries = _ENTRIES[dim]
    if xgrid.dtype not in entries or kernel.dtype != xgrid.dtype:
        raise TypeError(
            f"{name}: want float32 or float64 of one dtype, got "
            f"{xgrid.dtype} and {kernel.dtype}"
        )
    if not (xgrid.is_contiguous() and kernel.is_contiguous()):
        raise ValueError(f"{name}: xgrid and kernel must be contiguous")
    if min(xgrid.shape) < 1 or xgrid.numel() >= 2**31:
        raise ValueError(f"{name}: unsupported grid {tuple(xgrid.shape)}")
    shape = tuple(xgrid.shape)
    index = xgrid.device.index
    args = _args(shape, plan(shape, _sms(index)), kernel)
    y = torch.empty_like(xgrid)
    with torch.cuda.device(index):
        launcher.launch(entries[xgrid.dtype], ctypes.addressof(args), xgrid.data_ptr(),
                        y.data_ptr(), torch._C._cuda_getCurrentRawStream(index))
    GRID_LAUNCHES[shape] += 1
    return y


def stencil_apply_3d(xgrid, kernel):
    """y[i,j,k] = sum_{d in {-1,0,1}^3} kernel[d] * x[i+d] (zero padded).

    xgrid: [X, Y, Z] float32/float64; kernel: [3, 3, 3], same dtype and
    device. CUDA tensors go through the hand-written kernel; CPU tensors
    through stencil_apply_3d_plain."""
    return _apply("stencil_apply_3d", 3, xgrid, kernel)


def stencil_apply_2d(xgrid, kernel):
    """y[i,j] = sum_{d in {-1,0,1}^2} kernel[d] * x[i+d] (zero padded).

    xgrid: [X, Y] float32/float64; kernel: [3, 3], same dtype and device.
    CUDA tensors go through the hand-written kernel; CPU tensors through
    stencil_apply_2d_plain."""
    return _apply("stencil_apply_2d", 2, xgrid, kernel)


class StencilLaunch:
    """The stencil of one operator on the card: the kernel on a fixed grid
    (2-D or 3-D) with the fixed coefficients `kernel`, a contiguous [3]*dim
    CUDA tensor whose dtype is the grid's (held here, so that the pointer
    the launch passes stays valid). The entry, the launch plan and the
    arguments (one ctypes struct) are fixed here, so that a call checks only
    x (the grid's points, flat or not) and allocates only the output, the
    flat [n] result. The launch follows the plan rule of its construction."""

    def __init__(self, kernel, grid):
        grid = tuple(int(g) for g in grid)
        self.kernel, entries = _ENTRIES[len(grid)]
        dtype, device = kernel.dtype, kernel.device
        if dtype not in entries:
            raise TypeError(f"StencilLaunch: want float32 or float64, got {dtype}")
        if device.type != "cuda" or device.index is None:
            raise ValueError(f"StencilLaunch: want an indexed CUDA device, got {device}")
        if tuple(kernel.shape) != (3,) * len(grid) or not kernel.is_contiguous():
            raise ValueError(f"StencilLaunch: want a contiguous kernel {(3,) * len(grid)}, "
                             f"got {tuple(kernel.shape)}")
        self.n = math.prod(grid)
        if min(grid) < 1 or self.n >= 2**31:
            raise ValueError(f"StencilLaunch: unsupported grid {grid}")
        self.entry = entries[dtype]
        self.grid, self.dtype, self.device = grid, dtype, device
        self.coef = kernel
        self.plan = plan(grid, _sms(device.index))
        self.args = _args(grid, self.plan, kernel)
        self.argp = ctypes.addressof(self.args)
        # the output by empty_like of one value expanded to its shape:
        # contiguous, at a fraction of torch.empty's host cost
        self.out_like = torch.empty(1, dtype=dtype, device=device).expand(self.n)

    def __call__(self, x):
        if x.device != self.device or x.dtype != self.dtype or x.numel() != self.n:
            raise ValueError(
                f"StencilLaunch: want {self.n} values of {self.dtype} on {self.device}, "
                f"got {x.numel()} of {x.dtype} on {x.device}")
        if not x.is_contiguous():
            x = x.contiguous()
        y = torch.empty_like(self.out_like)
        index = self.device.index
        with (contextlib.nullcontext() if index == torch.cuda.current_device()
              else torch.cuda.device(index)):
            self.kernel.launch(self.entry, self.argp, x.data_ptr(), y.data_ptr(),
                               torch._C._cuda_getCurrentRawStream(index))
        GRID_LAUNCHES[self.grid] += 1
        return y
