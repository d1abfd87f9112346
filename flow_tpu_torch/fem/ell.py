# Padded-ELL sparse operators. Port of flow_tpu/fem/ell.py:
# - ELLMatrix (ell_from_local/ell_stiffness): constant scalar operators, the
#   pressure operator of FastStepper's einsum route and the operator of
#   every P1Hierarchy level the window kernels do not take. Assembly is host
#   numpy (duplicate (row, col) pairs summed once); the tables move to the
#   device once.
# - ELLGraph, FacetMassELL, momentum_const_ell and
#   momentum_bnd_stress_ell_vals: the assembled momentum operators of
#   FastStepper(assembled_jacobian=True) and of its lagged ELL operator
#   (lagged_ell=True). These are block-ELL gathers and sums in torch (the
#   JAX package computes them in XLA, not in a Pallas kernel); the graph
#   assembles element tensors on the device by gathers from member tables,
#   no scatter.
#
# On a CUDA device ELLMatrix.apply launches one of the two hand-written
# kernels of csrc/ell.cu, chosen once by shape at construction and recorded
# in ELLMatrix.kernel:
#   - "direct" (P1 of the TPU probes): one thread per row gathers x through
#     L1/L2 with int32 column indices;
#   - "window" (P2): a tile of WINDOW_ROWS rows stages the parts of x its
#     columns touch, up to WINDOW_SEGMENTS 32-aligned segments merged across
#     gaps of at most WINDOW_GAP values (ell_window_tables), into shared
#     memory by bulk copies, and gathers through 16-bit tile-local indices.
# Both read the column-major ("lane") copies [K, n] the matrix builds on
# the card, in which a warp's reads of one slot are coalesced (the JAX
# package's layout="lane", there a TPU tile-padding fix). A CPU tensor takes
# the plain versions, ell_apply_plain and ell_apply_window_plain. The
# wrappers count their launches in ELL_DIRECT.launches and
# ELL_WINDOW.launches.
#
# The rule. x is small and sits in L2, so a staged value costs an L2 read
# and saves nothing by itself; what the window saves is the index width:
# 2 bytes of device memory per entry (int16 for int32). So a matrix takes
# the window where its segmented tables exist (every tile stages at most
# 65,536 values and at most WINDOW_SMEM_BYTES, so that two blocks share an
# SM) and the entry bytes saved exceed the staged bytes times WINDOW_FACTOR:
#     2 n K > WINDOW_FACTOR * sizeof(T) * sum over tiles of the staged values.
# The constants come from the card: chip_smoke.py's ELL phase times both
# kernels at every ELL operator of the einsum drivers and at the probes'
# shapes (device us, L2 warm / cold; H100 80GB HBM3, 700 W, torch 2.11 +
# CUDA 12.8; the run PERF.md's P2 findings record, which also timed tiles
# of 128-1,024 rows and merge gaps of 0-1,024 values):
#   - the 3-D pressure operator (274,625 x 15; 1.27 bytes saved a byte
#     staged): window 6.63 / 16.32 against direct 9.76 / 21.59; tiles of
#     128 rows 6.59-6.63 warm, 256 6.67-6.71, 512 6.90-6.93, 1,024
#     8.37-8.41;
#   - the Karman levels: at 212,256 rows (0.38) window 5.07 / 9.49 against
#     direct 4.39 / 9.95; at 53,392 (0.45) 2.33 / 3.93 against 2.39 / 4.96;
#     at 13,512 (0.66) 2.10 / 3.00 against 1.97 / 3.81;
#   - the merge gap moved no time by more than the spread between runs,
#     about 0.1 us.
# Cold the window wins at every shape; warm, as a V-cycle applies a level
# with its matrix in L2, it loses at 0.38 and 0.66 by 0.7 and 0.13 us, ties
# at 0.45 (0.06 us, within the spread) and wins at 1.27 by 3.1 us. So the
# times show no single crossing below 1.27: WINDOW_FACTOR = 1 is a round
# value between the largest ratio at which the window lost (0.66) and the
# smallest at which it won clearly (1.27), not a measured break-even.
# WINDOW_SEGMENTS: the Karman levels need up to 16 segments a tile at a gap
# of 128, the 3-D operator 3.
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .._build import Kernel
from ..mesh3d import _device
from . import assembly
from .gathersum import member_table
from .spaces import FunctionSpace

__all__ = ["ELLMatrix", "WindowTables", "ell_from_local", "ell_stiffness",
           "ELLGraph", "FacetMassELL", "momentum_const_ell",
           "momentum_bnd_stress_ell_vals",
           "ell_apply_plain", "ell_apply_window_plain", "ell_window_tables",
           "ELL_DIRECT", "ELL_WINDOW", "WINDOW_ROWS", "WINDOW_GAP",
           "WINDOW_SEGMENTS", "WINDOW_SMEM_BYTES", "WINDOW_FACTOR"]

_P, _I = ctypes.c_void_p, ctypes.c_int
ELL_DIRECT = Kernel("ell", {"ell_direct_f32": [_P] * 4 + [_I] * 2 + [_P],
                            "ell_direct_f64": [_P] * 4 + [_I] * 2 + [_P]})
ELL_WINDOW = Kernel("ell", {"ell_window_f32": [_P] * 7 + [_I] * 5 + [_P],
                            "ell_window_f64": [_P] * 7 + [_I] * 5 + [_P]})
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

WINDOW_ALIGN = 32  # segment starts and lengths, in elements (>= 16 bytes)
WINDOW_ROWS = 128  # rows of a tile, one thread each (the fastest tile above)
WINDOW_GAP = 128  # a gap of at most this many values is staged, not cut
WINDOW_SEGMENTS = 16  # segments of a tile at most (one lane of a warp each)
WINDOW_LOCAL = 1 << 16  # values a tile may stage: its indices are 16-bit
# dynamic shared memory of one tile, so that two blocks fit an SM's 228 KB
WINDOW_SMEM_BYTES = 112 * 1024
WINDOW_FACTOR = 1.0  # entry bytes saved per staged byte above which the window is taken


def ell_apply_plain(vals, cols, x):
    """y[r] = sum_k vals[r, k] x[cols[r, k]] on the row layout [n, K]."""
    return (vals * x[cols]).sum(dim=1)


class WindowTables(NamedTuple):
    """Segmented window tables of a row layout [n, K] in tiles of `rows`
    rows (nt tiles, at most G segments each). Segment g of tile t copies
    x[start[t, g] : start[t, g] + length[t, g]] to window[offset[t, g]:];
    unused segments have length 0 and offset staged[t]."""
    rows: int
    start: np.ndarray  # [nt, G] int32, 32-aligned
    length: np.ndarray  # [nt, G] int32, values copied (clamped to x's end)
    offset: np.ndarray  # [nt, G] int32, 32-aligned, ascending in g
    lidx: np.ndarray  # [n, K] uint16 tile-local index of each entry (0 on padding)
    staged: np.ndarray  # [nt] int64 values a tile's window holds


def ell_window_tables(cols, valid=None):
    """The segmented window tables (WindowTables) of the row layout cols
    [n, K] (numpy) in tiles of WINDOW_ROWS rows, or None where a tile would
    stage more than 65,536 values. A tile's valid columns, rounded out to
    WINDOW_ALIGN-element chunks, form runs of chunks; runs at most
    WINDOW_GAP values apart are merged, and then the smallest gaps until at
    most WINDOW_SEGMENTS remain. Padding entries (valid False) do not widen
    a window; a tile with none valid stages x[0 : WINDOW_ALIGN]."""
    rows, gap, segments, align = WINDOW_ROWS, WINDOW_GAP, WINDOW_SEGMENTS, WINDOW_ALIGN
    cols = np.asarray(cols, dtype=np.int64)
    n, K = cols.shape
    valid = np.ones((n, K), dtype=bool) if valid is None else np.asarray(valid, bool)
    nt = -(-n // rows)
    nchk = n // align + 1
    tile = np.arange(n, dtype=np.int64)[:, None] // rows
    key = (tile * nchk + cols // align)[valid]
    empty = np.ones(nt, dtype=bool)
    empty[np.unique(np.broadcast_to(tile, (n, K))[valid])] = False
    u = np.unique(np.concatenate([key, np.flatnonzero(empty) * nchk]))
    ut, uc = u // nchk, u % nchk
    same = ut[1:] == ut[:-1]
    gaps = (uc[1:] - uc[:-1] - 1) * align
    cut = same & (gaps > gap)
    # keep a tile's `segments` - 1 widest gaps as cuts, merge across the rest
    ci = np.flatnonzero(cut)
    if len(ci):
        order = np.lexsort((-gaps[ci], ut[ci]))
        ts = ut[ci][order]
        first = np.r_[True, ts[1:] != ts[:-1]]
        rank = np.arange(len(ci)) - np.maximum.accumulate(
            np.where(first, np.arange(len(ci)), 0))
        cut[ci[order[rank >= segments - 1]]] = False
    s0 = np.flatnonzero(np.r_[True, ~same | cut])
    s1 = np.r_[s0[1:], len(u)] - 1
    seg_t = ut[s0]
    seg_start = uc[s0] * align
    seg_len = (uc[s1] - uc[s0] + 1) * align
    staged = np.bincount(seg_t, weights=seg_len, minlength=nt).astype(np.int64)
    if staged.max() > WINDOW_LOCAL:
        return None
    t_first = np.searchsorted(seg_t, np.arange(nt))
    g = np.arange(len(s0)) - t_first[seg_t]
    seg_off = np.cumsum(seg_len) - seg_len
    seg_off -= seg_off[t_first][seg_t]
    G = int(g.max()) + 1
    start = np.zeros((nt, G), dtype=np.int32)
    length = np.zeros((nt, G), dtype=np.int32)
    offset = np.repeat(staged[:, None], G, axis=1).astype(np.int32)
    start[seg_t, g] = seg_start
    length[seg_t, g] = np.minimum(seg_len, n - seg_start)
    offset[seg_t, g] = seg_off
    # an entry's segment: the last one of its tile that starts at or before it
    span = n + align
    idx = np.searchsorted(seg_t * span + seg_start,
                          (tile * span + cols)[valid], side="right") - 1
    lidx = np.zeros((n, K), dtype=np.uint16)
    lidx[valid] = seg_off[idx] + cols[valid] - seg_start[idx]
    return WindowTables(rows, start, length, offset, lidx, staged)


def ell_apply_window_plain(vals, lidx, start, length, offset, x, rows=WINDOW_ROWS):
    """The windowed apply on the row layout: tile t's window is the
    concatenation of its segments x[start[t, g] : start[t, g] + length[t, g]]
    at offset[t, g] (zero where nothing was copied), gathered through the
    tile-local indices lidx [n, K] (uint16 values, in any integer tensor)."""
    n, K = lidx.shape
    nt, G = start.shape
    start, length, offset = (a.long() for a in (start, length, offset))
    width = int((offset + length).max())
    j = torch.arange(width, device=x.device).expand(nt, width).contiguous()
    g = torch.searchsorted(offset, j, right=True) - 1
    off_g = offset.gather(1, g)
    pos = start.gather(1, g) + j - off_g
    inside = (j - off_g) < length.gather(1, g)
    win = torch.where(inside, x[pos.clamp(0, n - 1)], x.new_zeros(()))
    loc = lidx.long() & 0xFFFF
    loc = torch.cat([loc, loc.new_zeros((nt * rows - n, K))]).view(nt, rows * K)
    return (vals * torch.gather(win, 1, loc).view(nt * rows, K)[:n]).sum(dim=1)


class ELLMatrix:
    """Static-shape padded ELL matrix: cols [n, K] int64 and vals [n, K] in
    `dtype` on `device` (default: the card). Padding entries have col=0,
    val=0 (they multiply x[0] harmlessly); valid [n, K] marks the real
    entries (default: all). apply(x) takes x [n] in `dtype`.

    tables holds the segmented window tables (ell_window_tables) where they
    exist and a tile's window fits WINDOW_SMEM_BYTES in `dtype`, else None;
    kernel is "window" where tables exist and the byte model of the module
    header favours them, else "direct": the CUDA kernel that apply
    launches on the card. saved_bytes and staged_bytes are the model's two
    sides. On the card the matrix holds the kernels' lane copies vals_t
    [K, n] and cols_t [K, n] int32 and, with tables, lidx_t [K, n] int16
    and the segment tables seg_start, seg_len, seg_off [nt, G] int32.
    launches counts this matrix's kernel launches by kernel ("direct",
    "window")."""

    def __init__(self, cols, vals, dtype, device=None, valid=None):
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals, dtype=np.float64)
        self.n, self.width = cols.shape
        self.valid = valid
        self.launches = {"direct": 0, "window": 0}
        self.dtype = dtype
        self.device = device = _device(device)
        self.cols = torch.as_tensor(cols, device=device)
        self.vals = torch.as_tensor(vals, dtype=dtype, device=device)
        itemsize = torch.finfo(dtype).bits // 8
        tabs = ell_window_tables(cols, valid)
        if tabs is not None and int(tabs.staged.max()) * itemsize > WINDOW_SMEM_BYTES:
            tabs = None
        self.tables = tabs
        self.saved_bytes = 2 * self.n * self.width
        self.staged_bytes = None if tabs is None else int(tabs.staged.sum()) * itemsize
        self.kernel = ("window" if tabs is not None
                       and self.saved_bytes > WINDOW_FACTOR * self.staged_bytes
                       else "direct")
        if tabs is not None:
            self.lidx = torch.as_tensor(tabs.lidx.view(np.int16), device=device)
            self.seg_start, self.seg_len, self.seg_off = (
                torch.as_tensor(a, device=device)
                for a in (tabs.start, tabs.length, tabs.offset))
            self.staged_max = int(tabs.staged.max())
        if device.type == "cuda":
            if dtype not in _SUFFIX:
                raise TypeError(f"ELLMatrix: the kernels take float32 and float64, "
                                f"not {dtype}")
            if self.n * self.width >= 2**31:
                raise ValueError("ELLMatrix: too many entries for int32 indices")

            def lane(a, t):
                return torch.as_tensor(np.ascontiguousarray(a.T), dtype=t,
                                       device=device)

            self.vals_t = lane(vals, dtype)
            self.cols_t = lane(cols, torch.int32)
            if tabs is not None:
                self.lidx_t = lane(tabs.lidx.view(np.int16), torch.int16)

    def _check(self, x):
        if x.device != self.vals.device:
            raise ValueError(f"ELLMatrix.apply: x on {x.device}, the matrix on "
                             f"{self.vals.device}")
        if x.dtype != self.dtype or tuple(x.shape) != (self.n,):
            raise ValueError(f"ELLMatrix.apply: want x [{self.n}] in {self.dtype}, "
                             f"got {tuple(x.shape)} in {x.dtype}")
        return x.contiguous()

    def apply(self, x):
        """y = A x: the plain version for a CPU tensor, else the matrix's
        kernel."""
        if x.device.type == "cpu" and self.device.type == "cpu":
            return ell_apply_plain(self.vals, self.cols, x)
        if self.kernel == "window":
            return self.apply_window(x)
        return self.apply_direct(x)

    def apply_direct(self, x):
        """y = A x through the direct kernel (P1) on the card; the plain
        version for a CPU tensor."""
        if x.device.type == "cpu" and self.device.type == "cpu":
            return ell_apply_plain(self.vals, self.cols, x)
        if x.device.type != "cuda":
            raise ValueError(f"ELLMatrix.apply: no kernel for device {x.device}")
        x = self._check(x)
        y = torch.empty_like(x)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            ELL_DIRECT.launch(f"ell_direct_{_SUFFIX[self.dtype]}",
                              self.vals_t.data_ptr(), self.cols_t.data_ptr(),
                              x.data_ptr(), y.data_ptr(), self.n, self.width, stream)
        self.launches["direct"] += 1
        return y

    def apply_window(self, x):
        """y = A x through the windowed kernel (P2) on the card, for a matrix
        with window tables, whichever kernel the rule picked; the plain
        windowed version for a CPU tensor."""
        if self.tables is None:
            raise ValueError(f"ELLMatrix: no segmented window fits shared memory in "
                             f"{self.dtype}")
        if x.device.type == "cpu" and self.device.type == "cpu":
            return ell_apply_window_plain(self.vals, self.lidx, self.seg_start,
                                          self.seg_len, self.seg_off, x,
                                          self.tables.rows)
        if x.device.type != "cuda":
            raise ValueError(f"ELLMatrix.apply: no kernel for device {x.device}")
        x = self._check(x)
        if x.data_ptr() % 16:
            x = x.clone()  # the bulk copies read 16-byte-aligned addresses
        y = torch.empty_like(x)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            ELL_WINDOW.launch(f"ell_window_{_SUFFIX[self.dtype]}",
                              self.vals_t.data_ptr(), self.lidx_t.data_ptr(),
                              self.seg_start.data_ptr(), self.seg_len.data_ptr(),
                              self.seg_off.data_ptr(), x.data_ptr(), y.data_ptr(),
                              self.n, self.width, self.tables.rows,
                              self.seg_start.shape[1], self.staged_max, stream)
        self.launches["window"] += 1
        return y

    def __call__(self, x):
        return self.apply(x)


def ell_from_local(space: FunctionSpace, loc, dtype=None, device=None):
    """Assemble element matrices loc [nc, nl, nl] into an ELLMatrix in
    `dtype` on `device` (defaults: the mesh's); rows padded to the max row
    valence."""
    loc = np.asarray(loc, dtype=np.float64)
    cd = space.cell_dofs_np.astype(np.int64)
    nl = cd.shape[1]
    n = space.n_dofs
    rows = np.repeat(cd, nl, axis=1).ravel()
    cols = np.tile(cd, (1, nl)).ravel()
    vals = loc.reshape(len(cd), nl * nl).ravel()

    key = rows * n + cols
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    uniq, start = np.unique(key_s, return_index=True)
    sums = np.add.reduceat(vals[order], start)
    r = uniq // n
    c = uniq % n

    counts = np.bincount(r, minlength=n)
    width = int(counts.max())
    pos = np.arange(len(r)) - np.concatenate([[0], np.cumsum(counts)])[r]
    cols_pad = np.zeros((n, width), dtype=np.int64)
    vals_pad = np.zeros((n, width), dtype=np.float64)
    cols_pad[r, pos] = c
    vals_pad[r, pos] = sums
    valid = np.arange(width)[None, :] < counts[:, None]
    mesh = space.mesh
    return ELLMatrix(
        cols_pad, vals_pad,
        mesh.dtype if dtype is None else dtype,
        mesh.device if device is None else device,
        valid=valid,
    )


def ell_stiffness(space: FunctionSpace, geom, coeff=None, dtype=None, device=None):
    """Assembled stiffness K_ij = int c grad(phi_i).grad(phi_j) as ELL (the
    values of assembly.stiffness_apply, exact factored tensors); coeff: a
    constant or per-cell [nc] factor c (default 1)."""
    return ell_from_local(
        space, assembly.stiffness_local(space, geom, coeff=coeff), dtype=dtype,
        device=device,
    )


class ELLGraph:
    """The scalar dof graph of `space` as padded ELL (cols [n, W], vertex
    rows first and wider than the P2 edge rows), with member tables that
    assemble element tensors into ELL values on `device` by gathers.

    assemble(loc): loc [nc, nl, nl(, m, m)] -> vals [n, W(, m, m)], padding
    slots exactly 0; apply(vals, x); diag(vals); assemble_np (host numpy)
    for the constant parts built at setup."""

    def __init__(self, space: FunctionSpace, device=None):
        device = _device(space.mesh.device if device is None else device)
        cd = space.cell_dofs_np.astype(np.int64)
        nc, nl = cd.shape
        n = space.n_dofs
        rows = np.repeat(cd, nl, axis=1).ravel()
        cols = np.tile(cd, (1, nl)).ravel()
        key = rows * n + cols
        uniq, inv = np.unique(key, return_inverse=True)
        inv = inv.ravel()
        r = (uniq // n).astype(np.int64)
        c = (uniq % n).astype(np.int64)
        counts = np.bincount(r, minlength=n)
        width = int(counts.max())
        pos = np.arange(len(r)) - np.concatenate([[0], np.cumsum(counts)])[r]
        cols_pad = np.zeros((n, width), dtype=np.int64)
        cols_pad[r, pos] = c
        self.valid_np = np.arange(width)[None, :] < counts[:, None]
        # P2 vertex rows (~17-25 wide) and edge rows (<= 9): apply reads each
        # class at its own width
        nv = space.mesh.n_points if space.degree == 2 else n
        self.n_vert = int(nv)
        self.w_edge = int(counts[nv:].max()) if nv < n else 0
        slot = r * width + pos
        self.dest_np = slot[inv].reshape(nc, nl, nl)  # ELL slot of each entry
        self.cols_np = cols_pad
        self.n, self.width, self.n_local = n, width, nl
        self.device = device
        self.cols = torch.as_tensor(cols_pad, device=device)
        self._valid = torch.as_tensor(self.valid_np, device=device)
        # each slot's source entries (flat e*nl*nl + i*nl + j), padded with
        # the extra zero entry nc*nl*nl
        self._members = torch.as_tensor(
            member_table(self.dest_np.ravel(), n * width), device=device)

    def assemble_np(self, loc):
        """Host assembly of element tensors (setup-time constant parts)."""
        loc = np.asarray(loc)
        block = loc.shape[3:]
        flat = np.zeros((self.n * self.width,) + block, dtype=loc.dtype)
        np.add.at(flat, self.dest_np.ravel(), loc.reshape((-1,) + block))
        return flat.reshape((self.n, self.width) + block)

    def assemble(self, loc):
        """Element tensors -> padded ELL values on the device, by gathers."""
        block = loc.shape[3:]
        flat = loc.reshape((-1,) + block)
        flat = torch.cat([flat, flat.new_zeros((1,) + block)])
        return flat[self._members].sum(dim=1).reshape((self.n, self.width) + block)

    def apply(self, vals, x):
        """vals [n, W] @ x [n(, m)], or vals [n, W, m, m] @ x [n, m]; vertex
        and edge rows at their own widths."""
        nv, we = self.n_vert, self.w_edge
        if 0 < we < self.width and nv < self.n:
            return torch.cat([self._apply_rows(vals[:nv], self.cols[:nv], x),
                              self._apply_rows(vals[nv:, :we], self.cols[nv:, :we], x)])
        return self._apply_rows(vals, self.cols, x)

    @staticmethod
    def _apply_rows(vals, cols, x):
        xg = x[cols]
        if vals.dim() == 2:
            if x.dim() == 1:
                return torch.einsum("nk,nk->n", vals, xg)
            return torch.einsum("nk,nkm->nm", vals, xg)
        return torch.einsum("nkab,nkb->na", vals, xg)

    def diag(self, vals):
        """The (block) diagonal: [n] from [n, W], [n, m] from [n, W, m, m]."""
        eye = (self.cols == torch.arange(self.n, device=self.cols.device)[:, None]) & self._valid
        if vals.dim() == 2:
            return torch.where(eye, vals, torch.zeros_like(vals)).sum(dim=1)
        d = torch.einsum("nkaa->nka", vals)
        return torch.where(eye[:, :, None], d, torch.zeros_like(d)).sum(dim=1)


class FacetMassELL:
    """The weighted facet mass vals[i, j] += sum_f sum_q wl s phi_i phi_j,
    assembled into the cell graph each step from per-facet-point weights
    s [nb, nq] (the directional do-nothing term's Jacobian, whose weight
    follows the lagged transport). Surface-sized: an index_add_."""

    def __init__(self, graph: ELLGraph, btab, dtype):
        phi = btab.phi.detach().cpu().numpy().astype(np.float64)
        wl = btab.wl.detach().cpu().numpy().astype(np.float64)
        cells = np.asarray(btab.space.mesh.boundary_cells_np, dtype=np.int64)
        core = np.einsum("fq,fqi,fqj->fqij", wl, phi, phi)
        self._core = torch.as_tensor(core, dtype=dtype, device=graph.device)
        self._dest = torch.as_tensor(graph.dest_np[cells].reshape(-1), device=graph.device)
        self._n, self._w = graph.n, graph.width

    def assemble(self, s):
        """s [nb, nq] -> vals [n, W]."""
        el = torch.einsum("fqij,fq->fij", self._core, s)
        flat = el.new_zeros(self._n * self._w)
        return flat.index_add_(0, self._dest, el.reshape(-1)).reshape(self._n, self._w)


def momentum_const_ell(V: FunctionSpace, geom, graph: ELLGraph):
    """The state-independent ELL pieces of the momentum Jacobian, host numpy:
    mass [n, W] (int phi_i phi_j), visc1 [n, W] (int grad phi_i . grad
    phi_j, the component-diagonal part) and visc2 [n, W, d, d]
    (int d_a phi_j d_b phi_i, the grad-transpose part of the stress form);
    the element tensors are forms.sym_grad_loc's and mass_loc's."""
    dim = assembly._dim(V)
    Mref = assembly.ref_mass(V.degree, dim)
    Kref = assembly.ref_stiffness(V.degree, dim)
    detJ = np.asarray(geom.detJ, dtype=np.float64)
    C = np.asarray(geom.C, dtype=np.float64)
    G = np.asarray(geom.G, dtype=np.float64)
    nc, d, nl = detJ.shape[0], G.shape[1], graph.n_local
    mass = graph.assemble_np(Mref[None, :, :] * detJ[:, None, None])
    visc1 = graph.assemble_np(np.einsum("ekl,klij->eij", C, Kref))
    visc2 = np.zeros((graph.n * graph.width, d, d))
    chunk = max(1, 50_000_000 // (nl * nl * d * d * 8))
    for s in range(0, nc, chunk):
        e = min(nc, s + chunk)
        el = np.einsum("e,eak,ebl,klji->eijab", detJ[s:e], G[s:e], G[s:e], Kref)
        np.add.at(visc2, graph.dest_np[s:e].ravel(), el.reshape(-1, d, d))
    return mass, visc1, visc2.reshape(graph.n, graph.width, d, d)


def momentum_bnd_stress_ell_vals(V: FunctionSpace, geom, btab, graph: ELLGraph):
    """The constant ELL values [n, W, d, d] of the boundary stress term's
    Jacobian: mu (grad u)^T n is linear in u, so
    B[f, i, j, a, b] = int_facet phi_i (d_a phi_j) n_b ds assembles once;
    the stepper scales it at run time."""
    def host(t):
        return t.detach().cpu().numpy().astype(np.float64)

    phi, dphi, wl, nrm, Gb = (host(btab.phi), host(btab.dphi), host(btab.wl),
                              host(btab.normals), host(btab.Gb))
    cells = np.asarray(btab.space.mesh.boundary_cells_np, dtype=np.int64)
    gphi = np.einsum("fqjk,fak->fqja", dphi, Gb)
    core = np.einsum("fq,fqi,fqja->fija", wl, phi, gphi)
    el = core[:, :, :, :, None] * nrm[:, None, None, None, :]
    d = el.shape[-1]
    vals = np.zeros((graph.n * graph.width, d, d))
    np.add.at(vals, graph.dest_np[cells].ravel(), el.reshape(-1, d, d))
    return vals.reshape(graph.n, graph.width, d, d)
