# Window-blocked cell layout of the window kernels (attic/winkernel.py,
# attic/winmom.py). Port of flow_tpu/attic/window.py: host numpy, the same
# permutation, buckets and tables as the JAX package.
#
# Layout:
#   - scalar-dof permutation by RCM on the dof graph (pairs sharing a cell),
#     from the meshkit library (native.rcm_order), so the permutation is the
#     JAX package's;
#   - uniform-stride buckets: block b owns permuted dofs [b*S, (b+1)*S); a
#     cell belongs to the bucket of its minimum permuted dof, so block b
#     touches only [b*S, b*S + W) with W = S + bandwidth (padded to a
#     multiple of S), and the output side is an overlap-add of W/S shifted
#     contiguous layers (plain adds, no scatter);
#   - per-block cell lists padded to the largest bucket (masked by `valid`).
#
# The CUDA kernels also need, per block, the (cell, local dof) pairs that
# touch each window dof, in a fixed order (build_scatter_lists): summing
# along those lists makes the kernels' scatter deterministic.
from __future__ import annotations

import numpy as np

from .. import native

__all__ = ["WindowLayout", "build_window_layout", "build_scatter_lists",
           "overlap_add_fn"]


class WindowLayout:
    """Uniform-stride blocked-window view of a scalar FunctionSpace.

    Attributes:
      perm      np [n] int32, new -> old dof id (x_win = x_old[perm])
      inv       np [n] int32, old -> new (x_old[i] lives at inv[i])
      S         owned stride per block (multiple of 128)
      W         window width (multiple of S); block b reads [b*S, b*S+W)
      nb        number of blocks = ceil(n / S)
      C         padded cells per block (max bucket population)
      cells     np [nb, C] int32 - original cell ids per block (padded by
                repeating the last real cell)
      valid     np [nb, C] float32 - 1.0 real cell, 0.0 padding
      lidx      np [nb, C, nl] int32 - window-local dof indices (< W)
    """

    def __init__(self, perm, inv, S, W, nb, C, cells, valid, lidx):
        self.perm = perm
        self.inv = inv
        self.S = S
        self.W = W
        self.nb = nb
        self.C = C
        self.cells = cells
        self.valid = valid
        self.lidx = lidx

    @property
    def n(self):
        return len(self.perm)

    @property
    def n_pad(self):
        """Length the permuted source vector must be padded to."""
        return self.nb * self.S + self.W

    def overlap_add(self, wins):
        """[..., nb, W] per-block output windows -> [..., n] (permuted
        numbering). W/S shifted contiguous adds, no scatter."""
        return overlap_add_fn(wins, self.S, self.W, self.n)


def overlap_add_fn(wins, S, W, n):
    """Overlap-add of [..., nb, W] windows into [..., n], layer k of every
    block added in turn (the JAX package's order)."""
    lead = wins.shape[:-2]
    nb = wins.shape[-2]
    nbS = nb * S
    y = wins.new_zeros(lead + (nbS + W,))
    for k in range(W // S):
        y[..., k * S:k * S + nbS] += wins[..., k * S:(k + 1) * S].reshape(
            lead + (nbS,)
        )
    return y[..., :n]


def _dof_graph_rcm(cell_dofs, n):
    """RCM on the dof graph (all intra-cell pairs). Returns perm (new->old)
    and inv (old->new)."""
    cd = np.asarray(cell_dofs, dtype=np.int64)
    nl = cd.shape[1]
    ii, jj = np.triu_indices(nl, 1)
    e = np.stack([cd[:, ii].ravel(), cd[:, jj].ravel()], axis=1)
    e = np.unique(np.sort(e, axis=1), axis=0).astype(np.int32)
    perm = np.asarray(native.rcm_order(n, e))
    inv = np.empty_like(perm)
    inv[perm] = np.arange(n, dtype=perm.dtype)
    return perm.astype(np.int32), inv.astype(np.int32)


def build_window_layout(space, S=None, rcm=None):
    """The uniform-stride WindowLayout of a FunctionSpace (scalar dof
    structure; vector components share it). S must be a multiple of 128;
    S=None picks it from the RCM bandwidth (between 512 and 4096).
    rcm=(perm, inv) reuses a dof permutation computed before."""
    cd = np.asarray(space.cell_dofs_np)
    n = space.n_dofs
    perm, inv = _dof_graph_rcm(cd, n) if rcm is None else rcm
    cdn = inv[cd.astype(np.int64)]  # cell dofs in new numbering

    if S is None:
        span = int((cdn.max(axis=1) - cdn.min(axis=1)).max()) + 1
        S = min(4096, max(512, ((span + 127) // 128) * 128))
    assert S % 128 == 0, S

    cmin = cdn.min(axis=1)
    bucket = cmin // S
    nb = (n + S - 1) // S
    # W = S + max reach, padded to a multiple of S
    reach = int((cdn.max(axis=1) - bucket * S).max()) + 1
    W = ((reach + S - 1) // S) * S

    counts = np.bincount(bucket, minlength=nb)
    C = int(counts.max())
    cells = np.empty((nb, C), dtype=np.int32)
    valid = np.zeros((nb, C), dtype=np.float32)
    order = np.argsort(bucket, kind="stable")
    off = 0
    for b in range(nb):
        k = counts[b]
        ids = order[off:off + k]
        off += k
        if k:
            cells[b, :k] = ids
            cells[b, k:] = ids[-1]
            valid[b, :k] = 1.0
        else:
            cells[b, :] = 0  # fully masked block
    lidx = cdn[cells.astype(np.int64)] - (np.arange(nb) * S)[:, None, None]
    lidx = lidx.astype(np.int32)
    # padding cells may have negative lidx (repeat of a cell from an earlier
    # window); clamp into range - they are masked by valid anyway
    lidx = np.clip(lidx, 0, W - 1)
    return WindowLayout(perm, inv, S, W, nb, C, cells, valid, lidx)


def build_scatter_lists(wl):
    """Per-block scatter lists of the real (unmasked) cells:

      rowptr  np [nb, W+1] int32 - the entries of window dof w of block b
              are ent[b, rowptr[b, w]:rowptr[b, w+1]]
      ent     np [nb, C*nl] int32 - entry e = c*nl + i names local dof i of
              the block's cell c; within a row, e ascends

    Padding cells appear in no list, so they add nothing to the output."""
    nb, C, nl = wl.lidx.shape
    W = wl.W
    b, c, i = np.nonzero(np.broadcast_to(wl.valid[:, :, None] > 0, (nb, C, nl)))
    key = b.astype(np.int64) * W + wl.lidx[b, c, i]
    order = np.argsort(key, kind="stable")  # (b, c, i) order kept per key
    key = key[order]
    e = (c * nl + i)[order].astype(np.int32)
    bounds = np.arange(nb, dtype=np.int64)[:, None] * W + np.arange(W + 1)
    ptr = np.searchsorted(key, bounds.ravel(), side="left").reshape(nb, W + 1)
    start = ptr[:, :1]
    rowptr = (ptr - start).astype(np.int32)
    ent = np.zeros((nb, C * nl), dtype=np.int32)
    pos = np.arange(len(e)) - start[b[order], 0]
    ent[b[order], pos] = e
    return rowptr, ent
