# Dof sums in a fixed order, for the heat and multigrid paths whose
# iteration counts must repeat from run to run on the card.
#
# FunctionSpace.dof_sum sums with index_add_, whose float atomics on the
# card add in a varying order. GatherSum instead reads, for every dof, the
# local entries that land on it from a padded member table built once on
# the host, and sums each row along its padded axis: one gather and one
# reduction, the same bits on every run. The JAX package's FunctionSpace
# sums the same way (gather tables, fem/spaces.py).
from __future__ import annotations

import numpy as np
import torch

__all__ = ["GatherSum", "gather_sum_of", "member_table"]


def member_table(targets, n_rows):
    """[n_rows, k] table of the positions p with targets[p] == row, in
    increasing p, padded with len(targets) (an extra zero slot)."""
    targets = np.asarray(targets, dtype=np.int64).ravel()
    order = np.argsort(targets, kind="stable")
    counts = np.bincount(targets, minlength=n_rows)
    k = max(int(counts.max()) if len(counts) else 0, 1)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rows = targets[order]
    pos = np.arange(len(order)) - starts[rows]
    table = np.full((n_rows, k), len(targets), dtype=np.int64)
    table[rows, pos] = order
    return table


class GatherSum:
    """out[d] = sum of local_vals[c, l] over the (c, l) with cell_dofs[c, l]
    == d, in a fixed order: a padded member table on `device`."""

    def __init__(self, cell_dofs, n_dofs, device):
        cell_dofs = np.asarray(cell_dofs)
        self.n_local_entries = cell_dofs.size
        self.n_dofs = int(n_dofs)
        self.table = torch.as_tensor(member_table(cell_dofs, n_dofs),
                                     device=device)

    def __call__(self, local_vals):
        """local_vals [nc, nl(,m)] -> [n_dofs(,m)]."""
        flat = local_vals.reshape((self.n_local_entries,) + local_vals.shape[2:])
        flat = torch.cat([flat, flat.new_zeros((1,) + flat.shape[1:])])
        return flat[self.table].sum(dim=1)


def gather_sum_of(space, device):
    """The GatherSum of `space`'s cell-dof table on `device`, cached on the
    space."""
    device = torch.device(device)
    cache = space.__dict__.setdefault("_gather_sum", {})
    gs = cache.get(device)
    if gs is None:
        gs = GatherSum(space.cell_dofs_np, space.n_dofs, device)
        cache[device] = gs
    return gs
