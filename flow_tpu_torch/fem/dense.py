# Dense assembly for small systems (the coarsest multigrid level's direct
# solve). Port of flow_tpu/fem/dense.py: host numpy, setup cost only.
from __future__ import annotations

import numpy as np

from .spaces import FunctionSpace

__all__ = ["scalar_dense"]


def scalar_dense(space: FunctionSpace, local_mats):
    """Assemble element matrices [nc, nl, nl] into a dense [ndof, ndof]."""
    nd = space.n_dofs
    cd = space.cell_dofs_np
    A = np.zeros((nd, nd))
    rows = np.repeat(cd, cd.shape[1], axis=1)  # [nc, nl*nl]
    cols = np.tile(cd, (1, cd.shape[1]))
    np.add.at(A, (rows.ravel(), cols.ravel()), np.asarray(local_mats).reshape(-1))
    return A
