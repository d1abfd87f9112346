# Dirichlet boundary conditions. Port of flow_tpu/fem/bc.py.
#
# A BC is resolved at construction into (dof indices, values) on the host;
# solvers consume the combined dense (mask, values) pair, which keeps the
# constrained-operator algebra branch-free.
from __future__ import annotations

import numpy as np

from .spaces import FunctionSpace, SubSpace

__all__ = ["DirichletBC", "combine_bcs"]


class DirichletBC:
    def __init__(self, space, value, where="on_boundary"):
        if isinstance(space, SubSpace):
            self.space = space.parent
            self.component = space.component
        else:
            self.space = space
            self.component = None

        self.dofs = self.space.boundary_dofs(where)  # np int64 [k]
        x = self.space.dof_points_np[self.dofs]
        ncomp = self.space.n_components if self.component is None else 1
        self.values_np = _eval_value(value, x, ncomp)

    def __repr__(self):
        return f"DirichletBC(n_dofs={len(self.dofs)}, component={self.component})"


def _eval_value(value, x, ncomp):
    n = len(x)
    if isinstance(value, (tuple, list)) and any(callable(v) for v in value):
        assert len(value) == ncomp
        cols = [
            np.asarray(v(x), dtype=np.float64).reshape(n)
            if callable(v)
            else np.full(n, float(v))
            for v in value
        ]
        return np.stack(cols, axis=1)
    if callable(value) and not np.isscalar(value):
        v = np.asarray(value(x), dtype=np.float64)
        if ncomp == 1:
            v = v.reshape(n)
        else:
            if v.shape == (ncomp, n):
                v = v.T
            v = v.reshape(n, ncomp)
        return v
    value = np.asarray(value, dtype=np.float64)
    if value.ndim == 0:
        assert ncomp == 1
        return np.full(n, float(value))
    assert value.shape == (ncomp,)
    return np.broadcast_to(value, (n, ncomp)).copy()


def combine_bcs(space: FunctionSpace, bcs):
    """Combine a list of DirichletBCs into dense float64 numpy (mask, values).

    mask is 1.0 on constrained dofs; values holds the boundary data there
    (later BCs in the list override earlier ones). Shapes: [n_dofs] for
    scalar spaces, [n_dofs, n_components] for vector spaces. The caller moves
    them to its device and dtype.
    """
    if space.n_components == 1:
        mask = np.zeros(space.n_dofs)
        vals = np.zeros(space.n_dofs)
        for bc in bcs:
            assert bc.space is space or bc.space.n_dofs == space.n_dofs
            mask[bc.dofs] = 1.0
            vals[bc.dofs] = bc.values_np
    else:
        mask = np.zeros((space.n_dofs, space.n_components))
        vals = np.zeros((space.n_dofs, space.n_components))
        for bc in bcs:
            v = bc.values_np
            if bc.component is None:
                mask[bc.dofs, :] = 1.0
                vals[bc.dofs, :] = v
            else:
                mask[bc.dofs, bc.component] = 1.0
                vals[bc.dofs, bc.component] = v.reshape(-1)
    return mask, vals
