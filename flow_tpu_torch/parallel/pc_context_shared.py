# The boundary-facet tabulations of (V, Q) as plain arrays, shared by every
# rank of the sharded projection step. Port of
# flow_tpu/parallel/pc_context_shared.py.
from __future__ import annotations

from types import SimpleNamespace

from ..fem.assembly import BoundaryTab

__all__ = ["make_boundary_arrays"]


def make_boundary_arrays(V, Q, rule_degree=5, dtype=None, device=None):
    """The boundary tabulations of (V, Q) bundled as tensors (no
    FunctionSpace or Mesh objects), in `dtype` on `device` (defaults: the
    mesh's)."""
    btV = BoundaryTab(V, rule_degree=rule_degree, dtype=dtype, device=device)
    btQ = BoundaryTab(Q, rule_degree=rule_degree, dtype=dtype, device=device)
    return SimpleNamespace(
        phiV=btV.phi,
        dphiV=btV.dphi,
        cdV=btV.cell_dofs,
        phiQ=btQ.phi,
        cdQ=btQ.cell_dofs,
        wl=btV.wl,
        normals=btV.normals,
        Gb=btV.Gb,
    )
