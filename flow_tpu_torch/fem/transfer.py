# State transfer along refine_uniform hierarchies. Port of
# flow_tpu/fem/transfer.py: seeds a fine-mesh run from a coarse developed
# state (the DFG 2D-2 campaign prolongs a developed wake up one level
# instead of waiting for the onset again) and restricts a fine state down.
#
# refine_uniform numbers the fine vertices [coarse vertices; coarse edge
# midpoints], and P2 dofs are [vertices; edges] (fem/spaces.py): a coarse P2
# dof vector is the vector of values at the fine vertices, in order. So
# prolongation is index arithmetic on the edge tables, and restriction is a
# prefix slice. The edge tables move to a device once per mesh.
from __future__ import annotations

import torch

from .spaces import Function, FunctionSpace

__all__ = ["prolong", "prolong_vector", "restrict", "restrict_vector"]


def _edge_ends(mesh, device):
    """The two endpoint index tensors (int64) of the mesh's edges on
    `device`, moved there once per mesh and device."""
    cache = mesh.__dict__.setdefault("_edge_ends_dev", {})
    ends = cache.get(device)
    if ends is None:
        e = torch.as_tensor(mesh.edges_np, dtype=torch.int64, device=device)
        ends = cache[device] = (e[:, 0].contiguous(), e[:, 1].contiguous())
    return ends


def _midpoints_appended(mesh, x):
    """[x; mean of x at the two ends of each edge of `mesh`]."""
    a, b = _edge_ends(mesh, x.device)
    return torch.cat([x, 0.5 * (x[a] + x[b])], dim=0)


def _prolong_p1(coarse_mesh, x):
    """P1 coarse -> fine: exact (the fine vertices are the coarse vertices
    and the coarse edge midpoints; P1 is linear along each coarse edge)."""
    return _midpoints_appended(coarse_mesh, x)


def _prolong_p2(fine_mesh, U):
    """P2 coarse -> fine. The fine vertex values are the coarse dof vector
    itself (exact point values); each fine edge midpoint takes the mean of
    its edge's end values, a linear interpolation of the quadratic, O(h^2)
    (exact evaluation would need the coarse cell's basis at interior
    points), which is the accuracy a projection step carries anyway."""
    return _midpoints_appended(fine_mesh, U)


def _check_pair(coarse_space, fine_space):
    assert coarse_space.degree == fine_space.degree
    cm, fm = coarse_space.mesh, fine_space.mesh
    assert fm.n_points == cm.n_points + cm.n_edges, (
        "fine mesh is not refine_uniform(coarse mesh)"
    )
    if coarse_space.degree == 2:
        assert coarse_space.n_dofs == fm.n_points


def prolong_vector(x, coarse_space: FunctionSpace, fine_space: FunctionSpace):
    """Prolong a dof vector [n_dofs(, m)] (a tensor, on any device) from
    coarse_space to fine_space, whose mesh must be
    refine_uniform(coarse_space.mesh)."""
    _check_pair(coarse_space, fine_space)
    if coarse_space.degree == 1:
        out = _prolong_p1(coarse_space.mesh, x)
    else:
        out = _prolong_p2(fine_space.mesh, x)
    assert out.shape[0] == fine_space.n_dofs
    return out


def prolong(u: Function, fine_space: FunctionSpace) -> Function:
    """Prolong a Function onto the uniformly refined mesh's space."""
    return Function(fine_space, prolong_vector(u.vector, u.space, fine_space))


def restrict_vector(x, fine_space: FunctionSpace, coarse_space: FunctionSpace):
    """Restrict a dof vector [n_dofs(, m)] fine -> coarse by injection.

    The coarse dof locations (P1: the coarse vertices; P2: those and the
    coarse edge midpoints) are the leading block of the fine numbering, so
    injection is a prefix slice and restrict(prolong(x)) == x exactly. The
    campaigns use it to re-derive a coarse measurement from a fine
    saturated state."""
    _check_pair(coarse_space, fine_space)
    return x[: coarse_space.n_dofs]


def restrict(u: Function, coarse_space: FunctionSpace) -> Function:
    """Restrict a Function onto the coarse (un-refined) mesh's space."""
    return Function(coarse_space, restrict_vector(u.vector, u.space, coarse_space))
