# Function spaces and dof maps. Port of flow_tpu/fem/spaces.py.
#
# A FunctionSpace is a static dof numbering built on the host in numpy.
# gather/dof_sum take numpy arrays (setup: diagonals, boundary rows, the
# coarse dense matrix) or torch tensors (the per-step forms); on tensors the
# sum is index_add_ over a device copy of the cell-dof table, made once per
# device. The JAX package's gather tables for a scatter-free dof sum are a
# TPU device and are not carried over.
#
# Dof numbering:
#   P1: dof i == mesh vertex i.
#   P2: dofs [0, n_points) are vertices, [n_points, n_points+n_edges) are edge
#       midpoints. Local dof order matches fem/elements.py.
#   Vector spaces share the scalar numbering; values are stored
#   [n_dofs, n_components].
from __future__ import annotations

import numpy as np
import torch

from . import elements

__all__ = ["FunctionSpace", "VectorFunctionSpace", "SubSpace", "Function"]


class FunctionSpace:
    def __init__(self, mesh, degree: int, n_components: int = 1):
        assert degree in (1, 2)
        self.mesh = mesh
        self.degree = degree
        self.n_components = n_components

        self.dim = getattr(mesh, "dim", 2)
        if degree == 1:
            cell_dofs = mesh.cells_np.copy()
            n_dofs = mesh.n_points
            dof_points = mesh.points_np.copy()
        else:
            cell_dofs = np.concatenate(
                [mesh.cells_np, mesh.n_points + mesh.cell_edges_np], axis=1
            )
            n_dofs = mesh.n_points + mesh.n_edges
            mid = 0.5 * (
                mesh.points_np[mesh.edges_np[:, 0]]
                + mesh.points_np[mesh.edges_np[:, 1]]
            )
            dof_points = np.concatenate([mesh.points_np, mid], axis=0)

        self.n_dofs = int(n_dofs)
        self.n_local = elements.n_local_dofs(degree, self.dim)
        self.cell_dofs_np = cell_dofs.astype(np.int64)
        self.dof_points_np = dof_points

        self._cell_dofs_dev = {}

        # boundary dof flags
        bnd_vertex = np.zeros(mesh.n_points, dtype=bool)
        if self.dim == 2:
            bnd_vertex[mesh.edges_np[mesh.boundary_edges_np].ravel()] = True
        else:
            bnd_vertex[mesh.boundary_faces_np.ravel()] = True
        if degree == 1:
            self._on_boundary = bnd_vertex
        else:
            bnd_edge = np.zeros(mesh.n_edges, dtype=bool)
            bnd_edge[mesh.boundary_edges_np] = True
            self._on_boundary = np.concatenate([bnd_vertex, bnd_edge])

    # -- dof gathering / summation ------------------------------------------
    def cell_dofs_on(self, device):
        """The cell-dof table [n_cells, n_local] as int64 on `device`."""
        device = torch.device(device)
        cd = self._cell_dofs_dev.get(device)
        if cd is None:
            cd = torch.as_tensor(self.cell_dofs_np, device=device)
            self._cell_dofs_dev[device] = cd
        return cd

    def gather(self, U):
        """U [n_dofs(,m)] -> local values [n_cells, n_local(,m)]."""
        if isinstance(U, torch.Tensor):
            return U[self.cell_dofs_on(U.device)]
        return U[self.cell_dofs_np]

    def dof_sum(self, local_vals):
        """Sum local contributions [n_cells, n_local(,m)] into [n_dofs(,m)]."""
        if isinstance(local_vals, torch.Tensor):
            idx = self.cell_dofs_on(local_vals.device).reshape(-1)
            flat = local_vals.reshape((idx.shape[0],) + local_vals.shape[2:])
            out = flat.new_zeros((self.n_dofs,) + local_vals.shape[2:])
            return out.index_add_(0, idx, flat)
        local_vals = np.asarray(local_vals)
        flat_dofs = self.cell_dofs_np.ravel()
        flat = local_vals.reshape((len(flat_dofs), -1))
        out = np.stack(
            [
                np.bincount(flat_dofs, weights=flat[:, c], minlength=self.n_dofs)
                for c in range(flat.shape[1])
            ],
            axis=1,
        )
        return out.reshape((self.n_dofs,) + local_vals.shape[2:])

    # -- boundary queries -----------------------------------------------------
    def boundary_dofs(self, where="on_boundary"):
        """Global dof indices on the mesh boundary satisfying `where`.

        `where` is 'on_boundary' or a predicate f(x: [n,dim] np array) ->
        bool array, evaluated at the dof coordinates of boundary dofs.
        """
        idx = np.where(self._on_boundary)[0]
        if where != "on_boundary":
            sel = np.asarray(where(self.dof_points_np[idx]), dtype=bool)
            idx = idx[sel]
        return idx

    def zeros(self):
        shape = (self.n_dofs,) if self.n_components == 1 else (
            self.n_dofs,
            self.n_components,
        )
        return torch.zeros(shape, dtype=self.mesh.dtype, device=self.mesh.device)

    def sub(self, component):
        return SubSpace(self, component)

    @property
    def value_shape(self):
        return () if self.n_components == 1 else (self.n_components,)

    def __repr__(self):
        kind = "P%d" % self.degree
        if self.n_components > 1:
            kind = "Vector" + kind
        return f"FunctionSpace({kind}, n_dofs={self.n_dofs})"


def VectorFunctionSpace(mesh, degree, n_components=2):
    return FunctionSpace(mesh, degree, n_components=n_components)


class SubSpace:
    """A component view W.sub(i) of a vector space, for component-wise BCs."""

    def __init__(self, parent: FunctionSpace, component: int):
        assert 0 <= component < parent.n_components
        self.parent = parent
        self.component = component


class Function:
    """A finite-element function: (space, dof vector), the vector a tensor
    [n_dofs] (scalar) or [n_dofs, n_components] (vector); the form
    compiler's field coefficient (fem/formlang.py). Immutable by
    convention: solvers return new Functions."""

    def __init__(self, space: FunctionSpace, vector=None):
        self.space = space
        self.vector = space.zeros() if vector is None else vector
        self._name = ""

    def copy(self):
        return Function(self.space, self.vector)

    def assign(self, other):
        """Take the values of another Function or a dof vector (dolfin's
        u0.assign(u1)): rebinds the vector, copying nothing."""
        self.vector = other.vector if isinstance(other, Function) else other
        return self

    def rename(self, name, _label=None):
        self._name = name
        return self

    @property
    def name(self):
        return self._name

    def split(self):
        """The component Functions of a vector Function, on a scalar space
        of the same mesh and degree (column views of the vector)."""
        assert self.space.n_components > 1
        scalar = FunctionSpace(self.space.mesh, self.space.degree)
        return tuple(Function(scalar, self.vector[:, c])
                     for c in range(self.space.n_components))

    def __repr__(self):
        return f"Function({self.space!r})"
