# The projection step's context over the patch layout (fem/patch.py). Port
# of flow_tpu/navier_stokes/patchctx.py::PatchNSContext.
#
# NSContext's residual, boundary terms, pressure solve and velocity
# correction touch the spaces only through gather/dof_sum and the geometry
# only through detJ/G/C, so they run unchanged here: this class swaps in
# the patch spaces (window gathers, overlap-add dof sums), the patch-ordered
# geometry and the boundary tabulations addressed into the patch layout,
# and hands its Krylov solves the replica-weighted inner product.
from __future__ import annotations

import numpy as np
import torch

from ..fem import assembly
from ..fem.assembly import BoundaryTab
from ..fem.patch import PatchBoundaryTab, PatchGeom, PatchSpace
from .pressure_correction import NSContext

__all__ = ["PatchNSContext"]


class PatchNSContext(NSContext):
    """An NSContext work-alike over patch-contiguous state, built from the
    real (fine-mesh) spaces and a PatchInfo whose hierarchy ends at their
    mesh; .V/.Q are PatchSpaces, .geom the patch-ordered geometry."""

    def __init__(self, info, Vr, Qr, dtype, device):
        mesh = Vr.mesh
        if getattr(mesh, "dim", 2) != 2 or Vr.degree != 2 or Qr.degree != 1:
            raise ValueError("patch layout: 2-D P2/P1 Taylor-Hood only")
        if info.meshes[-1] is not mesh:
            raise ValueError("PatchInfo hierarchy must end at the spaces' mesh")
        self.info = info
        self.V_real, self.Q_real = Vr, Qr
        self.dtype, self.device = dtype, device
        self.dim = 2
        self.V = V = PatchSpace(info.layout(2), mesh, 2, n_components=2,
                                dtype=dtype, device=device)
        self.Q = Q = PatchSpace(info.layout(1), mesh, 1, dtype=dtype, device=device)
        self.geom = geom = PatchGeom(info).on(dtype, device)
        self.btab = PatchBoundaryTab(BoundaryTab(Vr, 6, dtype, device), V)
        self.btabQ = PatchBoundaryTab(BoundaryTab(Qr, 6, dtype, device), Q)

        # the Jacobi diagonals, summed through the patch layout
        def ref(a):
            return torch.as_tensor(a, dtype=dtype, device=device)

        def mdiag(S):
            Md = ref(np.diag(assembly.ref_mass(S.degree, 2)).copy())
            return S.dof_sum(Md[None, :] * geom.detJ[:, None])

        def kdiag(S):
            Kd = ref(np.einsum("klii->kli", assembly.ref_stiffness(S.degree, 2)))
            return S.dof_sum(torch.einsum("ekl,kli->ei", geom.C, Kd))

        ncomp = Vr.n_components
        self.mass_diag_V = mdiag(V)[:, None].repeat(1, ncomp)
        self.stiff_diag_V = kdiag(V)[:, None].repeat(1, ncomp)
        self.stiff_diag_Q = kdiag(Q)
        # the constant function in replicated coordinates: 1 on valid slots
        self.ones_Q = Q._validf
        self._cg_dot = self.dot

    def dot(self, x, y):
        """The replica-weighted inner product of V or Q vectors."""
        if x.shape[0] == self.V.n_dofs:
            return self.V.dot(x, y)
        assert x.shape[0] == self.Q.n_dofs, f"patch dot: unknown length {x.shape[0]}"
        return self.Q.dot(x, y)

    def mask_to_patch(self, space, mask, val):
        """Global (mask, values) -> the patch layout, the padding slots made
        Dirichlet-0 rows (mask 1, value 0), so they stay exactly zero
        through every masked solve."""
        v = space._validf.reshape((-1,) + (1,) * (mask.dim() - 1))
        maskp = torch.clamp(space.to_patch(mask) + (1.0 - v), 0.0, 1.0)
        return maskp, space.to_patch(val)
