# Geometric multigrid on structured vertex grids (2-D rectangles, 3-D
# boxes). Port of flow_tpu/solvers/structured_mg.py.
#
# Level operators are the stencil-based StructuredLaplacian; grid transfers
# are separable [1/2, 1, 1/2] (bi/tri)linear interpolation convolutions (plain
# PyTorch convolutions, as the JAX package left them to XLA); smoothing is
# Chebyshev; the coarsest level is a dense inverse applied with a matmul.
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..fem import assembly, dense
from ..fem.assembly import geometry
from ..fem.spaces import FunctionSpace
from ..message import spanned
from ..ops.structured import StructuredLaplacian
from ..mesh3d import _device
from .chebyshev import power_iteration_lmax

__all__ = ["StructuredHierarchy"]


def _coarsen_mesh(mesh):
    """The next coarser grid; every 2-D level is a 'right' rectangle, as in
    the JAX package, whatever the fine mesh's diagonal."""
    dims = [g - 1 for g in mesh.grid_shape]
    assert all(d % 2 == 0 for d in dims), f"grid {dims} not coarsenable"
    p = mesh.points_np
    lo = p.min(axis=0)
    hi = p.max(axis=0)
    if len(dims) == 2:
        from ..mesh import rectangle_mesh

        return rectangle_mesh(lo, hi, dims[0] // 2, dims[1] // 2, diagonal="right",
                              dtype=mesh.dtype, device=mesh.device)
    from ..mesh3d import box_mesh

    return box_mesh(lo, hi, dims[0] // 2, dims[1] // 2, dims[2] // 2,
                    dtype=mesh.dtype, device=mesh.device)


class _Level:
    pass


class StructuredHierarchy:
    """V-cycle preconditioner for the P1 Laplacian on a structured rectangle
    ('left'/'right' diagonal) or box mesh.

    Levels are generated by grid coarsening (each grid dimension must be a
    multiple of 2^(n_levels-1)). bc_mask: finest-level Dirichlet mask or
    None for the pure-Neumann pressure system. Tables live on `device` in
    `dtype` (defaults: the mesh's).
    """

    def __init__(
        self,
        mesh,
        n_levels=None,
        bc_mask=None,
        smoother_degree=3,
        coarse_dense_max=5000,
        lmin_ratio=0.30,
        device=None,
        dtype=None,
    ):
        dims = [g - 1 for g in mesh.grid_shape]
        if n_levels is None:
            n_levels = 1
            while (
                all(d % 2**n_levels == 0 for d in dims)
                and np.prod([d // 2**n_levels + 1 for d in dims]) > coarse_dense_max
            ):
                n_levels += 1
            # one more level only if the dims still halve evenly (odd dims
            # stay single-level: the dense solve at that level is exact)
            if all(d % 2**n_levels == 0 for d in dims):
                n_levels += 1
        self.nlevels = n_levels
        self.dim = dim = len(dims)
        self.neumann = bc_mask is None
        self.dtype = dtype = mesh.dtype if dtype is None else dtype
        self.device = device = _device(mesh.device if device is None else device)
        self.lmin_ratio = lmin_ratio

        meshes = [mesh]
        for _ in range(n_levels - 1):
            meshes.append(_coarsen_mesh(meshes[-1]))
        meshes = meshes[::-1]  # coarse -> fine
        self.meshes = meshes

        # Dirichlet masks per level: coarse vertex (i,j(,k)) is fine (2i,2j(,2k))
        masks = [None] * n_levels
        if bc_mask is not None:
            cur = torch.as_tensor(bc_mask, dtype=dtype, device=device)
            cur = cur.reshape(mesh.grid_shape)
            masks[-1] = cur.reshape(-1)
            for l in range(n_levels - 2, -1, -1):
                cur = cur[(slice(None, None, 2),) * dim]
                masks[l] = cur.reshape(-1)

        self.levels = []
        for l, ms in enumerate(meshes):
            L = _Level()
            L.grid = tuple(ms.grid_shape)
            L.n = int(np.prod(L.grid))
            op = StructuredLaplacian(ms, device=device, dtype=dtype)
            mask = masks[l]
            L.mask = mask
            if mask is None:
                L.K = op
            else:
                free = 1.0 - mask

                def K(x, op=op, free=free, mask=mask):
                    return free * op(free * x) + mask * x

                L.K = K
            S = FunctionSpace(ms, 1)
            diag = assembly.stiffness_diag(S, geometry(ms))
            diag = torch.as_tensor(np.where(diag > 0, diag, 1.0), dtype=dtype,
                                   device=device)
            if mask is not None:
                diag = (1.0 - mask) * diag + mask
            L.diag = diag
            self.set_lmax(L, power_iteration_lmax(L.K, diag, L.n, dtype=dtype))
            self.levels.append(L)

        # transfer kernel: separable [1/2, 1, 1/2] per dimension
        k1 = np.array([0.5, 1.0, 0.5])
        kern = k1
        for _ in range(dim - 1):
            kern = np.multiply.outer(kern, k1)
        self.tkern = torch.as_tensor(
            kern, dtype=dtype, device=device
        ).reshape((1, 1) + (3,) * dim)
        self._conv_t = F.conv_transpose2d if dim == 2 else F.conv_transpose3d
        self._conv = F.conv2d if dim == 2 else F.conv3d

        # coarsest dense inverse
        L0 = self.levels[0]
        assert L0.n <= coarse_dense_max * 4, f"coarsest too big: {L0.n}"
        S0 = FunctionSpace(meshes[0], 1)
        K0 = dense.scalar_dense(
            S0, assembly.stiffness_local(S0, geometry(meshes[0]))
        )
        if self.neumann:
            v = np.full(L0.n, 1.0 / np.sqrt(L0.n))
            K0 = K0 + np.outer(v, v)
        else:
            m0 = masks[0].cpu().numpy() == 1.0
            K0[m0, :] = 0.0
            K0[:, m0] = 0.0
            K0[m0, m0] = 1.0
        self.K0_inv = torch.as_tensor(np.linalg.inv(K0), dtype=dtype, device=device)
        self.smoother_degree = smoother_degree

    def set_lmax(self, L, lmax):
        """Set a level's lambda_max estimate and the Chebyshev interval
        [lmin_ratio, 1.05] * lmax derived from it."""
        L.lmax = float(lmax)
        lmax_s, lmin_s = 1.05 * L.lmax, self.lmin_ratio * L.lmax
        L.theta = 0.5 * (lmax_s + lmin_s)
        L.delta = 0.5 * (lmax_s - lmin_s)

    # ---- transfers -----------------------------------------------------------
    def prolong(self, l, xc):
        """level l -> l+1: (bi/tri)linear interpolation (transposed
        stride-2 convolution; the kernel is symmetric, so no flip is
        needed)."""
        xg = xc.reshape((1, 1) + self.levels[l].grid)
        y = self._conv_t(xg, self.tkern, stride=2, padding=1)
        return y.reshape(self.levels[l + 1].n)

    def restrict(self, l, xf):
        """level l+1 -> l: adjoint of prolong (stride-2 conv, same kernel)."""
        xg = xf.reshape((1, 1) + self.levels[l + 1].grid)
        y = self._conv(xg, self.tkern, stride=2, padding=1)
        return y.reshape(self.levels[l].n)

    # ---- smoother / cycle ----------------------------------------------------
    def _smooth(self, L, b, x):
        sigma = L.theta / L.delta
        rho = 1.0 / sigma
        r = b - L.K(x)
        d = (r / L.diag) / L.theta
        x = x + d
        for _ in range(self.smoother_degree - 1):
            r = r - L.K(d)
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = rho_new * rho * d + (2.0 * rho_new / L.delta) * (r / L.diag)
            x = x + d
            rho = rho_new
        return x

    @staticmethod
    def _project(x):
        return x - torch.mean(x)

    @spanned("flow.vcycle")
    def v_cycle(self, b):
        if self.neumann:
            b = self._project(b)
        bs = [None] * self.nlevels
        xs = [None] * self.nlevels
        bs[-1] = b
        for l in range(self.nlevels - 1, 0, -1):
            L = self.levels[l]
            x = self._smooth(L, bs[l], torch.zeros_like(bs[l]))
            r = bs[l] - L.K(x)
            if self.neumann:
                r = self._project(r)
            xs[l] = x
            rc = self.restrict(l - 1, r)
            if self.levels[l - 1].mask is not None:
                rc = (1.0 - self.levels[l - 1].mask) * rc
            bs[l - 1] = rc
        x0 = self.K0_inv @ bs[0]
        if self.neumann:
            x0 = self._project(x0)
        xs[0] = x0
        for l in range(1, self.nlevels):
            corr = self.prolong(l - 1, xs[l - 1])
            if self.levels[l].mask is not None:
                corr = (1.0 - self.levels[l].mask) * corr
            x = xs[l] + corr
            x = self._smooth(self.levels[l], bs[l], x)
            xs[l] = x
        out = xs[-1]
        if self.neumann:
            out = self._project(out)
        return out
