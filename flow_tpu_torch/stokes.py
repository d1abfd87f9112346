# Steady Stokes: the saddle-point solve on Taylor-Hood P2/P1. Port of
# flow_tpu/stokes.py. The weak form is
#     a((u,p),(v,q)) = mu grad(u):grad(v) - p div(v) - q div(u),
# applied matrix-free on the mesh's device and solved by MINRES with a
# block-diagonal preconditioner: Chebyshev (degree 6) on the viscous block
# and the lumped pressure mass / mu on the Schur block. Systems of at most
# DENSE_THRESHOLD unknowns take a dense LU on the host instead.
#
# The operator's element contributions are summed with fem/gathersum
# member tables (a fixed order), so a MINRES solve repeats its iteration
# count from run to run on the card; the local values are the JAX
# package's.
from __future__ import annotations

import numpy as np
import torch

from .fem import assembly, dense, forms
from .fem.assembly import geometry, geometry_on, tabulation
from .fem.bc import combine_bcs
from .fem.gathersum import gather_sum_of
from .fem.interpolate import eval_callable
from .fem.spaces import Function, FunctionSpace, VectorFunctionSpace
from .message import info
from .solvers import krylov
from .solvers.chebyshev import chebyshev_preconditioner, power_iteration_lmax

__all__ = ["TaylorHood", "solve", "DENSE_THRESHOLD"]

DENSE_THRESHOLD = 20000
# the last solve's {"solver", "iters", "resnorm"}
last_info = None


class TaylorHood:
    """The mixed space WP = (vector P2) x (P1) on a triangle mesh."""

    def __init__(self, mesh, V=None, Q=None):
        self.mesh = mesh
        self.V = V if V is not None else VectorFunctionSpace(mesh, 2)
        self.Q = Q if Q is not None else FunctionSpace(mesh, 1)

    def sub(self, i):
        return (self.V, self.Q)[i]


def _split_bcs(WP: TaylorHood, bcs):
    """The BCs on WP.V (a BC on a component sub-space resolves to its parent)
    and on WP.Q."""
    u_bcs, p_bcs = [], []
    for bc in bcs:
        if bc.space is WP.V:
            u_bcs.append(bc)
        elif bc.space is WP.Q:
            p_bcs.append(bc)
        else:
            raise ValueError(
                "DirichletBC space is neither WP.V nor WP.Q; build BCs on "
                "the mixed space's own subspaces (WP.sub(0)/WP.sub(1))"
            )
    return u_bcs, p_bcs


class _Operator:
    """The Stokes blocks on the device (fem/forms), summed by member tables."""

    def __init__(self, WP, mu):
        V, Q = WP.V, WP.Q
        self.V, self.Q, self.mu = V, Q, mu
        self.dtype, self.device = WP.mesh.dtype, WP.mesh.device
        self.geom = geometry_on(WP.mesh, self.dtype, self.device)
        self.sum_V = gather_sum_of(V, self.device)
        self.sum_Q = gather_sum_of(Q, self.device)

    def laplacian(self, U):
        """The component-wise stiffness of U [n_V, 2]."""
        return forms.vector_laplacian_apply(self.V, self.geom, U, dof_sum=self.sum_V)

    def grad(self, P):
        """b[(i,a)] = int p d_a(v_i): the B^T block."""
        return forms.pressure_grad_rhs(self.V, self.Q, self.geom, P, dof_sum=self.sum_V)

    def div(self, U):
        """b[m] = int div(u) q_m: the B block."""
        return forms.div_rhs(self.V, self.Q, self.geom, U, dof_sum=self.sum_Q)


def solve(
    WP: TaylorHood,
    bcs,
    mu,
    f,
    verbose=True,
    tol=1.0e-13,
    max_iter=500,
    solver_config=None,
):
    """Solve Stokes on WP's mesh device in its dtype; returns (u, p)
    Functions. `solver_config` (a utils.config.SolverConfig) overrides
    tol, max_iter and verbose. Raises RuntimeError where MINRES does not
    converge. `last_info` (a module attribute) holds the solve's
    {"solver", "iters", "resnorm"}."""
    global last_info
    if solver_config is not None:
        tol = solver_config.rtol
        max_iter = solver_config.maxiter
        verbose = solver_config.monitor_convergence
    assert mu > 0.0
    mesh = WP.mesh
    V, Q = WP.V, WP.Q
    op = _Operator(WP, mu)
    dtype, device = op.dtype, op.device
    u_bcs, p_bcs = _split_bcs(WP, bcs)

    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    mask_u, val_u = (dev(a) for a in combine_bcs(V, u_bcs))
    mask_p, val_p = (dev(a) for a in combine_bcs(Q, p_bcs))

    nu = V.n_dofs * 2
    npr = Q.n_dofs

    def pack(U, P):
        return torch.cat([U.reshape(-1), P])

    def unpack(z):
        return z[:nu].reshape(V.n_dofs, 2), z[nu:]

    def A_raw(z):
        U, P = unpack(z)
        yu = mu * op.laplacian(U)
        yu = yu - op.grad(P)
        yp = -op.div(U)
        return pack(yu, yp)

    mask = pack(mask_u, mask_p)
    gvals = pack(mask_u * val_u, mask_p * val_p)
    free = 1.0 - mask

    def A_bc(z):
        y = A_raw(free * z)
        return free * y + mask * z

    # rhs: int f.v dx
    tab = tabulation(V, 2 * V.degree + 2)
    xq = dev(geometry(mesh).physical_points(tab.ref_pts))
    fq = eval_callable(f, xq)
    t = tab.on(dtype, device)
    wd = t.w[None, :] * op.geom.detJ[:, None]
    b_u = op.sum_V(torch.einsum("eqm,eq,qi->eim", fq, wd, t.phi))
    b = pack(b_u, torch.zeros(npr, dtype=dtype, device=device))
    b_c = free * (b - A_raw(gvals)) + gvals

    nullspace = None
    if not p_bcs:
        ns = pack(torch.zeros((V.n_dofs, 2), dtype=dtype, device=device),
                  torch.ones(npr, dtype=dtype, device=device))
        nullspace = [ns]

    if nu + npr <= DENSE_THRESHOLD:
        z = _dense_solve(WP, mu, b_c, mask, nullspace)
        last_info = {"solver": "dense", "iters": -1, "resnorm": None}
    else:
        M = _block_preconditioner(WP, op, free, mask)
        z, sinfo = krylov.minres(A_bc, b_c, M=M, rtol=tol, maxiter=max_iter,
                                 nullspace=nullspace)
        last_info = {"solver": "minres", "iters": int(sinfo.iters),
                     "resnorm": float(sinfo.resnorm)}
        if verbose:
            info("stokes: minres iters=%d res=%.3e", last_info["iters"],
                 last_info["resnorm"])
        if not bool(sinfo.converged):
            raise RuntimeError(
                f"Stokes MINRES did not converge in {max_iter} iterations "
                f"(residual {last_info['resnorm']:.3e})"
            )

    U, P = unpack(z)
    u = Function(V, U).rename("velocity")
    p = Function(Q, P).rename("pressure")
    return u, p


def _dense_solve(WP, mu, b_c, mask, nullspace):
    """Direct LU of the assembled dense saddle-point matrix, on the host in
    float64 (small systems only: n^2 doubles)."""
    V, Q = WP.V, WP.Q
    geom = geometry(WP.mesh)
    nu = V.n_dofs * 2
    n = nu + Q.n_dofs

    A = np.zeros((n, n))
    # velocity block: mu * component-wise stiffness
    K = assembly.stiffness_local(V, geom)  # [nc, 6, 6]
    cdV = V.cell_dofs_np
    for a in range(2):
        dense.add_block(A, cdV * 2 + a, cdV * 2 + a, mu * K)
    # B block: -int q div(u); B^T: -int p div(v)
    Bref = assembly.ref_mixed(Q.degree, V.degree, 2)
    Bloc = np.einsum("e,ebk,kmj->emjb", geom.detJ, geom.G, Bref)  # [nc, 3, 6, 2]
    cdQ = Q.cell_dofs_np
    for b_comp in range(2):
        dense.add_block(A, nu + cdQ, cdV * 2 + b_comp, -Bloc[:, :, :, b_comp])
        dense.add_block(A, cdV * 2 + b_comp, nu + cdQ,
                        -np.transpose(Bloc[:, :, :, b_comp], (0, 2, 1)))

    m = mask.detach().cpu().numpy()
    A[m == 1.0, :] = 0.0
    A[:, m == 1.0] = 0.0
    A[m == 1.0, m == 1.0] = 1.0
    if nullspace is not None:
        # pin the pressure constant with a rank-1 term
        v = nullspace[0].detach().cpu().numpy()
        A = A + np.outer(v, v)
    z = np.linalg.solve(A, b_c.detach().cpu().numpy().astype(np.float64))
    return torch.as_tensor(z, dtype=b_c.dtype, device=b_c.device)


def _block_preconditioner(WP, op, free, mask):
    """Block-diagonal SPD preconditioner: Chebyshev of degree 6 on the
    viscous block, the lumped pressure mass / mu on the Schur block."""
    V, Q = WP.V, WP.Q
    mu = op.mu
    nu = V.n_dofs * 2
    geom = geometry(WP.mesh)

    def dev(a):
        return torch.as_tensor(a, dtype=op.dtype, device=op.device)

    free_u = free[:nu].reshape(V.n_dofs, 2)
    mask_u = mask[:nu].reshape(V.n_dofs, 2)

    def K_bc(U):
        y = mu * op.laplacian(free_u * U)
        return free_u * y + mask_u * U

    diag_u = dev(mu * assembly.stiffness_diag(V, geom))
    diag_u = diag_u[:, None].expand(V.n_dofs, 2)
    diag_u = free_u * diag_u + mask_u
    lmax = power_iteration_lmax(K_bc, diag_u, (V.n_dofs, 2), dtype=op.dtype)
    Mu = chebyshev_preconditioner(K_bc, diag_u, lmax, degree=6)

    Mp_diag = dev(assembly.lumped_mass_diag(Q, geom) / mu)

    def M(z):
        ru = z[:nu].reshape(V.n_dofs, 2)
        rp = z[nu:]
        return torch.cat([Mu(ru).reshape(-1), rp / Mp_diag])

    return M
