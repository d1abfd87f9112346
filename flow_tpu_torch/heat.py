# Convection-diffusion ("heat") operator with optional SUPG stabilization.
# Port of flow_tpu/heat.py: an operator for u' = F(t, u), consumed by the
# parabolic steppers through eval_alpha_M_beta_F / solve_alpha_M_beta_F.
#
#   M: mass matrix with vertex quadrature (lumping; for P2 the rows of the
#      edge-midpoint dofs are zero)
#   F(u) = int [ -kappa/(rho cp) grad(u).grad(v) - (b.grad u) v + s v ] dx
#      (+ SUPG terms on M and F)
#
# The forms are written in fem/formlang.py and compiled to element
# matrices on the mesh's device. Every operator apply and load vector sums
# its element contributions with fem/gathersum.GatherSum (a fixed order,
# so the heat solve's iteration counts repeat on the card; the space's
# index_add_ dof_sum is not used here). The solver choice is the JAX
# package's: dense below DENSE_THRESHOLD dofs, the on-device 'mg' path
# (GMRES(120) preconditioned by the shifted P1 multigrid of
# solvers/shifted_mg.py) where a mesh hierarchy is given, else the host
# scipy splu of the assembled operator.
from __future__ import annotations

import time

import numpy as np
import torch

from . import stabilization
from .fem import assembly, quadrature
from .fem import formlang as fl
from .fem.assembly import geometry, tabulation
from .fem.bc import combine_bcs
from .fem.gathersum import gather_sum_of
from .fem.interpolate import eval_callable
from .fem.spaces import Function, FunctionSpace
from .solvers import krylov

__all__ = ["Heat", "DENSE_THRESHOLD"]

DENSE_THRESHOLD = 6000


class Heat:
    """alpha*M*u + beta*F(t, u) evaluation and solves on V (on its mesh's
    device, in its dtype). last_solve: {"solver", "iters", "resnorm"} of
    the last solve_alpha_M_beta_F, and on the splu path the host seconds
    of getting the factorization (a cached one costs nothing)."""

    def __init__(
        self,
        V: FunctionSpace,
        conv,
        kappa,
        rho,
        cp,
        bcs,
        source,
        supg_stabilization=False,
        rule_degree=None,
        mesh_hierarchy=None,
    ):
        """mesh_hierarchy (optional): the refine_uniform chain ending at
        V.mesh; it enables the on-device multigrid-GMRES solve ('mg', the
        automatic choice above DENSE_THRESHOLD dofs)."""
        self.V = V
        self.bcs = bcs
        mesh = V.mesh
        dtype, device = mesh.dtype, mesh.device
        geom = geometry(mesh)
        self.geom = geom
        rho_cp = rho * cp
        self.mesh_hierarchy = mesh_hierarchy
        if mesh_hierarchy is not None:
            assert mesh_hierarchy[-1] is mesh, "mesh_hierarchy must end at V.mesh"
        self._kappa_prime = float(kappa) / float(rho_cp)

        deg = V.degree
        rd = rule_degree or (2 * deg + 1)
        tab = tabulation(V, rd)
        xq = torch.as_tensor(geom.physical_points(tab.ref_pts), dtype=dtype,
                             device=device)
        # convection at the quadrature points
        if conv is None:
            bq = None
        elif isinstance(conv, Function):
            ctab = tabulation(conv.space, rd).on(dtype, device)
            bq = assembly.values_at_qp(ctab, conv.space.gather(conv.vector))
        else:
            bq = eval_callable(conv, xq)

        u, v = fl.TrialFunction(V), fl.TestFunction(V)
        # M: vertex-quadrature ("lumped") mass
        M_loc = fl.compile_form(u * v, geom, quadrature.VERTEX).local()
        # A: -kappa/(rho cp) grad(u).grad(v) - (b.grad u) v
        A_form = (-(kappa / rho_cp)) * fl.dot(fl.grad(u), fl.grad(v))
        if bq is not None:
            b_c = fl.Coefficient(bq, vector=True)  # [nc, nq, dim] at this rule
            A_form = A_form - fl.dot(b_c, fl.grad(u)) * v
        A_loc = fl.compile_form(A_form, geom, rd).local()
        # b: the source term
        if isinstance(source, Function):
            stab_t = tabulation(source.space, rd).on(dtype, device)
            sq = assembly.values_at_qp(stab_t, source.space.gather(source.vector))
        else:
            sq = eval_callable(source, xq)
        b_loc = fl.compile_form(fl.Coefficient(sq) * v, geom, rd).local()

        # SUPG: every term gets the streamline test factor tau (b.grad v);
        # the strong residual contributes the basis Laplacian
        if supg_stabilization:
            assert conv is not None
            tau = stabilization.supg_tau(mesh, bq, kappa, deg)  # [nc, nq]
            vstab = fl.Coefficient(tau) * fl.dot(b_c, fl.grad(v))
            M_loc = M_loc + fl.compile_form(u * vstab, geom, rd).local()
            A_loc = A_loc + fl.compile_form(
                ((kappa / rho_cp) * fl.lap(u)) * vstab
                - fl.dot(b_c, fl.grad(u)) * vstab,
                geom,
                rd,
            ).local()
            b_loc = b_loc + fl.compile_form(
                fl.Coefficient(sq / rho_cp) * vstab, geom, rd
            ).local()

        self.M_loc = M_loc
        self.A_loc = A_loc
        self._sum = gather_sum_of(V, device)
        self.b_vec = self._sum(b_loc)
        mask, vals = combine_bcs(V, bcs)
        self._mask_np = mask
        self.mask = torch.as_tensor(mask, dtype=dtype, device=device)
        self.bc_vals = torch.as_tensor(vals, dtype=dtype, device=device)
        self._lu_cache = {}  # (alpha, beta) -> factorized sparse operator
        self.last_solve = None
        # cell-mean |convection|: the streamline-upwind artificial diffusion
        # kappa' + |b| h / 2 of the multigrid levels (solvers/shifted_mg.py)
        self._bmag_cell = None
        if bq is not None:
            self._bmag_cell = torch.mean(torch.sqrt(torch.sum(bq * bq, dim=-1)),
                                         dim=1).cpu().numpy()

    # -- operator actions -----------------------------------------------------
    def _apply_loc(self, loc, u):
        return self._sum(torch.einsum("eil,el->ei", loc, self.V.gather(u)))

    def M_apply(self, u):
        return self._apply_loc(self.M_loc, u)

    def A_apply(self, u):
        return self._apply_loc(self.A_loc, u)

    def eval_alpha_M_beta_F(self, alpha, beta, u, t):
        """alpha * M * u + beta * F(u, t)."""
        uvec = u.vector if isinstance(u, Function) else u
        alpha = float(alpha)
        beta = float(beta)
        return alpha * self.M_apply(uvec) + beta * (self.A_apply(uvec) + self.b_vec)

    def solve_alpha_M_beta_F(self, alpha, beta, b, t, solver=None):
        """Solve (alpha M + beta A) u = b - beta*b_vec with the Dirichlet
        rows replaced by the boundary values.

        solver=None: 'direct' up to DENSE_THRESHOLD dofs (a dense solve);
        above it 'mg' where a mesh_hierarchy was given, else 'direct' (the
        host scipy splu). 'mg': GMRES(120) preconditioned by a V-cycle of
        the shifted P1 multigrid on alpha*M_lumped + (-beta)*kappa' K (the
        convection and SUPG parts are left to GMRES); 'gmres':
        Jacobi-GMRES. Raises RuntimeError where an iterative solve does
        not converge."""
        alpha = float(alpha)
        beta = float(beta)
        if solver is None:
            if self.V.n_dofs <= DENSE_THRESHOLD:
                solver = "direct"
            elif self.mesh_hierarchy is not None:
                solver = "mg"
            else:
                solver = "direct"  # host splu
        S_loc = alpha * self.M_loc + beta * self.A_loc
        rhs = b - beta * self.b_vec
        mask, vals = self.mask, self.bc_vals
        rhs = (1.0 - mask) * rhs + mask * vals
        f64 = rhs.dtype == torch.float64

        if solver in ("mg", "gmres"):
            free = 1.0 - mask

            def op(x):
                return free * self._apply_loc(S_loc, x) + mask * x

            if solver == "mg":
                hier = self._mg_hierarchy()
                c = max(-beta, 0.0)

                def M(r):
                    return hier.v_cycle(r, shift=alpha, c=c)

                # 1e-11: the solution error is rtol x cond(S); above the
                # float64 matvec noise floor (1e-12 was unreachable)
                rtol = 1e-11 if f64 else 1e-6
                # a long restart: the preconditioned spectrum of
                # convection-dominated operators spreads in the complex
                # plane, and GMRES(40) can stall
                x, sinfo = krylov.gmres(op, rhs, M=M, rtol=rtol, maxiter=600,
                                        restart=120)
                what = "Heat MG-GMRES solve"
            else:
                diag = self._sum(torch.einsum("eii->ei", S_loc))
                diag = free * diag + mask
                diag = torch.where(torch.abs(diag) < 1e-300, torch.ones_like(diag), diag)
                rtol = 1e-12 if f64 else 1e-6
                x, sinfo = krylov.gmres(op, rhs, M=lambda r: r / diag, rtol=rtol,
                                        maxiter=2000)
                what = "Heat solve"
            self.last_solve = {"solver": solver, "iters": sinfo.iters,
                               "resnorm": float(sinfo.resnorm)}
            if not bool(sinfo.converged):
                raise RuntimeError(f"{what} did not converge")
            return Function(self.V, x)

        assert solver == "direct", solver
        rhs_np = rhs.detach().cpu().numpy().astype(np.float64)
        if self.V.n_dofs <= DENSE_THRESHOLD:
            from .fem import dense

            S = dense.scalar_dense(self.V, S_loc.detach().cpu().numpy())
            m = self._mask_np == 1.0
            S[m, :] = 0.0
            S[m, m] = 1.0
            x = np.linalg.solve(S, rhs_np)
            self.last_solve = {"solver": "dense", "iters": 0, "resnorm": None}
        else:
            t0 = time.perf_counter()
            lu = self._sparse_lu(alpha, beta, S_loc)
            self.last_solve = {"solver": "splu", "iters": 0, "resnorm": None,
                               "factor_seconds": time.perf_counter() - t0}
            x = lu.solve(rhs_np)
        return Function(self.V, torch.as_tensor(x, dtype=rhs.dtype, device=rhs.device))

    def _mg_hierarchy(self):
        """The shifted multigrid preconditioner of the symmetric part,
        cached on the fine mesh (the Boussinesq driver rebuilds its Heat
        every Banach sweep with the same structure; only the BC values and
        alpha change, and the hierarchy depends on neither)."""
        assert self.mesh_hierarchy is not None, (
            "solver='mg' needs mesh_hierarchy=[coarse...fine]"
        )
        from .solvers.shifted_mg import ShiftedP1Hierarchy

        mesh = self.V.mesh
        # streamline-upwind artificial diffusion on the discretization
        # mesh: kappa_eff = kappa' + |b| h / 2 (without it the
        # pure-diffusion V-cycle is an indefinite preconditioner of
        # convection-dominated operators)
        extra_mesh = None
        if self._bmag_cell is not None:
            detJ = self.geom.detJ
            if getattr(mesh, "dim", 2) == 3:
                h = np.cbrt(6.0 * np.abs(detJ))
            else:
                h = np.sqrt(2.0 * np.abs(detJ))
            extra_mesh = 0.5 * self._bmag_cell * h
        # the cache is bucketed by the convection strength's power of two:
        # a slightly stale streamline coefficient is a fine preconditioner,
        # a hierarchy rebuilt every sweep is not
        if extra_mesh is None:
            bucket = None
        else:
            ratio = float(extra_mesh.max()) / max(self._kappa_prime, 1e-300)
            bucket = int(np.ceil(np.log2(max(ratio, 1.0))))
        key = (
            self.V.degree,
            round(self._kappa_prime, 14),
            hash(self._mask_np.tobytes()),
            bucket,
        )
        cache = mesh.__dict__.setdefault("_heat_mg_cache", {})
        hier = cache.get(key)
        if hier is None:
            meshes = list(self.mesh_hierarchy)
            nlev = len(meshes)
            extras = None
            if extra_mesh is not None:
                extras = [None] * nlev
                extras[-1] = extra_mesh
                for l in range(nlev - 2, -1, -1):
                    ncp = meshes[l].n_cells
                    ch = extras[l + 1].reshape(-1, ncp)
                    extras[l] = ch.mean(axis=0)
            if self.V.degree == 2:
                # P2 dofs on mesh == P1 dofs on refine(mesh), in order: one
                # extra preconditioner-side level
                fine = getattr(mesh, "_heat_mg_refined", None)
                if fine is None:
                    if getattr(mesh, "dim", 2) == 3:
                        from .mesh3d import refine_uniform_tet

                        fine = refine_uniform_tet(mesh)
                    else:
                        from .mesh import refine_uniform

                        fine = refine_uniform(mesh)
                    mesh._heat_mg_refined = fine
                meshes = meshes + [fine]
                if extras is not None:
                    # the same continuous coefficient on the children
                    nchild = fine.n_cells // mesh.n_cells
                    extras = extras + [np.tile(extra_mesh, nchild)]
            hier = ShiftedP1Hierarchy(
                meshes,
                bc_mask=self._mask_np,
                kappa=self._kappa_prime,
                smoother_degree=2,
                extra_diff=extras,
            )
            cache[key] = hier
        return hier

    def _sparse_lu(self, alpha, beta, S_loc):
        """Cached scipy splu of the BC-constrained operator (host setup,
        reused for the same (alpha, beta))."""
        key = (alpha, beta)
        lu = self._lu_cache.get(key)
        if lu is None:
            import scipy.sparse
            import scipy.sparse.linalg

            cd = self.V.cell_dofs_np.astype(np.int64)
            nl = cd.shape[1]
            n = self.V.n_dofs
            rows = np.repeat(cd, nl, axis=1).ravel()
            cols = np.tile(cd, (1, nl)).ravel()
            vals = S_loc.detach().cpu().numpy().astype(np.float64).ravel()
            S = scipy.sparse.csr_matrix((vals, (rows, cols)), shape=(n, n))
            m = self._mask_np == 1.0
            # Dirichlet row replacement: zero the rows, unit diagonal
            D = scipy.sparse.diags(np.where(m, 0.0, 1.0))
            S = D @ S + scipy.sparse.diags(m.astype(np.float64))
            lu = scipy.sparse.linalg.splu(S.tocsc())
            self._lu_cache[key] = lu
        return lu
