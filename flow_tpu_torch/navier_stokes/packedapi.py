# The packed route of the public scheme API. Port of
# flow_tpu/navier_stokes/packedapi.py.
#
# IPCS(backend="packed").step(...) and Rotational(backend="packed") run the
# public step contract, step(dt, u, p0, u_bcs, p_bcs, rho, mu, f, ...) ->
# (u1, p1), through the packed-patch stepper (navier_stokes/patchfast.py)
# instead of the einsum context. Requirements:
#   * the mesh carries refinement parentage (built by refine_uniform, which
#     sets `mesh._coarse`): the patch layout needs the hierarchy;
#   * backward-Euler or BDF2 stepping (CN and forward Euler stay einsum);
#   * a nodal body force: a constant tuple or a vector Function on V, whose
#     interpolant the packed mass integrates exactly, as the einsum path's
#     quadrature integrates the same interpolant. General callables at
#     quadrature points are not representable and raise.
# The momentum solve keeps the public Newton contract by Picard iteration
# (the lagged residual at the iterate is the nonlinear residual), with the
# same absolute stopping test and RuntimeError on nonconvergence.
from __future__ import annotations

import time

import numpy as np
import torch

from ..fem.spaces import Function
from ..message import Message, info

__all__ = ["try_packed_step", "mesh_hierarchy_of"]


def mesh_hierarchy_of(mesh):
    """Walk the refine_uniform parentage chain; [] if the mesh has none."""
    chain = [mesh]
    while getattr(chain[0], "_coarse", None) is not None:
        chain.insert(0, chain[0]._coarse)
    return chain if len(chain) >= 2 else []


def _nodal_force(f1, V):
    """f[1] -> a nodal [n, 2] tensor, or None for a zero force; raises
    ValueError for a force the packed layout cannot represent."""
    if f1 is None:
        return None
    if isinstance(f1, Function):
        v = f1.vector
        if tuple(v.shape) == (V.n_dofs, 2):
            if not bool(torch.any(v != 0)):
                return None
            return v.to(V.mesh.dtype)
        raise ValueError(
            "packed backend: body-force Function must live on the velocity "
            f"space ([{V.n_dofs}, 2] nodal values, got {tuple(v.shape)})"
        )
    if isinstance(f1, (tuple, list)) and len(f1) == 2 and all(
        np.isscalar(c) for c in f1
    ):
        if float(f1[0]) == 0.0 and float(f1[1]) == 0.0:
            return None
        v = np.broadcast_to(np.asarray(f1, dtype=np.float64), (V.n_dofs, 2))
        return torch.as_tensor(v.copy(), dtype=V.mesh.dtype, device=V.mesh.device)
    raise ValueError(
        "packed backend supports constant-tuple or nodal-Function body "
        "forces (quadrature-point callables are not representable in the "
        "nodal layout); pass backend=None for the einsum path"
    )


def _get_stepper(V, Q, u_bcs, p_bcs, rho, mu, rotational, tol, cfg):
    """The PackedPatchStepper of this step's configuration, cached on V
    (its setup_seconds also hold build_patch_info's and the total)."""
    key = (
        id(Q), tuple(id(b) for b in u_bcs), tuple(id(b) for b in p_bcs),
        float(rho), float(mu), bool(rotational), float(tol),
        float(cfg.newton_tol), int(cfg.newton_maxiter),
    )
    cache = V.__dict__.setdefault("_packed_api_cache", {})
    st = cache.get(key)
    if st is None:
        from ..fem.patch import build_patch_info
        from .patchfast import PackedPatchStepper

        hier = mesh_hierarchy_of(V.mesh)
        if not hier:
            raise ValueError(
                "packed backend needs a refine_uniform-built mesh (the "
                "patch layout's hierarchy); build the fine mesh with "
                "refine_uniform or use backend=None"
            )
        t0 = time.perf_counter()
        patch_info = build_patch_info(hier)
        t_info = time.perf_counter() - t0
        st = PackedPatchStepper(
            V, Q, u_bcs, p_bcs, rho, mu, patch_info,
            # the public contract: the Newton absolute tolerance through
            # Picard, tight inner forcing, the pressure and correction
            # solves to the caller's tol
            newton_tol=cfg.newton_tol,
            picard_maxiter=max(2, int(cfg.newton_maxiter)),
            picard_tol=float(cfg.newton_tol),
            linear_rtol=1.0e-4,
            pressure_rtol=float(tol),
            pressure_maxiter=600,
            correction_rtol=float(tol),
            rotational_form=rotational,
            device=V.mesh.device,
            dtype=V.mesh.dtype,
        )
        st.setup_seconds = {"build_patch_info": t_info, **st.setup_seconds,
                            "total": time.perf_counter() - t0}
        cache[key] = st
    return st


def try_packed_step(
    dt, u, p0, u_bcs, p_bcs, rho, mu, time_step_method, f,
    rotational_form, tol, cfg, verbose=True, strict=True, stats=None,
):
    """One public-contract projection step through the packed stepper ->
    (u1, p1) Functions. strict=False returns None instead of raising where
    the configuration is not representable (backend="auto"). stats (a
    dict): filled with the step's Picard, linear, pressure and correction
    iterations and the momentum residual."""
    try:
        if time_step_method not in ("backward euler", "bdf2"):
            raise ValueError(
                f"packed backend: {time_step_method!r} not supported "
                "(backward euler / bdf2 only)"
            )
        dt = float(dt)
        rho = float(rho)
        mu = float(mu)
        assert dt > 0.0
        assert mu > 0.0
        u0 = u[0]
        V = u0.space
        Q = p0.space
        # BDF2 through u_hat (the einsum _step's algebra)
        u0vec = u0.vector
        dt_eff = dt
        if time_step_method == "bdf2" and -1 in u:
            u0vec = (4.0 * u[0].vector - u[-1].vector) / 3.0
            dt_eff = 2.0 * dt / 3.0
        Fn = _nodal_force(f[1] if isinstance(f, dict) else f, V)
        st = _get_stepper(
            V, Q, u_bcs, p_bcs, rho, mu, rotational_form, tol, cfg
        )
    except (ValueError, AssertionError):
        if strict:
            raise
        return None

    Uf, Pf = st.to_packed_state(u0vec, p0.vector)
    Ff = None if Fn is None else st.pack_vec(Fn)
    with Message("Computing projection step (packed backend)"):
        U1f, P1f, sst = st.step_api(Uf, Pf, dt_eff, Ff)
        nres = float(sst.newton_res)
        if verbose:
            info(
                "packed picard: iters=%d, |r|=%.3e; pressure cg: %d; "
                "mass cg: %d",
                int(sst.newton_iters), nres, int(sst.pressure_iters),
                int(sst.correction_iters),
            )
        if stats is not None:
            stats.update(newton_iters=int(sst.newton_iters), newton_res=nres,
                         linear_iters=int(sst.linear_iters),
                         pressure_iters=int(sst.pressure_iters),
                         correction_iters=int(sst.correction_iters))
        if nres > 10.0 * cfg.newton_tol:
            raise RuntimeError(
                f"Newton solver did not converge (residual {nres:.3e})"
            )
        if not bool(sst.pressure_converged):
            raise RuntimeError("Pressure Poisson solve did not converge")
        if not bool(sst.correction_converged):
            raise RuntimeError("Velocity correction solve did not converge")
    U1, P1 = st.from_packed_state(U1f, P1f)
    return Function(V, U1), Function(Q, P1)
