# flow_tpu_torch.solvers.krylov (cg, bicgstab) against the JAX package on
# small numpy systems in float64: equal iteration counts and solutions.
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from flow_tpu.solvers import krylov as jk
from flow_tpu_torch.solvers import krylov as tk

torch.set_num_threads(1)

N = 60


def _spd(rng):
    Q, _ = np.linalg.qr(rng.standard_normal((N, N)))
    return Q @ np.diag(np.geomspace(1.0, 10.0, N)) @ Q.T


def _laplacian_1d():
    """Singular path-graph Laplacian; its nullspace is the constant vector."""
    A = 2.0 * np.eye(N) - np.eye(N, k=1) - np.eye(N, k=-1)
    A[0, 0] = A[-1, -1] = 1.0
    return A


def _nonsymmetric(rng):
    return np.eye(N) * 4.0 + rng.standard_normal((N, N)) / np.sqrt(N)


def _run(solver, A, b, x0=None, precond=False, **kw):
    """Solve with the JAX and the port version; return both (x, iters)."""
    diag = np.diag(A).copy()
    out = []
    for xp, mod in ((jnp, jk), (torch, tk)):
        At = xp.asarray(A) if xp is jnp else torch.as_tensor(A)
        bt = xp.asarray(b) if xp is jnp else torch.as_tensor(b)
        dt = xp.asarray(diag) if xp is jnp else torch.as_tensor(diag)
        x0t = None if x0 is None else (
            xp.asarray(x0) if xp is jnp else torch.as_tensor(x0)
        )
        extra = dict(kw)
        if "nullspace" in extra:
            ones = np.ones(N)
            extra["nullspace"] = [
                xp.asarray(ones) if xp is jnp else torch.as_tensor(ones)
            ]
        x, info = getattr(mod, solver)(
            lambda v, At=At: At @ v, bt, x0=x0t,
            M=(lambda r, dt=dt: r / dt) if precond else None, **extra,
        )
        out.append((np.asarray(x), int(info.iters), bool(info.converged)))
    return out


@pytest.mark.parametrize("precond", [False, True])
@pytest.mark.parametrize("with_x0", [False, True])
def test_cg_spd_matches_jax(precond, with_x0):
    rng = np.random.default_rng(0)
    A = _spd(rng)
    b = rng.standard_normal(N)
    x0 = rng.standard_normal(N) if with_x0 else None
    (xj, kj, cj), (xt, kt, ct) = _run("cg", A, b, x0, precond, rtol=1e-12)
    assert kt == kj and ct == cj
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-12)


@pytest.mark.parametrize("precond", [False, True])
def test_cg_nullspace_matches_jax(precond):
    rng = np.random.default_rng(1)
    A = _laplacian_1d()
    b = rng.standard_normal(N)
    b -= b.mean()  # consistent right-hand side
    (xj, kj, cj), (xt, kt, ct) = _run(
        "cg", A, b, None, precond, rtol=1e-12, nullspace=True
    )
    assert kt == kj and ct and cj
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-12)


def test_cg_stops_at_maxiter_like_jax():
    rng = np.random.default_rng(2)
    A = _spd(rng)
    b = rng.standard_normal(N)
    (xj, kj, cj), (xt, kt, ct) = _run("cg", A, b, rtol=1e-14, maxiter=7)
    assert kt == kj == 7 and not ct and not cj
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-12)


@pytest.mark.parametrize("precond", [False, True])
@pytest.mark.parametrize("with_x0", [False, True])
def test_bicgstab_matches_jax(precond, with_x0):
    rng = np.random.default_rng(3)
    A = _nonsymmetric(rng)
    b = rng.standard_normal(N)
    x0 = rng.standard_normal(N) if with_x0 else None
    (xj, kj, cj), (xt, kt, ct) = _run(
        "bicgstab", A, b, x0, precond, rtol=1e-11
    )
    assert kt == kj and ct == cj
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-12)


def test_bicgstab_atol_and_zero_rhs_match_jax():
    # b = 0: the stall guard ends the loop after one iteration in both
    A = _nonsymmetric(np.random.default_rng(4))
    (xj, kj, _), (xt, kt, _) = _run("bicgstab", A, np.zeros(N), atol=-1.0)
    assert kt == kj
    np.testing.assert_array_equal(xt, xj)


def _run_gmres(A, b, w=None, precond=False, x0=None, **kw):
    """gmres with the JAX and the port version; both (x, iters, converged).
    With weights w, the system in the metric sum w x y, conjugated by
    sqrt(w) as the packed stepper solves it: A2 = s A s^-1, b2 = s b,
    M2 = s M s^-1, x = x2 / s."""
    diag = np.diag(A).copy()
    s = np.ones(N) if w is None else np.sqrt(w)
    out = []
    for mod, conv in ((jk, jnp.asarray), (tk, torch.as_tensor)):
        At, st, dt = conv(A), conv(s), conv(diag)
        x, info = mod.gmres(
            lambda v, At=At, st=st: st * (At @ (v / st)), st * conv(b),
            x0=None if x0 is None else st * conv(x0),
            M=(lambda r, dt=dt, st=st: st * ((r / st) / dt)) if precond else None,
            **kw,
        )
        out.append((np.asarray(x) / s, int(info.iters), bool(info.converged)))
    return out


@pytest.mark.parametrize("precond", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_gmres_matches_jax_across_restarts(precond, weighted):
    # restart 8 on a 60-unknown nonsymmetric system: several cycles
    rng = np.random.default_rng(5)
    A = np.diag(np.geomspace(1.0, 10.0, N)) + rng.standard_normal((N, N)) / np.sqrt(N)
    b = rng.standard_normal(N)
    w = rng.uniform(0.25, 1.0, N) if weighted else None
    (xj, kj, cj), (xt, kt, ct) = _run_gmres(A, b, w, precond, rtol=1e-11,
                                            restart=8)
    assert kt == kj > 8 and ct and cj
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-12)


def test_gmres_from_x0_and_maxiter_match_jax():
    rng = np.random.default_rng(6)
    A = np.diag(np.geomspace(1.0, 10.0, N)) + rng.standard_normal((N, N)) / np.sqrt(N)
    b, x0 = rng.standard_normal(N), rng.standard_normal(N)
    (xj, kj, cj), (xt, kt, ct) = _run_gmres(A, b, x0=x0, rtol=1e-14, restart=5,
                                            maxiter=12)
    # maxiter is checked between cycles: the last cycle runs to its end
    assert kt == kj == 15 and not ct and not cj
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-12)


def test_gmres_breakdown_matches_jax():
    # A = 2 I: the Krylov space is exhausted after one iteration
    b = np.random.default_rng(7).standard_normal(N)
    (xj, kj, cj), (xt, kt, ct) = _run_gmres(2.0 * np.eye(N), b, rtol=1e-12)
    assert kt == kj == 1 and ct and cj
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-14)


@pytest.mark.parametrize("dtype, rtol", [(np.float32, 1e-3), (np.float64, 1e-4)])
def test_gmres_reduced_basis_matches_jax(dtype, rtol):
    # a bfloat16 Arnoldi basis (the momentum solve's gmres_basis), restart 8:
    # equal iteration counts, the solutions at the working precision
    rng = np.random.default_rng(2)
    A = (np.diag(np.geomspace(1.0, 10.0, N))
         + rng.standard_normal((N, N)) / np.sqrt(N)).astype(dtype)
    b = rng.standard_normal(N).astype(dtype)
    xj, ij = jk.gmres(lambda v: jnp.asarray(A) @ v, jnp.asarray(b), rtol=rtol,
                      restart=8, basis_dtype=jnp.bfloat16)
    xt, it = tk.gmres(lambda v: torch.as_tensor(A) @ v, torch.as_tensor(b), rtol=rtol,
                      restart=8, basis_dtype=torch.bfloat16)
    assert it.iters == int(ij.iters) > 8 and bool(it.converged) and bool(ij.converged)
    assert float(it.resnorm) <= rtol * np.linalg.norm(b)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0,
                               atol=1e-4 if dtype == np.float32 else 1e-12)
