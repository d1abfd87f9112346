# navier_stokes/diffstep.DiffStepper against the JAX package's, float64 on
# the CPU, on tests/test_diffstep.py's lid-driven cavity (pure-Neumann
# pressure) and open channel (Dirichlet pressure), unit_square_mesh(8,
# "crossed"), rho 1, mu 0.05, rotational form, dt 1e-2:
# - the forward step against the port's FastStepper(convection="lagged")
#   step (the same discrete step, increment form), and a 2-step rollout's
#   loss against the JAX DiffStepper's;
# - d(loss)/d(mu) and d(loss)/d(U0) of a 2-step rollout, loss = sum U^2 +
#   0.1 sum P^2, by torch.autograd (each solve a linear_solve whose backward
#   solves the transposed system) against jax.grad of the JAX DiffStepper
#   (1e-8 relative) and a central finite difference (tests/test_diffstep.py's
#   tolerances: 2e-5 for mu, 5e-6 for a random free-dof direction of U0).
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flow_tpu as jft
from flow_tpu.navier_stokes.diffstep import DiffStepper as JaxDiff
import flow_tpu_torch as tft
from flow_tpu_torch.navier_stokes import DiffStepper, FastStepper

torch.set_num_threads(1)

KW = dict(rho=1.0, mu=0.05, rotational_form=True)
DT = 1e-2


def _lid(x):
    return x[:, 1] > 1.0 - 1e-12


def _walls(x):
    return (x[:, 1] < 1e-12) | (x[:, 0] < 1e-12) | (x[:, 0] > 1.0 - 1e-12)


def _inflow(x):
    return x[:, 0] < 1e-12


def _channel_walls(x):
    return (x[:, 1] < 1e-12) | (x[:, 1] > 1.0 - 1e-12)


def _outflow(x):
    return x[:, 0] > 1.0 - 1e-12


def _case(pkg, case):
    """(V, Q, u_bcs, p_bcs) of a case in one package."""
    extra = dict(device="cpu", dtype=torch.float64) if pkg is tft else {}
    mesh = pkg.unit_square_mesh(8, diagonal="crossed", **extra)
    V, Q = pkg.VectorFunctionSpace(mesh, 2), pkg.FunctionSpace(mesh, 1)
    if case == "neumann":
        return V, Q, [pkg.DirichletBC(V, (1.0, 0.0), _lid),
                      pkg.DirichletBC(V, (0.0, 0.0), _walls)], []
    return V, Q, [pkg.DirichletBC(V, (lambda x: 4.0 * x[:, 1] * (1.0 - x[:, 1]), 0.0), _inflow),
                  pkg.DirichletBC(V, (0.0, 0.0), _channel_walls)], \
        [pkg.DirichletBC(Q, 0.0, _outflow)]


def _loss(step, U, P, n_steps=2, **kw):
    for _ in range(n_steps):
        U, P = step(U, P, **kw)
    return (U * U).sum() + 0.1 * (P * P).sum()


CASES = ["neumann", "dirichlet"]


@pytest.fixture(scope="module")
def pairs():
    """Each case's port DiffStepper with its spaces, and the JAX
    DiffStepper's 2-step loss and jax.grad in mu and U0 at once (one
    program a case: the rollout's VJP; traced in turn, compiled at once,
    as XLA compiles outside the GIL)."""
    out, lowered = {}, []
    for case in CASES:
        V, Q, ub, pb = _case(jft, case)
        jd = JaxDiff(V, Q, ub, pb, **KW)
        spaces = _case(tft, case)
        td = DiffStepper(*spaces, **KW)
        U0, P0 = (np.zeros(tuple(a.shape)) for a in td.st.zeros())
        f = jax.jit(jax.value_and_grad(
            lambda m, u, jd=jd, P0=P0: _loss(jd.step, u, jnp.asarray(P0), dt=jnp.asarray(DT),
                                             mu=m),
            argnums=(0, 1)))
        args = (jnp.asarray(KW["mu"]), jnp.asarray(U0))
        lowered.append((f.lower(*args), args))
        out[case] = td, spaces
    with ThreadPoolExecutor(len(lowered)) as pool:
        compiled = list(pool.map(lambda job: job[0].compile(), lowered))
    for case, run, (_, args) in zip(CASES, compiled, lowered):
        loss, gj = run(*args)
        out[case] = (float(loss),) + out[case] + ([np.asarray(g) for g in gj],)
    return out


@pytest.fixture(params=CASES)
def pair(pairs, request):
    return pairs[request.param]


def test_forward_matches_faststepper_and_jax(pair):
    loss_j, td, case, _ = pair
    fs = FastStepper(*case, convection="lagged", newton_tol=1e-13, pressure_rtol=1e-12,
                     correction_rtol=1e-12, **KW)
    ds = DiffStepper(stepper=fs, momentum_rtol=1e-12)
    U0, P0 = fs.zeros()
    U1, P1 = ds.step(U0, P0, DT)
    Ua, Pa, _ = fs.step(U0, P0, DT)
    np.testing.assert_allclose(U1.numpy(), Ua.numpy(), rtol=0, atol=5e-10)
    np.testing.assert_allclose(P1.numpy(), Pa.numpy(), rtol=0, atol=5e-9)
    # the 2-step rollout's loss against the JAX DiffStepper's
    assert float(_loss(td.step, U0, P0, dt=DT)) == pytest.approx(loss_j, rel=1e-10)


def test_grad_mu_matches_jax_and_fd(pair):
    _, td, _, (gj, _) = pair
    U0, P0 = td.st.zeros()
    mu = torch.tensor(KW["mu"], dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(_loss(td.step, U0, P0, dt=DT, mu=mu), mu)
    assert np.isfinite(float(g))
    assert float(g) == pytest.approx(float(gj), rel=1e-8)
    h = 1e-5 * KW["mu"]
    with torch.no_grad():
        fd = (_loss(td.step, U0, P0, dt=DT, mu=td.st._scalar(KW["mu"] + h))
              - _loss(td.step, U0, P0, dt=DT, mu=td.st._scalar(KW["mu"] - h))) / (2 * h)
    assert float(g) == pytest.approx(float(fd), rel=2e-5)


def test_grad_u0_adjoint_matches_jax_and_fd(pair):
    _, td, _, (_, gj) = pair
    U0, P0 = td.st.zeros()
    U = U0.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(_loss(td.step, U, P0, dt=DT), U)
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=0,
                               atol=1e-8 * np.abs(np.asarray(gj)).max())
    rng = np.random.default_rng(3)
    v = (1.0 - td.st.mask_u) * torch.as_tensor(rng.standard_normal(tuple(U0.shape)))
    h = 1e-6
    with torch.no_grad():
        fd = (_loss(td.step, U0 + h * v, P0, dt=DT) - _loss(td.step, U0 - h * v, P0, dt=DT)) / (2 * h)
    assert float((g * v).sum()) == pytest.approx(float(fd), rel=5e-6)
