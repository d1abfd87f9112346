# FastStepper's einsum route (winkernel=False, the JAX package's default)
# and the two drivers on it, against the JAX package in float64 on the CPU:
# - the lagged route's element-matrix (EMA) tensor and tangent against JAX
#   FastStepper._ema_S / _ema_Jv (the tests/test_ema.py pattern), and the
#   port's written-out Newton tangent in both tangent modes against
#   jax.linearize of the Newton residual, on the DFG 2D-2 channel (open
#   outflow, so the do-nothing ds-term tangents act), to 1e-12 relative;
# - the stepper on KarmanProblem(lcar=0.1, n_refine=2) (3,659 DoF), 3 steps
#   with the CFL controller from dt0 = 1e-4 at run_karman_fast's tolerances
#   and with each package's P1Hierarchy (ELL on every level, the JAX
#   lambda_max carried across): Newton with BDF2, lagged with backward
#   Euler and with BDF2, and Newton with Crank-Nicolson, jvp tangents,
#   Eisenstat-Walker forcing to a tight absolute target and the Jacobi-CG
#   pressure solve. Iterate-exact: equal per-step Newton, BiCGStab,
#   pressure-CG and correction-CG counts, t and dt to 1e-12, U and P within
#   1e-8 (measured ~5e-15 and ~2e-9 on P of max ~2,300);
# - run_karman_fast(winkernel=False) at its defaults against the JAX driver
#   on KarmanProblem(lcar=0.2, n_refine=2) (at lcar=0.1 the coarse mesh
#   leaves the cylinder unresolved and the consistent force probe finds no
#   body dofs in either package), 3 steps, the port in chunks of 2, forces
#   included (1e-8 of max|F|);
# - run_cavity3d_fast(winkernel=False, n=4) against the JAX driver, 3 steps,
#   lambda_max carried across: equal counts, U within 1e-8 and the
#   mean-removed P within 1e-8.
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flow_tpu.models import karman as jax_karman
from flow_tpu.models.cavity3d import run_cavity3d_fast as jax_run_cavity3d_fast
from flow_tpu.navier_stokes.fast import FastStepper as JaxStepper
from flow_tpu.solvers.multigrid import P1Hierarchy as JaxHierarchy
from flow_tpu_torch import interop
from flow_tpu_torch.models import karman
from flow_tpu_torch.models.cavity3d import run_cavity3d_fast
from flow_tpu_torch.navier_stokes.fast import FastStepper
from flow_tpu_torch.solvers.multigrid import P1Hierarchy

torch.set_num_threads(1)

DRIVER = dict(
    rotational_form=True, momentum_solver="bicgstab", newton_tol=0.0,
    newton_rtol=1e-3, newton_maxiter=3, linear_rtol=1e-4, pressure_rtol=1e-4,
    correction_rtol=1e-5, cfl_target=1.0, dt_max=1.0,
)
ITERS = ("newton_iters", "linear_iters", "pressure_iters", "correction_iters")
FLAGS = ("momentum_converged", "pressure_converged", "correction_converged")
TOL = 1e-8


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def channel():
    """The DFG 2D-2 channel (open outflow) in both packages."""
    return (jax_karman.schafer_turek_problem(lcar=0.1, n_refine=0),
            karman.schafer_turek_problem(lcar=0.1, n_refine=0, dtype=torch.float64,
                                         device="cpu"))


def _state(rng, n, m=2, scale=1.0):
    return scale * rng.standard_normal((n, m))


def test_ema_tensor_and_tangent_match_jax(channel):
    jp, tp = channel
    js = JaxStepper(jp.V, jp.Q, jp.u_bcs, jp.p_bcs, jp.rho, jp.mu,
                    convection="lagged", time_step_method="bdf2")
    ts = FastStepper(tp.V, tp.Q, tp.u_bcs, tp.p_bcs, tp.rho, tp.mu,
                     convection="lagged", time_step_method="bdf2", device="cpu")
    assert js._lagged_ema and not js.packed
    rng = np.random.default_rng(7)
    n = tp.V.n_dofs
    x0, v = _state(rng, n), _state(rng, n)
    dt = 2.0e-2
    S = ts._ema_S(torch.as_tensor(x0), ts._scalar(dt))
    Sj = np.asarray(js._ema_S(jnp.asarray(x0), jnp.asarray(dt)))
    assert _rel(S.reshape(S.shape[0], -1), Sj) <= 1e-12
    got = ts._ema_Jv(S, torch.as_tensor(x0), ts._scalar(dt))(torch.as_tensor(v))
    free = 1.0 - js.mask_u
    want = js._ema_Jv(jnp.asarray(x0), jnp.asarray(dt), free)(jnp.asarray(v))
    assert _rel(got, want) <= 1e-12


@pytest.mark.parametrize("mode", ["linearize", "jvp"])
def test_newton_tangent_matches_jax_linearize(channel, mode):
    jp, tp = channel
    kw = dict(convection="newton", time_step_method="crank-nicolson")
    js = JaxStepper(jp.V, jp.Q, jp.u_bcs, jp.p_bcs, jp.rho, jp.mu, **kw)
    ts = FastStepper(tp.V, tp.Q, tp.u_bcs, tp.p_bcs, tp.rho, tp.mu, **kw,
                     tangent_mode=mode, device="cpu")
    rng = np.random.default_rng(8)
    n = tp.V.n_dofs
    x, v, U = _state(rng, n), _state(rng, n), _state(rng, n)
    P = rng.standard_normal(tp.Q.n_dofs)
    dt = 3.0e-2
    free = 1.0 - js.mask_u

    def res_bc(x):
        r = js.ctx._residual(x, jnp.asarray(U), None, None, jnp.asarray(P), js.rho,
                             js.mu, jnp.asarray(dt), js.theta)
        return free * r + js.mask_u * (x - js.val_u)

    _, Jv = jax.linearize(res_bc, jnp.asarray(x))
    got = ts._newton_Jv(torch.as_tensor(x), ts._scalar(dt))(torch.as_tensor(v))
    assert _rel(got, Jv(jnp.asarray(v))) <= 1e-12


CASES = {
    "newton-bdf2": dict(convection="newton", time_step_method="bdf2"),
    "lagged-be": dict(convection="lagged", time_step_method="backward euler"),
    "lagged-bdf2": dict(convection="lagged", time_step_method="bdf2"),
    "newton-cn-tight-jacobi": dict(
        convection="newton", time_step_method="crank-nicolson", newton_tol=1e-9,
        newton_rtol=0.0, newton_maxiter=6, ew_forcing=True, pressure_rtol=1e-10,
        correction_rtol=1e-10),
}


@pytest.fixture(scope="module")
def karman_problems():
    return (jax_karman.KarmanProblem(lcar=0.1, n_refine=2),
            karman.KarmanProblem(lcar=0.1, n_refine=2, dtype=torch.float64,
                                 device="cpu"))


@pytest.fixture(scope="module")
def jax_runs(karman_problems):
    """Each case's JAX stepper (the multigrid ones on one P1Hierarchy: one
    pressure mask) and its 3-step run from dt0 = 1e-4 -> {case: (stepper,
    output)}, and the hierarchy's lambda_max. The programs are traced in
    turn and compiled at once (XLA compiles outside the GIL)."""
    jp, _ = karman_problems
    args = (jp.V.zeros(), jp.Q.zeros(), jnp.asarray(1e-4))
    jh, steppers, lowered = None, {}, []
    for case in CASES:
        kw = {**DRIVER, **CASES[case]}
        js = JaxStepper(jp.V, jp.Q, jp.u_bcs, jp.p_bcs, jp.rho, jp.mu, **kw)
        assert not js.packed and not js.winkernel
        if "jacobi" not in case:
            if jh is None:
                jh = JaxHierarchy(jp.mesh_hierarchy, bc_mask=js.mask_p, smoother_degree=3)
            js.pressure_precond = jh.v_cycle
        steppers[case] = js
        lowered.append(js._run_jit.lower(*args, n_steps=3))
    with ThreadPoolExecutor(len(lowered)) as pool:
        compiled = list(pool.map(lambda low: low.compile(), lowered))
    return ({case: (steppers[case], run(*args)) for case, run in zip(CASES, compiled)},
            [float(L.lmax) for L in jh.levels])


@pytest.mark.parametrize("case", list(CASES))
def test_stepper_iterate_exact_with_jax(karman_problems, jax_runs, case):
    _, tp = karman_problems
    kw = {**DRIVER, **CASES[case]}
    mg = "jacobi" not in case
    (js, outj), lmax = jax_runs[0][case], jax_runs[1]
    ts = FastStepper(tp.V, tp.Q, tp.u_bcs, tp.p_bcs, tp.rho, tp.mu, **kw,
                     tangent_mode="linearize" if mg else "jvp", device="cpu")
    # the ELL kernel it takes on the card: in float64 this 425-row operator's
    # window would stage more bytes than its 16-bit indices save
    assert ts.K_Q.kernel == "direct"
    if mg:
        th = P1Hierarchy(tp.mesh_hierarchy, bc_mask=ts.mask_p, smoother_degree=3)
        interop.load_hierarchy_lmax(th, lmax)
        ts.pressure_precond = th.v_cycle
    outt = ts.run(*ts.zeros(), 1e-4, n_steps=3)
    telj, telt = outj[3], outt[3]
    for key in ITERS:
        assert telt[key].tolist() == np.asarray(telj[key]).tolist(), key
    if case == "newton-cn-tight-jacobi":
        assert max(telt["newton_iters"].tolist()) > 1
    for key in ("t", "dt"):
        np.testing.assert_allclose(telt[key].numpy(), np.asarray(telj[key]), rtol=1e-12)
    for key in FLAGS:
        assert bool(telt[key].all()), key
    np.testing.assert_allclose(outt[0].numpy(), np.asarray(outj[0]), rtol=0, atol=TOL)
    np.testing.assert_allclose(outt[1].numpy(), np.asarray(outj[1]), rtol=0, atol=TOL)
    if ts.bdf2:
        np.testing.assert_allclose(outt[4][0].numpy(), np.asarray(outj[4][0]),
                                   rtol=0, atol=TOL)
    assert np.abs(outt[0].numpy()).max() > 1e-3


def test_run_karman_fast_einsum_matches_jax():
    jout = jax_karman.run_karman_fast(num_steps=3, lcar=0.2, n_refine=2)
    jh = jout["stepper"].pressure_precond.__self__
    tout = karman.run_karman_fast(num_steps=3, lcar=0.2, n_refine=2, chunk_size=2,
                                  lmax=[float(L.lmax) for L in jh.levels],
                                  device="cpu", dtype=torch.float64)
    assert not tout["stepper"].winkernel
    jt, tt = jout["telemetry"], tout["telemetry"]
    for key in ITERS:
        assert tt[key].tolist() == np.asarray(jt[key]).tolist(), key
    for key in ("t", "dt"):
        np.testing.assert_allclose(tt[key], np.asarray(jt[key]), rtol=1e-12)
    for key in FLAGS:
        assert tt[key].all(), key
    F = np.asarray(jout["forces"])
    assert tout["forces"].shape == F.shape == (3, 2)
    np.testing.assert_allclose(tout["forces"], F, rtol=0, atol=TOL * np.abs(F).max())
    np.testing.assert_allclose(tout["u"].numpy(), np.asarray(jout["u"].vector),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(tout["p"].numpy(), np.asarray(jout["p"].vector),
                               rtol=0, atol=TOL)


def test_run_cavity3d_fast_einsum_matches_jax():
    jout = jax_run_cavity3d_fast(num_steps=3, n=4)
    lmax = [float(L.lmax) for L in jout["stepper"].pressure_precond.__self__.levels]
    tout = run_cavity3d_fast(num_steps=3, n=4, device="cpu", dtype=torch.float64,
                             lmax=lmax)
    assert not tout["stepper"].winkernel and tout["layout_seconds"] == 0.0
    jt, tt = jout["telemetry"], tout["telemetry"]
    for key in ITERS:
        assert tt[key].tolist() == np.asarray(jt[key]).tolist(), key
    for key in ("t", "dt"):
        np.testing.assert_allclose(tt[key], np.asarray(jt[key]), rtol=1e-12)
    for key in FLAGS:
        assert tt[key].all(), key
    np.testing.assert_allclose(tout["U"].numpy(), np.asarray(jout["U"]), rtol=0,
                               atol=TOL)
    dp = tout["P"].numpy() - np.asarray(jout["P"])
    np.testing.assert_allclose(dp - dp.mean(), 0.0, rtol=0, atol=TOL)
