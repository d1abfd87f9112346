# flow_tpu_torch.navier_stokes.patchfast.PackedPatchStepper against the JAX
# package's, float64 on the CPU, KarmanProblem(lcar=0.1, n_refine=2), at
# tests/test_patchfast.py's tight tolerances, the JAX hierarchy's lambda_max
# carried across:
# - BiCGStab, backward Euler: one step, then a 3-step run with the CFL
#   controller;
# - BiCGStab, BDF2: a 3-step run;
# - GMRES (the sqrt-weight-conjugated solve): one step;
# equal per-step iteration counts, U within 1e-10, the mean-removed P within
# 1e-8 and dt within 1e-12. One JAX stepper serves every case: its time
# scheme, momentum solver and forces probe are read when a run is traced,
# so JAX's own 3-step run is jitted once for each (solver, scheme) with
# its flags set and a probe that records each step's state; a run's first
# step is the step test's reference. Then the port alone: the packed
# state round trip, a body force through step_api, the Picard mode and the
# argument checks.
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import jax

from flow_tpu.fem.patch import build_patch_info as jax_patch_info
from flow_tpu.models.karman import KarmanProblem as JaxProblem
from flow_tpu.navier_stokes.patchfast import PackedPatchStepper as JaxStepper
from flow_tpu_torch import interop
from flow_tpu_torch.fem.patch import build_patch_info
from flow_tpu_torch.models.karman import KarmanProblem
from flow_tpu_torch.navier_stokes.patchfast import PackedPatchStepper

torch.set_num_threads(1)

TIGHT = dict(newton_tol=1e-12, newton_rtol=0.0, pressure_rtol=1e-11,
             correction_rtol=1e-11, mg_smoother_degree=3)
ITERS = ("newton_iters", "linear_iters", "pressure_iters", "correction_iters")
DT0 = 1e-3


@pytest.fixture(scope="module")
def jax_side():
    jp = JaxProblem(lcar=0.1, n_refine=2)
    js = JaxStepper(jp.V, jp.Q, jp.u_bcs, jp.p_bcs, jp.rho, jp.mu,
                    jax_patch_info(jp.mesh_hierarchy), momentum_solver="bicgstab",
                    **TIGHT)
    lmax = [float(L.lmax) for L in js.pressure_precond.__self__.levels]
    return js, lmax


@pytest.fixture(scope="module")
def problem():
    return KarmanProblem(lcar=0.1, n_refine=2, dtype=torch.float64, device="cpu")


def _port(problem, lmax=None, **kw):
    p = problem
    st = PackedPatchStepper(p.V, p.Q, p.u_bcs, p.p_bcs, p.rho, p.mu,
                            build_patch_info(p.mesh_hierarchy), **dict(TIGHT, **kw))
    if lmax is not None:
        interop.load_hierarchy_lmax(st.hierarchy, lmax)
    return st


def _jax_with(js, **flags):
    """Trace JAX's stepper with its route flags set, then restore them."""
    saved = {k: getattr(js, k) for k in flags}
    for k, v in flags.items():
        setattr(js, k, v)
    return saved


def _global_state(js, Uj, Pj):
    return tuple(np.asarray(a) for a in js.from_packed_state(Uj, Pj))


def _assert_state(ts, Ug_j, Pg_j, Ut, Pt):
    Ug_t, Pg_t = (a.numpy() for a in ts.from_packed_state(Ut, Pt))
    np.testing.assert_allclose(Ug_t, Ug_j, rtol=0, atol=1e-10)
    dp = Pg_t - Pg_j
    np.testing.assert_allclose(dp - dp.mean(), 0.0, rtol=0, atol=1e-8)


def _jax_lowered(js, solver, bdf2):
    """JAX's own run (patchfast.py _run_impl, 3 steps from rest), traced
    with the route flags set; its forces probe hands back each step's
    global-layout state, so the run's first step is a step reference."""
    saved = _jax_with(js, mom_solver=solver, bdf2=bdf2, forces_probe=lambda U, P: (U, P))
    try:
        return jax.jit(js._run_impl, static_argnames=("n_steps",)).lower(
            *js.zeros(), DT0, n_steps=3)
    finally:
        _jax_with(js, **saved)


@pytest.fixture(scope="module")
def jax_runs(jax_side):
    """The three JAX programs of this file, each compiled once: BiCGStab
    with backward Euler (the step and the run reference), GMRES with
    backward Euler (the step reference) and BiCGStab with BDF2 (the run
    reference). XLA compiles outside the GIL, so the three compile at
    once."""
    js, _ = jax_side
    keys = (("bicgstab", False), ("gmres", False), ("bicgstab", True))
    lowered = [_jax_lowered(js, *key) for key in keys]
    with ThreadPoolExecutor(len(keys)) as pool:
        compiled = list(pool.map(lambda low: low.compile(), lowered))
    return {key: run(*js.zeros(), DT0) for key, run in zip(keys, compiled)}


@pytest.mark.parametrize("solver", ["bicgstab", "gmres"])
def test_step_matches_jax(jax_side, jax_runs, problem, solver):
    _, lmax = jax_side
    telj = jax_runs[solver, False][3]
    ts = _port(problem, lmax, momentum_solver=solver)
    Ut, Pt, st = ts.step(*ts.zeros(), DT0)
    for key in ITERS:
        assert int(getattr(st, key)) == int(telj[key][0]), key
    assert bool(st.pressure_converged) and bool(st.correction_converged)
    assert int(st.linear_iters) > 1
    Ug_j, Pg_j = (np.asarray(a[0]) for a in telj["forces"])
    _assert_state(ts, Ug_j, Pg_j, Ut, Pt)


@pytest.mark.parametrize("method", ["backward euler", "bdf2"])
def test_run_matches_jax(jax_side, jax_runs, problem, method):
    js, lmax = jax_side
    out_j = jax_runs["bicgstab", method == "bdf2"]
    ts = _port(problem, lmax, momentum_solver="bicgstab", time_step_method=method)
    out_t = ts.run(*ts.zeros(), DT0, 3)
    assert len(out_t) == len(out_j) == (5 if method == "bdf2" else 4)
    telj, telt = out_j[3], out_t[3]
    for key in ITERS:
        assert telt[key].tolist() == np.asarray(telj[key]).tolist(), key
    for key in ("t", "dt"):
        np.testing.assert_allclose(telt[key].numpy(), np.asarray(telj[key]), rtol=0,
                                   atol=1e-12)
    for key in ("momentum_converged", "pressure_converged", "correction_converged"):
        assert bool(telt[key].all()), key
    assert abs(float(out_t[2]) - float(out_j[2])) < 1e-12
    _assert_state(ts, *_global_state(js, out_j[0], out_j[1]), out_t[0], out_t[1])
    if method == "bdf2":
        Um1_j, dtp_j = out_j[4]
        Um1_t, dtp_t = out_t[4]
        np.testing.assert_allclose(Um1_t.numpy(), np.asarray(Um1_j), rtol=0, atol=1e-10)
        assert abs(float(dtp_t) - float(dtp_j)) < 1e-12


def test_packed_state_round_trip(problem):
    ts = _port(problem)
    rng = np.random.default_rng(3)
    U = rng.standard_normal((problem.V.n_dofs, 2))
    P = rng.standard_normal(problem.Q.n_dofs)
    Uf, Pf = ts.to_packed_state(U, P)
    assert Uf.shape == (2 * ts.pp.n2,) and Pf.shape == (ts.pp.n1,)
    Ub, Pb = ts.from_packed_state(Uf, Pf)
    np.testing.assert_array_equal(Ub.numpy(), U)
    np.testing.assert_array_equal(Pb.numpy(), P)
    # the weighted metric of packed state is the global one
    assert float(ts.dotv(Uf, Uf)) == pytest.approx(float((U * U).sum()), rel=1e-13)
    assert float(ts.dotp(Pf, Pf)) == pytest.approx(float((P * P).sum()), rel=1e-13)


def test_step_api_body_force_and_picard(problem):
    # a zero body force is no body force; Picard to a tight tolerance runs
    # more than one lagged solve and ends below it
    ts = _port(problem, momentum_solver="bicgstab")
    Uf, Pf = ts.zeros()
    U1, P1, s1 = ts.step_api(Uf, Pf, DT0)
    U2, P2, s2 = ts.step_api(Uf, Pf, DT0, Ff=torch.zeros_like(Uf))
    np.testing.assert_array_equal(U2.numpy(), U1.numpy())
    tp = _port(problem, momentum_solver="bicgstab", picard_maxiter=4,
               picard_tol=1e-13, linear_rtol=1e-6)
    U3, _, s3 = tp.step(*tp.zeros(), 10 * DT0)
    assert 1 < s3.newton_iters <= 4 and bool(s3.momentum_converged)
    assert float(s3.newton_res) <= 1e-13


@pytest.mark.parametrize("kw", [dict(time_step_method="crank-nicolson"),
                                dict(momentum_solver="minres")])
def test_unknown_options_raise(problem, kw):
    with pytest.raises(ValueError):
        _port(problem, **kw)
