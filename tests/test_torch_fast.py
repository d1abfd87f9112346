# flow_tpu_torch.navier_stokes.fast.FastStepper (the window-kernel route)
# against the JAX package's FastStepper with FLOW_WINKERNEL=1 on
# KarmanProblem(lcar=0.2, n_refine=1), float64 on the CPU, 3 steps with the
# CFL controller from dt0 = 1e-4 at the benchmark's tolerances (newton_rtol
# 1e-2, pressure 3e-4, correction 1e-4: the 1e-11 settings sit on a knife
# edge for the iteration counts). The pressure preconditioner is each
# package's P1Hierarchy with window levels throughout and the JAX lambda_max
# carried across. Both packages run the window kernels in float32 (the port
# its plain versions, JAX its Pallas kernels in interpret mode), so the
# state agrees at float32 level with equal per-step iteration counts: U
# within 2e-7 (measured 5.2e-8; tests/test_winmom.py allows 2e-6 between
# the window and einsum routes) and P within 1.5e-5 of max|P| (measured
# 7.2e-6). P is ~670 here (it scales with rho/dt at dt = 1e-4), so the
# 1e-4 absolute bound of tests/test_winmom.py, set for a pressure of order
# 10, is stated relative to max|P|.
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from flow_tpu.models.karman import KarmanProblem as JaxKarman
from flow_tpu.navier_stokes.fast import FastStepper as JaxStepper
from flow_tpu.solvers.multigrid import P1Hierarchy as JaxHierarchy
from flow_tpu_torch import interop
from flow_tpu_torch.models.karman import KarmanProblem, run_karman_fast
from flow_tpu_torch.navier_stokes.fast import FastStepper
from flow_tpu_torch.solvers.multigrid import P1Hierarchy

torch.set_num_threads(1)

BENCH = dict(
    convection="lagged", rotational_form=True, momentum_solver="bicgstab",
    newton_tol=0.0, newton_rtol=1e-2, pressure_rtol=3e-4,
    pressure_maxiter=600, correction_rtol=1e-4, cfl_target=1.0, dt_max=1.0,
    packed=False,
)
ITERS = ("newton_iters", "linear_iters", "pressure_iters", "correction_iters")


@pytest.fixture(scope="module")
def runs():
    mp = pytest.MonkeyPatch()
    mp.setenv("FLOW_WINKERNEL", "1")
    mp.setenv("FLOW_WINKERNEL_S", "128")
    try:
        jp = JaxKarman(lcar=0.2, n_refine=1)
        js = JaxStepper(jp.V, jp.Q, jp.u_bcs, jp.p_bcs, jp.rho, jp.mu, **BENCH)
        assert js.winkernel
        jh = JaxHierarchy(jp.mesh_hierarchy, bc_mask=js.mask_p, smoother_degree=3,
                          winkernel_min_dofs=1)
        js.pressure_precond = jh.v_cycle
        Uj, Pj, dtj, telj = js._run_jit(jp.V.zeros(), jp.Q.zeros(),
                                        jnp.asarray(1e-4), n_steps=3)
    finally:
        mp.undo()
    tp = KarmanProblem(lcar=0.2, n_refine=1, dtype=torch.float64, device="cpu")
    ts = FastStepper(tp.V, tp.Q, tp.u_bcs, tp.p_bcs, tp.rho, tp.mu,
                     winkernel=True, winkernel_S=128, **BENCH)
    th = P1Hierarchy(tp.mesh_hierarchy, bc_mask=ts.mask_p, smoother_degree=3,
                     winkernel=True, winkernel_min_dofs=1)
    interop.load_hierarchy_lmax(th, [float(L.lmax) for L in jh.levels])
    ts.pressure_precond = th.v_cycle
    assert ts.winmom.wl.nb > 1  # S=128: more than one window block
    Ut, Pt, dtt, telt = ts.run(*ts.zeros(), 1e-4, n_steps=3)
    return (Uj, Pj, dtj, telj), (Ut, Pt, dtt, telt)


def test_iteration_counts_equal_jax(runs):
    (_, _, dtj, telj), (_, _, dtt, telt) = runs
    for key in ITERS:
        assert telt[key].tolist() == np.asarray(telj[key]).tolist(), key
    for key in ("t", "dt"):
        np.testing.assert_allclose(telt[key].numpy(), np.asarray(telj[key]), rtol=1e-12)
    assert float(dtt) == pytest.approx(float(dtj), rel=1e-6)
    for key in ("momentum_converged", "pressure_converged", "correction_converged"):
        assert bool(telt[key].all()), key


def test_state_matches_jax(runs):
    (Uj, Pj, _, _), (Ut, Pt, _, _) = runs
    Un, Pn = interop.state_to_numpy(Ut, Pt)
    Pj = np.asarray(Pj)
    np.testing.assert_allclose(Un, np.asarray(Uj), rtol=0, atol=2e-7)
    np.testing.assert_allclose(Pn, Pj, rtol=0, atol=1.5e-5 * np.abs(Pj).max())
    assert np.abs(Un).max() > 1e-3  # the inflow has entered the domain


def test_state_round_trip_through_interop():
    rng = np.random.default_rng(0)
    U, P = rng.standard_normal((9, 2)), rng.standard_normal(4)
    Ut, Pt = interop.state_to_torch(U, P, device="cpu")
    Un, Pn = interop.state_to_numpy(Ut, Pt)
    np.testing.assert_array_equal(Un, U)
    np.testing.assert_array_equal(Pn, P)


@pytest.mark.parametrize("route, item", [
    # every FastStepper route is ported (tests/test_torch_fast_einsum.py,
    # test_torch_fast_packed.py, test_torch_fast_patch.py,
    # test_torch_fast_ell.py); the host driver's output writer is not
    (dict(driver=True, writer=object()), 6),
], ids=["driver-stokes"])
def test_unported_routes_raise(route, item):
    # each route raises NotImplementedError naming its ROADMAP item
    route = dict(route)
    match = f"ROADMAP queue 1 item {item}\\b"
    assert route.pop("driver")
    # the Stokes-bootstrapped host driver's output writer (io/xdmf.py)
    from flow_tpu_torch.models.karman import run_karman

    with pytest.raises(NotImplementedError, match=match):
        run_karman(num_steps=1, lcar=0.2, device="cpu", **route)
