# flow_tpu_torch.navier_stokes.fast.FastStepper on the window route with
# Newton convection and BDF2 (the route of run_karman_fast's defaults, with
# the DFG shedding runs' scheme) against the JAX package's FastStepper with
# FLOW_WINKERNEL=1 on KarmanProblem(lcar=0.2, n_refine=1), float64 on the
# CPU, 3 steps with the CFL controller from dt0 = 1e-4, at the driver's
# tolerances (newton_rtol 1e-3, newton_maxiter 3, linear_rtol 1e-4,
# pressure 1e-4, correction 1e-5). The pressure preconditioner is each
# package's P1Hierarchy with window levels throughout and the JAX lambda_max
# carried across. Both packages run the window kernels in float32 (the port
# its plain versions, JAX its Pallas kernels in interpret mode: K3 in Newton
# mode for every momentum matvec), so the state agrees at float32 level with
# equal per-step Newton, linear, pressure and correction iterations: U (and
# BDF2's previous velocity) within 2e-7, the bound of
# tests/test_torch_fast.py (measured 1.04e-7), and P within 4e-5 of max|P|
# (measured 1.82e-5 of max|P| = 6204, above the lagged route's bound of
# 1.5e-5; the lagged test measures 7.2e-6 of 673).
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from flow_tpu.models.karman import KarmanProblem as JaxKarman
from flow_tpu.navier_stokes.fast import FastStepper as JaxStepper
from flow_tpu.solvers.multigrid import P1Hierarchy as JaxHierarchy
from flow_tpu_torch import interop
from flow_tpu_torch.models.karman import KarmanProblem
from flow_tpu_torch.navier_stokes.fast import FastStepper
from flow_tpu_torch.solvers.multigrid import P1Hierarchy

torch.set_num_threads(1)

DRIVER = dict(
    convection="newton", time_step_method="bdf2", rotational_form=True,
    momentum_solver="bicgstab", newton_tol=0.0, newton_rtol=1e-3,
    newton_maxiter=3, linear_rtol=1e-4, ew_forcing=False, pressure_rtol=1e-4,
    correction_rtol=1e-5, cfl_target=1.0, dt_max=1.0, packed=False,
)
ITERS = ("newton_iters", "linear_iters", "pressure_iters", "correction_iters")


@pytest.fixture(scope="module")
def runs():
    mp = pytest.MonkeyPatch()
    mp.setenv("FLOW_WINKERNEL", "1")
    mp.setenv("FLOW_WINKERNEL_S", "128")
    try:
        jp = JaxKarman(lcar=0.2, n_refine=1)
        js = JaxStepper(jp.V, jp.Q, jp.u_bcs, jp.p_bcs, jp.rho, jp.mu, **DRIVER)
        assert js.winkernel and js.bdf2 and not js.lagged
        jh = JaxHierarchy(jp.mesh_hierarchy, bc_mask=js.mask_p, smoother_degree=3,
                          winkernel_min_dofs=1)
        js.pressure_precond = jh.v_cycle
        Uj, Pj, dtj, telj, (Um1j, dtpj) = js._run_jit(
            jp.V.zeros(), jp.Q.zeros(), jnp.asarray(1e-4), n_steps=3)
    finally:
        mp.undo()
    tp = KarmanProblem(lcar=0.2, n_refine=1, dtype=torch.float64, device="cpu")
    ts = FastStepper(tp.V, tp.Q, tp.u_bcs, tp.p_bcs, tp.rho, tp.mu,
                     winkernel=True, winkernel_S=128, **DRIVER)
    th = P1Hierarchy(tp.mesh_hierarchy, bc_mask=ts.mask_p, smoother_degree=3,
                     winkernel=True, winkernel_min_dofs=1)
    interop.load_hierarchy_lmax(th, [float(L.lmax) for L in jh.levels])
    ts.pressure_precond = th.v_cycle
    assert ts.winmom.wl.nb > 1  # S=128: more than one window block
    Ut, Pt, dtt, telt, (Um1t, dtpt) = ts.run(*ts.zeros(), 1e-4, n_steps=3)
    return (Uj, Pj, dtj, telj, Um1j, dtpj), (Ut, Pt, dtt, telt, Um1t, dtpt)


def test_newton_bdf2_iteration_counts_equal_jax(runs):
    (_, _, dtj, telj, _, dtpj), (_, _, dtt, telt, _, dtpt) = runs
    for key in ITERS:
        assert telt[key].tolist() == np.asarray(telj[key]).tolist(), key
    for key in ("t", "dt"):
        np.testing.assert_allclose(telt[key].numpy(), np.asarray(telj[key]), rtol=1e-12)
    assert float(dtt) == pytest.approx(float(dtj), rel=1e-6)
    assert float(dtpt) == pytest.approx(float(dtpj), rel=1e-12)
    for key in ("momentum_converged", "pressure_converged", "correction_converged"):
        assert bool(telt[key].all()), key


def test_newton_bdf2_state_matches_jax(runs):
    (Uj, Pj, _, _, Um1j, _), (Ut, Pt, _, _, Um1t, _) = runs
    Un, Pn, Um1n = interop.state_to_numpy(Ut, Pt, Um1=Um1t)
    Pj = np.asarray(Pj)
    np.testing.assert_allclose(Un, np.asarray(Uj), rtol=0, atol=2e-7)
    np.testing.assert_allclose(Um1n, np.asarray(Um1j), rtol=0, atol=2e-7)
    np.testing.assert_allclose(Pn, Pj, rtol=0, atol=4e-5 * np.abs(Pj).max())
    assert np.abs(Un).max() > 1e-3  # the inflow has entered the domain
