# The port's 3-D window route against the JAX package, on the CPU:
# - NSContext in 3-D (tets, BoundaryFaceTab ds-terms): the momentum residual
#   (Newton and lagged transport) and the Jacobi-CG pressure solve against
#   JAX _Context._residual / _pressure_solve_impl on the 3x3x3 box, float64,
#   to 1e-10 relative and equal CG iterations;
# - FastStepper(winkernel=True) in 3-D against the JAX einsum FastStepper on
#   the 3x3x3 lid cavity of tests/test_winmom.py (its settings, 2 steps, U
#   within 3e-6 and P within 2e-4, its bounds between the window and einsum
#   routes; measured 1.2e-8 and 2.5e-8). Newton, BiCGStab and pressure
#   iterations are equal. The correction CG at rtol 1e-12 runs the window
#   route's float32 mass apply against the einsum route's float64 one, so
#   its count may differ by up to 2 (33 and 32 here against 31);
# - run_cavity3d_fast(winkernel=True, n=4) against the JAX driver (its
#   einsum route: the JAX window route in interpret mode takes ~17 min),
#   3 steps with the JAX hierarchy's lambda_max carried across: equal
#   per-step iteration counts, t and dt to 1e-12, every solve converged, U
#   within 5e-7 and P within 2e-6 of max|P| (float32 level: the window
#   kernels compute in float32; measured 7.1e-8 and 1.3e-7); in float32
#   the same iteration counts.
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flow_tpu.fem.bc import DirichletBC as JaxDirichletBC
from flow_tpu.fem.spaces import FunctionSpace as JaxFunctionSpace
from flow_tpu.fem.spaces import VectorFunctionSpace as JaxVectorSpace
from flow_tpu.mesh3d import box_mesh as jax_box_mesh
from flow_tpu.models.cavity3d import run_cavity3d_fast as jax_run_cavity3d_fast
from flow_tpu.navier_stokes.fast import FastStepper as JaxStepper
from flow_tpu.navier_stokes.pressure_correction import _get_ctx
from flow_tpu_torch import interop
from flow_tpu_torch.fem.bc import DirichletBC
from flow_tpu_torch.fem.spaces import FunctionSpace, VectorFunctionSpace
from flow_tpu_torch.mesh3d import box_mesh
from flow_tpu_torch.models.cavity3d import run_cavity3d_fast
from flow_tpu_torch.navier_stokes.fast import FastStepper
from flow_tpu_torch.navier_stokes.pressure_correction import NSContext

torch.set_num_threads(1)

ITERS = ("newton_iters", "linear_iters", "pressure_iters", "correction_iters")
FLAGS = ("momentum_converged", "pressure_converged", "correction_converged")
J, Tt = jnp.asarray, torch.as_tensor


def _lid(x):
    return np.where(x[:, 2] > 1 - 1e-12, 1.0, 0.0)


@pytest.fixture(scope="module")
def cavity3():
    jm = jax_box_mesh((0, 0, 0), (1, 1, 1), 3, 3, 3)
    jV, jQ = JaxVectorSpace(jm, 2, n_components=3), JaxFunctionSpace(jm, 1)
    tm = box_mesh((0, 0, 0), (1, 1, 1), 3, 3, 3, dtype=torch.float64, device="cpu")
    tV, tQ = VectorFunctionSpace(tm, 2, n_components=3), FunctionSpace(tm, 1)
    jb = [JaxDirichletBC(jV.sub(0), _lid), JaxDirichletBC(jV.sub(1), 0.0),
          JaxDirichletBC(jV.sub(2), 0.0)]
    tb = [DirichletBC(tV.sub(0), _lid), DirichletBC(tV.sub(1), 0.0),
          DirichletBC(tV.sub(2), 0.0)]
    return (jV, jQ, jb), (tV, tQ, tb)


def _close(a, b, rtol=1e-10):
    b = np.asarray(b)
    np.testing.assert_allclose(a.numpy(), b, rtol=rtol, atol=rtol * np.abs(b).max())


def test_context_3d_matches_jax(cavity3):
    (jV, jQ, _), (tV, tQ, _) = cavity3
    jctx = _get_ctx(jV, jQ)
    ctx = NSContext(tV, tQ, torch.float64, torch.device("cpu"))
    assert ctx.btab.nq1 == 12 and tuple(ctx.btab.normals.shape) == (108, 3)
    rng = np.random.default_rng(5)
    U, U0, T = (rng.standard_normal((tV.n_dofs, 3)) for _ in range(3))
    P = rng.standard_normal(tQ.n_dofs)
    rho, mu, dt = 1.0, 0.05, 1e-2
    dtt = torch.tensor(dt, dtype=torch.float64)
    for transport in (None, T):
        for theta in ((0.0, 1.0), (0.5, 0.5)):
            r = ctx.residual(Tt(U), Tt(U0), Tt(P), rho, mu, dtt, theta,
                             None if transport is None else Tt(transport))
            jr = jctx._residual(J(U), J(U0), None, None, J(P), rho, mu, dt, theta,
                                transport=None if transport is None else J(transport))
            _close(r, jr)
    _close(ctx.mass_diag_V, jctx.mass_diag_V)
    _close(ctx.stiff_diag_V, jctx.stiff_diag_V)
    zero = np.zeros(tQ.n_dofs)
    p1, info = ctx.pressure_solve(Tt(U), Tt(P), 1.0, rho, dtt, mu, Tt(zero), Tt(zero),
                                  1e-10, neumann=True, rotational=True)
    jp1, jiters = jctx._pressure_solve_impl(J(U), J(P), 1.0, rho, dt, mu, J(zero),
                                            J(zero), 1e-10, neumann=True,
                                            rotational=True)[:2]
    assert info.iters == int(jiters) and bool(info.converged)
    jp1 = np.asarray(jp1)
    _close(p1 - p1.mean(), jp1 - jp1.mean(), rtol=1e-8)


@pytest.mark.parametrize("S", [128, None])
def test_stepper_3d_matches_jax_einsum(cavity3, S):
    (jV, jQ, jb), (tV, tQ, tb) = cavity3
    kw = dict(rotational_form=True, time_step_method="bdf2", newton_tol=1e-12,
              newton_rtol=1e-11, linear_rtol=1e-10, pressure_rtol=1e-11,
              correction_rtol=1e-12, cfl_target=1e9, dt_max=1.0, packed=False)
    js = JaxStepper(jV, jQ, jb, [], 1.0, 0.05, **kw)
    ts = FastStepper(tV, tQ, tb, [], 1.0, 0.05, winkernel=True, winkernel_S=S, **kw)
    assert ts.winmom.dim == 3 and ts.winmom.wl.nb == (3 if S == 128 else 1)
    UE, PE = jV.zeros(), jQ.zeros()
    UW, PW = ts.zeros()
    assert tuple(UW.shape) == (tV.n_dofs, 3)
    for _ in range(2):
        UE, PE, jstats = js.step(UE, PE, J(1e-2))
        UW, PW, tstats = ts.step(UW, PW, 1e-2)
        for key in ITERS[:3]:
            assert getattr(tstats, key) == int(getattr(jstats, key)), key
        assert abs(tstats.correction_iters - int(jstats.correction_iters)) <= 2
        assert all(bool(getattr(tstats, k)) for k in FLAGS)
    np.testing.assert_allclose(UW.numpy(), np.asarray(UE), atol=3e-6)
    np.testing.assert_allclose(PW.numpy(), np.asarray(PE), atol=2e-4)
    assert np.abs(UW.numpy()).max() == pytest.approx(1.0)  # the lid


@pytest.fixture(scope="module")
def drivers():
    jout = jax_run_cavity3d_fast(num_steps=3, n=4)
    hier = jout["stepper"].pressure_precond.__self__
    lmax = [float(L.lmax) for L in hier.levels]
    assert len(lmax) == 2
    tout = run_cavity3d_fast(num_steps=3, n=4, winkernel=True, device="cpu",
                             dtype=torch.float64, lmax=lmax, chunk_size=2)
    return jout, tout, lmax


def test_driver_matches_jax(drivers):
    jout, tout, _ = drivers
    jt, tt = jout["telemetry"], tout["telemetry"]
    assert set(tt) == set(jt) | set(FLAGS)
    for key in ITERS:
        assert tt[key].tolist() == np.asarray(jt[key]).tolist(), key
    for key in ("t", "dt"):
        np.testing.assert_allclose(tt[key], np.asarray(jt[key]), rtol=1e-12)
    assert tout["dt"] == pytest.approx(jout["dt"], rel=1e-12)
    for key in FLAGS:
        assert tt[key].all(), key
    assert len(tout["chunk_seconds"]) == 2  # a chunk of 2 and the remainder
    assert 0.0 < tout["layout_seconds"] < tout["setup_seconds"]
    # the JAX state carried across: U [n_V, 3], P [n_Q]
    Uj, Pj = interop.state_to_torch(np.asarray(jout["U"]), np.asarray(jout["P"]),
                                    device="cpu")
    assert Uj.shape == tout["U"].shape == (729, 3) and Pj.shape == tout["P"].shape
    np.testing.assert_allclose(tout["U"].numpy(), Uj.numpy(), rtol=0, atol=5e-7)
    np.testing.assert_allclose(tout["P"].numpy(), Pj.numpy(), rtol=0,
                               atol=2e-6 * float(Pj.abs().max()))
    st = tout["stepper"]
    assert st.pressure_precond.__self__.__class__.__name__ == "StructuredHierarchy"


def test_driver_in_float32_takes_the_jax_iterations(drivers):
    jout, _, lmax = drivers
    out = run_cavity3d_fast(num_steps=3, n=4, winkernel=True, device="cpu",
                            dtype=torch.float32, lmax=lmax)
    assert out["U"].dtype == torch.float32 and len(out["chunk_seconds"]) == 1
    for key in ITERS:
        assert out["telemetry"][key].tolist() == np.asarray(jout["telemetry"][key]).tolist()
    np.testing.assert_allclose(out["U"].numpy(), np.asarray(jout["U"]), rtol=0, atol=1e-5)


def test_einsum_route_raises():
    # the einsum route runs (tests/test_torch_fast_einsum.py holds it
    # against JAX); it refuses a tangent mode it does not have
    with pytest.raises(ValueError, match="tangent_mode"):
        run_cavity3d_fast(num_steps=1, n=2, device="cpu", tangent_mode="vjp")

