"""Shared parity helpers for the box stepper tests of flow_tpu_torch
against the JAX package (tests/test_torch_boxfast*.py)."""
import numpy as np
import pytest

from flow_tpu.navier_stokes.boxfast import BoxPackedStepper as JaxStepper
from flow_tpu_torch import interop
from flow_tpu_torch.navier_stokes.boxfast import BoxPackedStepper

# the settings of tests/test_boxpack.py's stepper parity
TIGHT = dict(
    newton_tol=1e-12, newton_rtol=0.0, pressure_rtol=1e-11,
    correction_rtol=1e-11,
)
ITERS = ("linear_iters", "pressure_iters", "correction_iters")


def steppers(problems, **kw):
    jp, tp = problems
    js = JaxStepper(jp.V, jp.Q, jp.u_bcs, jp.p_bcs, jp.rho, jp.mu,
                    momentum_solver="bicgstab", **kw)
    ts = BoxPackedStepper(tp.V, tp.Q, tp.u_bcs, tp.p_bcs, tp.rho, tp.mu, **kw)
    jh = js.pressure_precond.__self__
    interop.load_hierarchy_lmax(ts.hierarchy, [float(L.lmax) for L in jh.levels])
    return js, ts


def assert_state_close(js, ts, Uj, Pj, Ut, Pt):
    Uj_std = np.asarray(js.from_packed_state(Uj, Pj)[0])
    Ut_std = ts.from_packed_state(Ut, Pt)[0].numpy()
    np.testing.assert_allclose(Ut_std, Uj_std, rtol=0, atol=1e-10)
    dp = Pt.numpy() - np.asarray(Pj)
    np.testing.assert_allclose(dp - dp.mean(), 0.0, rtol=0, atol=1e-8)


def run_both(js, ts, n_steps):
    Uj, Pj, dtj, telj = js.run(*js.zeros(), 1e-3, n_steps=n_steps)
    Ut, Pt, dtt, telt = ts.run(*ts.zeros(), 1e-3, n_steps=n_steps)
    for key in ITERS + ("newton_iters",):
        assert telt[key].tolist() == np.asarray(telj[key]).tolist(), key
    for key in ("t", "dt"):
        np.testing.assert_allclose(
            telt[key].numpy(), np.asarray(telj[key]), rtol=1e-12, atol=0
        )
    assert float(dtt) == pytest.approx(float(dtj), rel=1e-12)
    assert_state_close(js, ts, Uj, Pj, Ut, Pt)
    return telt
