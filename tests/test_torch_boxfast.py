# flow_tpu_torch.navier_stokes.boxfast.BoxPackedStepper against the JAX
# package's BoxPackedStepper on Cavity3DProblem(n=4), float64 on the CPU:
# iterate-exact (equal per-step Krylov iteration counts, U within 1e-10, the
# mean-removed P within 1e-8). The multigrid lambda_max estimates are
# carried across from the JAX hierarchy (interop.load_hierarchy_lmax).
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from flow_tpu.models.cavity3d import Cavity3DProblem as JaxCavity
from flow_tpu_torch import interop
from flow_tpu_torch.models.cavity3d import Cavity3DProblem
from torch_parity import ITERS, TIGHT, assert_state_close, run_both, steppers

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def problems():
    return JaxCavity(n=4, mu=0.01), Cavity3DProblem(n=4, mu=0.01, dtype=torch.float64)


@pytest.fixture(scope="module")
def tight_steppers(problems):
    return steppers(problems, **TIGHT)


def test_step_matches_jax(tight_steppers):
    js, ts = tight_steppers
    Uj, Pj = js.zeros()
    Ut, Pt = ts.zeros()
    for _ in range(2):
        Uj, Pj, sj = js.step(Uj, Pj, jnp.asarray(1e-3))
        Ut, Pt, st = ts.step(Ut, Pt, 1e-3)
        for key in ITERS:
            assert getattr(st, key) == int(getattr(sj, key)), key
        assert bool(st.pressure_converged) and bool(st.correction_converged)
        assert_state_close(js, ts, Uj, Pj, Ut, Pt)


def test_run_with_cfl_controller_matches_jax(tight_steppers):
    # dt_max 0.1, cfl_target 1: the controller doubles dt from 1e-3
    js, ts = tight_steppers
    tel = run_both(js, ts, 3)
    np.testing.assert_allclose(tel["dt"].numpy(), [1e-3, 2e-3, 4e-3], rtol=1e-12)


def test_state_round_trip_through_interop(tight_steppers):
    js, ts = tight_steppers
    rng = np.random.default_rng(0)
    U = rng.standard_normal((ts.V_real.n_dofs, 3))
    P = rng.standard_normal(ts.Q_real.n_dofs)
    Uj, Pj = js.to_packed_state(jnp.asarray(U), jnp.asarray(P))
    Ut, Pt = interop.packed_state_to_torch(np.asarray(Uj), np.asarray(Pj))
    np.testing.assert_array_equal(ts.from_packed_state(Ut, Pt)[0].numpy(), U)
    Ut2, Pt2 = ts.to_packed_state(U, P)
    Un, Pn = interop.packed_state_to_numpy(Ut2, Pt2)
    np.testing.assert_array_equal(Un, np.asarray(Uj))
    np.testing.assert_array_equal(Pn, P)
