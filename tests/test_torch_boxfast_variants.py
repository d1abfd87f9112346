# BDF2 and Picard (picard_maxiter > 1) variants of the box stepper against
# the JAX package on Cavity3DProblem(n=4), float64 on the CPU; a file of its
# own so that the test workers compile the JAX steppers in parallel with
# tests/test_torch_boxfast.py.
import jax.numpy as jnp
import pytest
import torch

from flow_tpu.models.cavity3d import Cavity3DProblem as JaxCavity
from flow_tpu_torch.models.cavity3d import Cavity3DProblem
from torch_parity import ITERS, assert_state_close, run_both, steppers

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def problems():
    return JaxCavity(n=4, mu=0.01), Cavity3DProblem(n=4, mu=0.01, dtype=torch.float64, device="cpu")


def test_bdf2_run_matches_jax(problems):
    # the stepper's default (benchmark) tolerances: at TIGHT the first
    # correction solve ends a hair from its 1e-11 target and the last
    # iteration's count flips with the summation order
    js, ts = steppers(problems, time_step_method="bdf2")
    run_both(js, ts, 3)


def test_picard_step_matches_jax(problems):
    js, ts = steppers(
        problems, picard_maxiter=3, picard_tol=1e-9, linear_rtol=1e-6,
        pressure_rtol=1e-11, correction_rtol=1e-11,
    )
    Uj, Pj, sj = js.step(*js.zeros(), jnp.asarray(1e-3))
    Ut, Pt, st = ts.step(*ts.zeros(), 1e-3)
    for key in ITERS + ("newton_iters",):
        assert getattr(st, key) == int(getattr(sj, key)), key
    assert st.newton_iters > 1
    assert_state_close(js, ts, Uj, Pj, Ut, Pt)
