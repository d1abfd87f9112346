# The Newton variant of flow_tpu_torch.attic.winmom (K3, 2-D Newton) against
# the JAX package on KarmanProblem(lcar=0.2, n_refine=1) with S=128 (more than one window
# block), float64 states from a numpy seed:
# - state_qp's tables against JAX's blocked_state_q to 1e-6 of each table's
#   largest entry (float32 tables; the gradients sum in another order);
# - the plain Newton apply against the JAX Pallas kernel in interpret mode
#   (momentum_tables_apply with Uq, Gu), and against the torch.func.jvp
#   tangent of the port's volume residual, at the JAX package's own bound
#   (rtol 3e-5, atol 5e-6, tests/test_winmom.py:106-108: the window apply
#   computes in float32, in another summation order).
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from flow_tpu.attic.winmom import WindowLaggedMomentum as JaxMomentum
from flow_tpu.models.karman import KarmanProblem as JaxKarman
from flow_tpu_torch.attic import winmom
from flow_tpu_torch.attic.winmom import WindowLaggedMomentum
from flow_tpu_torch.fem import assembly, forms
from flow_tpu_torch.models.karman import KarmanProblem

torch.set_num_threads(1)

WEIGHTS = (1.0, 0.21, 0.017)  # mass_w, s_rho, s_mu
TOL = dict(rtol=3e-5, atol=5e-6)


@pytest.fixture(scope="module")
def setup():
    jp = JaxKarman(lcar=0.2, n_refine=1)
    tp = KarmanProblem(lcar=0.2, n_refine=1, dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((tp.V.n_dofs, 2))
    v = rng.standard_normal((tp.V.n_dofs, 2))
    op = WindowLaggedMomentum(tp.V, S=128)
    assert op.wl.nb > 1
    return jp, tp, op, x, v


def test_state_tables_match_jax(setup):
    jp, _, op, x, _ = setup
    jop = JaxMomentum(jp.V, S=128, interpret=True)
    got = op.state_qp(torch.as_tensor(x))
    ref = jop.state_qp(jnp.asarray(x))
    assert got[1] is got[0]  # Uq is Tq, as in the JAX package
    for g, r in zip(got, ref):
        # the card's kernel takes contiguous float32 tables only
        assert g.dtype == torch.float32 and g.shape == r.shape and g.is_contiguous()
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-6 * np.abs(r).max())


def test_newton_plain_matches_jax_interpret(setup):
    jp, _, op, x, v = setup
    jop = JaxMomentum(jp.V, S=128, interpret=True)
    jt = jop.state_qp(jnp.asarray(x))
    ref = np.asarray(jop.apply_perm_rows(jnp.asarray(v)[jop.perm], *jt[:1],
                                         *WEIGHTS, *jt[1:]))
    Tq, Uq, Gu = op.state_qp(torch.as_tensor(x))
    vt = torch.as_tensor(v)
    got = op.apply_perm_rows(vt[op.perm], Tq, *WEIGHTS, Uq, Gu)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    # the original-numbering apply is the same operator
    np.testing.assert_array_equal(op.apply(vt, Tq, *WEIGHTS, Uq, Gu).numpy(),
                                  got[op.inv].numpy())


def test_newton_plain_is_the_tangent_of_the_volume_residual(setup):
    _, tp, op, x, v = setup
    V = tp.V
    geom = assembly.geometry_on(V.mesh, torch.float64, "cpu")
    mass_w, s_rho, s_mu = WEIGHTS

    def vol_res(u):
        Uloc = V.gather(u)
        loc = mass_w * forms.mass_loc(V, geom, Uloc)
        loc = loc + s_rho * forms.skew_convection_lagged_loc(V, geom, Uloc, Uloc)
        loc = loc + forms.sym_grad_loc(V, geom, Uloc, s_mu)
        return V.dof_sum(loc)

    xt, vt = torch.as_tensor(x), torch.as_tensor(v)
    _, ref = torch.func.jvp(vol_res, (xt,), (vt,))
    Tq, Uq, Gu = op.state_qp(xt)
    got = op.apply(vt, Tq, *WEIGHTS, Uq, Gu)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)


def test_newton_with_zero_state_is_the_lagged_apply(setup):
    # Gu = 0 and Uq = Tq = 0: the reaction term vanishes
    _, _, op, _, v = setup
    vt = torch.as_tensor(v)
    Tq = op.zero_transport()
    Gu = torch.zeros((op.wl.nb, 4 * op.nq, op.wl.C), dtype=torch.float32)
    lagged = op.apply(vt, Tq, *WEIGHTS)
    np.testing.assert_array_equal(op.apply(vt, Tq, *WEIGHTS, Tq, Gu).numpy(),
                                  lagged.numpy())


def test_cpu_newton_apply_launches_nothing(setup):
    _, _, op, x, v = setup
    before = (winmom.WINMOM.launches, winmom.WINMOM_NEWTON.launches)
    Tq, Uq, Gu = op.state_qp(torch.as_tensor(x))
    op.apply(torch.as_tensor(v), Tq, *WEIGHTS, Uq, Gu)
    assert (winmom.WINMOM.launches, winmom.WINMOM_NEWTON.launches) == before
