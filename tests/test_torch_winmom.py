# flow_tpu_torch.attic.winmom against the JAX package: the plain version of
# the window momentum kernel (K3, 2-D lagged) must match the JAX Pallas
# kernel run in interpret mode, and the einsum momentum forms, at the JAX
# package's own tolerance (rtol 3e-5, atol 5e-6: the window apply computes
# in float32, in another summation order).
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from flow_tpu.attic.winmom import WindowLaggedMomentum as JaxMomentum
from flow_tpu.models.karman import KarmanProblem as JaxKarman
from flow_tpu_torch.attic.winmom import WindowLaggedMomentum, smem_tables
from flow_tpu_torch.fem import assembly, forms
from flow_tpu_torch.models.karman import KarmanProblem

torch.set_num_threads(1)

WEIGHTS = (1.0, 0.37, 0.021)  # mass_w, s_rho, s_mu of tests/test_winmom.py


@pytest.fixture(scope="module")
def setup():
    jp = JaxKarman(lcar=0.1, n_refine=1)
    tp = KarmanProblem(lcar=0.1, n_refine=1, dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((tp.V.n_dofs, 2))
    T = rng.standard_normal((tp.V.n_dofs, 2))
    return jp, tp, x, T


def _einsum_apply(V, x, T, mass_w, s_rho, s_mu):
    geom = assembly.geometry_on(V.mesh, x.dtype, x.device)
    Uloc, Tloc = V.gather(x), V.gather(T)
    loc = mass_w * forms.mass_loc(V, geom, Uloc)
    loc = loc + s_rho * forms.skew_convection_lagged_loc(V, geom, Tloc, Uloc)
    loc = loc + forms.sym_grad_loc(V, geom, Uloc, s_mu)
    return V.dof_sum(loc)


def test_window_momentum_plain_matches_jax_interpret(setup):
    jp, tp, x, T = setup
    jop = JaxMomentum(jp.V, S=128, interpret=True)
    op = WindowLaggedMomentum(tp.V, S=128)
    assert (op.wl.nb, op.wl.C, op.nq) == (jop.wl.nb, jop.wl.C, jop.nq)
    Tq = op.transport_qp(torch.as_tensor(T))
    jTq = jop.transport_qp(jnp.asarray(T))
    np.testing.assert_allclose(Tq.numpy(), np.asarray(jTq), rtol=1e-6, atol=1e-6)
    got = op.apply(torch.as_tensor(x), Tq, *WEIGHTS).numpy()
    ref = np.asarray(jop.apply(jnp.asarray(x), jTq, *WEIGHTS))
    np.testing.assert_allclose(got, ref, rtol=3e-5, atol=5e-6)


def test_window_momentum_matches_einsum_forms(setup):
    _, tp, x, T = setup
    op = WindowLaggedMomentum(tp.V, S=128)
    xt, Tt = torch.as_tensor(x), torch.as_tensor(T)
    ref = _einsum_apply(tp.V, xt, Tt, *WEIGHTS).numpy()
    got = op.apply(xt, op.transport_qp(Tt), *WEIGHTS)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), ref, rtol=3e-5, atol=5e-6)
    # the permuted-row path is the same operator; tensor weights (as the
    # stepper passes them) give the same result
    yp = op.apply_perm_rows(xt[op.perm], op.transport_qp(Tt),
                            *(torch.tensor(w, dtype=torch.float64) for w in WEIGHTS))
    np.testing.assert_array_equal(yp[op.inv].numpy(), got.numpy())


def test_window_mass_with_zero_weights(setup):
    # the velocity correction's operator: mass only, any transport
    _, tp, x, _ = setup
    op = WindowLaggedMomentum(tp.V, S=None)
    xt = torch.as_tensor(x)
    got = op.apply(xt, op.zero_transport(), 1.0, 0.0, 0.0).numpy()
    geom = assembly.geometry_on(tp.mesh, torch.float64, "cpu")
    ref = tp.V.dof_sum(forms.mass_loc(tp.V, geom, tp.V.gather(xt))).numpy()
    np.testing.assert_allclose(got, ref, rtol=3e-5, atol=1e-7)


def test_small_tables_match_jax_layout(setup):
    from flow_tpu.attic.winmom import smem_tables as jax_smem_tables
    from flow_tpu.fem import assembly as jax_assembly

    jp, tp, _, _ = setup
    jtab = jax_assembly.tabulation(jp.V, jax_assembly.CONV_RULE)
    ref = np.concatenate([np.asarray(t, np.float32).ravel()
                          for t in jax_smem_tables(jtab, 2, 2)])
    tab = assembly.tabulation(tp.V, assembly.CONV_RULE)
    assert tab.nq == 7  # CONV_RULE = 5: the 7-point rule the kernel is built for
    np.testing.assert_array_equal(smem_tables(tab, 2, 2).astype(np.float32), ref)
