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


def _list_sums(vals, rp):
    """Each row's values vals[..., rp[k]:rp[k+1]] summed in list order, from
    0, in float32 (as the kernels sum them)."""
    start, length = rp[:-1], np.diff(rp)
    acc = np.zeros(vals.shape[:-1] + (len(length),), dtype=np.float32)
    for k in range(int(length.max(initial=0))):
        m = length > k
        acc[..., m] += vals[..., start[m] + k]
    return acc


@pytest.mark.parametrize("S", [128, None])
def test_positions_invert_the_scatter_lists_and_sum_to_the_windows(setup, S):
    # the lists the 2-D kernels read on the card, built on the CPU: pos is
    # the inverse of the scatter lists' ent, the compressed rows are exactly
    # the rows some local result lands on, and the plain local results
    # summed along them in list order are the plain windows, lagged and
    # Newton
    from flow_tpu_torch.attic.window import build_scatter_lists
    from flow_tpu_torch.attic.winmom import momentum_local_plain, momentum_windows_plain

    _, tp, x, T = setup
    op = WindowLaggedMomentum(tp.V, S=S)
    wl = op.wl
    nb, NL, C = op.lidx.shape
    W = wl.W
    rowptr, ent = build_scatter_lists(wl)
    rptr, rows, pos = (t.numpy() for t in op.positions)
    assert all(t.dtype == torch.int32 for t in op.positions)
    R = rows.shape[1]
    assert rptr.shape == (nb, R + 1) and pos.shape == (nb, NL * C)
    valid = op.valid.numpy() > 0
    for b in range(nb):
        n = int(rowptr[b, -1])
        p = pos[b].reshape(NL, C)
        e = ent[b, :n]
        np.testing.assert_array_equal(p[e % NL, e // NL], np.arange(n))
        assert (p[:, ~valid[b]] == -1).all() and int((p >= 0).sum()) == n
        nonzero = np.nonzero(np.diff(rowptr[b]))[0]
        k = len(nonzero)
        np.testing.assert_array_equal(rows[b, :k], nonzero)
        assert (rows[b, k:] == W).all()
        np.testing.assert_array_equal(rptr[b, :k], rowptr[b, nonzero])
        assert (rptr[b, k:] == n).all()
    rng = np.random.default_rng(5)
    xp = torch.zeros((2, wl.n_pad), dtype=torch.float32)
    xp[:, :wl.n] = torch.as_tensor(rng.standard_normal((2, wl.n)), dtype=torch.float32)
    Tq, Uq, Gu = op.state_qp(torch.as_tensor(T))
    scal = op._scal(*WEIGHTS)
    U = xp[:, (torch.arange(nb)[:, None, None] * wl.S + op.lidx).long()]
    for extra in ((), (Uq, Gu)):
        loc = momentum_local_plain(U, op.valid, op.detj, op.G4, op.Cg4, Tq, op.tabs, scal,
                                   *extra).numpy()
        got = np.zeros((2, nb, W), dtype=np.float32)
        for b in range(nb):
            staged = np.zeros((2, int(rowptr[b, -1])), dtype=np.float32)
            p = pos[b].reshape(NL, C)
            staged[:, p[p >= 0]] = loc[:, b][:, p >= 0]
            k = int((rows[b] < W).sum())
            got[:, b, rows[b, :k]] = _list_sums(staged, rptr[b, :k + 1])
        ref = momentum_windows_plain(xp, op.lidx, op.valid, op.detj, op.G4, op.Cg4, Tq,
                                     op.tabs, scal, wl.S, wl.W, *extra).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())


def test_momentum_plan_stages_a_karman_window_block_in_one_pass():
    # K3 2-D at the Karman 1.9M velocity layout (nb = 552, C = 771): two
    # floats a position, one pass, a one-wave grid on 132 SMs in which no
    # cluster takes a round of fewer than a warp's worth of cells per block
    from flow_tpu_torch.attic import winkernel

    nb, C, NL = 552, 771, 6
    cl, threads, cap = winkernel.momentum_plan(nb, C, NL, 132, nc=2)
    assert winkernel.MOMENTUM_CLUSTER <= cl <= winkernel.MAX_CLUSTER
    assert cl * cap >= C * NL and 8 * cap <= winkernel.MOMENTUM_LOC_BYTES
    assert threads == winkernel.MOMENTUM_THREADS
    cells = -(-C // cl)  # a block's, in rounds of `threads`
    assert (cells - 1) % threads + 1 >= 32
