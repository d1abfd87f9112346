# flow_tpu_torch.solvers.multigrid.P1Hierarchy against the JAX package's
# P1Hierarchy on the Karman refine_uniform chain (lcar=0.2, 3 levels), with
# the JAX lambda_max estimates carried across (interop.load_hierarchy_lmax).
# ELL levels in float64: 1e-12. Window levels (winkernel_min_dofs=1, the
# window stiffness kernel's plain version against the JAX Pallas kernel in
# interpret mode): both compute the level operator in float32, so the
# tolerance is the one tests/test_winkernel.py holds the window V-cycle to
# (5e-5 relative to the largest entry).
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from flow_tpu.models.karman import KarmanProblem as JaxKarman
from flow_tpu.solvers.multigrid import P1Hierarchy as JaxHierarchy
from flow_tpu_torch import interop
from flow_tpu_torch.fem.bc import combine_bcs
from flow_tpu_torch.models.karman import KarmanProblem
from flow_tpu_torch.solvers.multigrid import P1Hierarchy

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def problems():
    return (JaxKarman(lcar=0.2, n_refine=2),
            KarmanProblem(lcar=0.2, n_refine=2, dtype=torch.float64, device="cpu"))


def _pair(problems, dirichlet, winkernel):
    jp, tp = problems
    mask = combine_bcs(tp.Q, tp.p_bcs)[0] if dirichlet else None
    jh = JaxHierarchy(jp.mesh_hierarchy, bc_mask=None if mask is None else jnp.asarray(mask),
                      smoother_degree=3, winkernel=winkernel, winkernel_min_dofs=1)
    th = P1Hierarchy(tp.mesh_hierarchy, bc_mask=mask, smoother_degree=3,
                     winkernel=winkernel, winkernel_min_dofs=1)
    assert all((L.win is not None) == winkernel for L in th.levels)
    interop.load_hierarchy_lmax(th, [float(L.lmax) for L in jh.levels])
    return jh, th


@pytest.mark.parametrize("dirichlet", [False, True], ids=["neumann", "dirichlet"])
@pytest.mark.parametrize("winkernel", [False, True], ids=["ell", "window"])
def test_v_cycle_matches_jax(problems, dirichlet, winkernel):
    jh, th = _pair(problems, dirichlet, winkernel)
    r = np.random.default_rng(11).standard_normal(th.levels[-1].n)
    y = th.v_cycle(torch.as_tensor(r)).numpy()
    y_ref = np.asarray(jh.v_cycle(jnp.asarray(r)))
    tol = 5e-5 if winkernel else 1e-12
    np.testing.assert_allclose(y, y_ref, rtol=tol, atol=tol * np.abs(y_ref).max())
    # transfers: prolong and its transpose
    xc = np.random.default_rng(12).standard_normal(th.levels[-2].n)
    np.testing.assert_allclose(th.prolong(1, torch.as_tensor(xc)).numpy(),
                               np.asarray(jh.prolong(1, jnp.asarray(xc))), rtol=1e-15)
    np.testing.assert_allclose(th.restrict(1, torch.as_tensor(r)).numpy(),
                               np.asarray(jh.restrict(1, jnp.asarray(r))), rtol=1e-14,
                               atol=1e-14)


def test_power_iteration_close_to_jax(problems):
    # different random starts: the estimates agree to a few percent only
    # (ROADMAP queue 3, lambda_max drift); the carried values are exact
    jp, tp = problems
    jh = JaxHierarchy(jp.mesh_hierarchy, smoother_degree=3)
    th = P1Hierarchy(tp.mesh_hierarchy, smoother_degree=3)
    for jl, tl in zip(jh.levels, th.levels):
        assert tl.lmax == pytest.approx(jl.lmax, rel=5e-2)
    with pytest.raises(ValueError):
        interop.load_hierarchy_lmax(th, [1.0])


def test_fine_window_reuses_the_pressure_operator(problems):
    # the stepper's pressure operator as the finest window level: the same
    # layout as the one the hierarchy would build, so the V-cycle is equal
    from flow_tpu_torch.attic.winkernel import WindowStiffnessOperator
    from flow_tpu_torch.fem.spaces import FunctionSpace

    _, tp = problems
    mask = combine_bcs(tp.Q, tp.p_bcs)[0]
    own = P1Hierarchy(tp.mesh_hierarchy, bc_mask=mask, smoother_degree=3,
                      winkernel=True, winkernel_min_dofs=1)
    op = WindowStiffnessOperator(tp.Q, device="cpu")
    shared = P1Hierarchy(tp.mesh_hierarchy, bc_mask=mask, smoother_degree=3,
                         winkernel=True, winkernel_min_dofs=1, fine_window=op)
    assert shared.levels[-1].win is op
    interop.load_hierarchy_lmax(shared, [L.lmax for L in own.levels])
    r = torch.as_tensor(np.random.default_rng(13).standard_normal(tp.Q.n_dofs))
    assert torch.equal(shared.v_cycle(r), own.v_cycle(r))
    coarse = WindowStiffnessOperator(FunctionSpace(tp.mesh_hierarchy[0], 1), device="cpu")
    with pytest.raises(ValueError, match="fine_window"):
        P1Hierarchy(tp.mesh_hierarchy, bc_mask=mask, winkernel=True,
                    winkernel_min_dofs=1, fine_window=coarse)
