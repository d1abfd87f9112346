# FastStepper's assembled-ELL momentum operators, forward Euler and the
# divergence probe against the JAX package in float64 on the CPU:
# - fem/ell.ELLGraph (its sparsity, the device assembly by member-table
#   gathers, the class-split apply and the block diagonal),
#   momentum_const_ell, momentum_bnd_stress_ell_vals and FacetMassELL, and
#   forms.conv_jacobian_loc / convection_rhs / skew_convection_rhs, against
#   JAX's on KarmanProblem(lcar=0.2) from the same numpy inputs, to 1e-12
#   relative;
# - the assembled Newton Jacobian (assembled_jacobian=True) against the
#   JAX one, and the exact lagged ELL operator (lagged_ell=True, JAX's
#   FLOW_LAGGED_ELL=1) against jax.linearize of the lagged residual on the
#   open outflow (tests/test_fast.py:381), to 1e-12;
# - the stepper on KarmanProblem(lcar=0.2, n_refine=2), 3 steps with the CFL
#   controller from dt0 = 1e-3, the JAX P1Hierarchy's lambda_max carried
#   across: the assembled Newton Jacobian, the lagged ELL operator, and
#   forward Euler with the divergence probe: equal per-step counts, U, P and
#   div_norm within 1e-8.
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flow_tpu.fem import forms as jforms
from flow_tpu.models import karman as jax_karman
from flow_tpu.navier_stokes.fast import FastStepper as JaxStepper
from flow_tpu.solvers.multigrid import P1Hierarchy as JaxHierarchy
from flow_tpu_torch import interop
from flow_tpu_torch.fem import forms
from flow_tpu_torch.models import karman
from flow_tpu_torch.navier_stokes.fast import FastStepper
from flow_tpu_torch.solvers.multigrid import P1Hierarchy

torch.set_num_threads(1)

ITERS = ("newton_iters", "linear_iters", "pressure_iters", "correction_iters")
TOL = 1e-8
DRIVER = dict(rotational_form=True, newton_tol=0.0, newton_rtol=1e-3, newton_maxiter=3,
              linear_rtol=1e-4, pressure_rtol=1e-4, correction_rtol=1e-5)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.fixture(scope="module")
def coarse():
    jp = jax_karman.KarmanProblem(lcar=0.2)
    tp = karman.KarmanProblem(lcar=0.2, dtype=torch.float64, device="cpu")
    mp = pytest.MonkeyPatch()
    mp.setenv("FLOW_LAGGED_ELL", "1")
    try:
        js = JaxStepper(jp.V, jp.Q, jp.u_bcs, jp.p_bcs, jp.rho, jp.mu, convection="lagged",
                        assembled_jacobian=True)
    finally:
        mp.undo()
    ts = FastStepper(tp.V, tp.Q, tp.u_bcs, tp.p_bcs, tp.rho, tp.mu, convection="lagged",
                     assembled_jacobian=True, lagged_ell=True, device="cpu")
    assert js._lagmom_graph is not None and ts._lagmom_graph is ts._mom_graph
    rng = np.random.default_rng(9)
    n = tp.V.n_dofs
    data = dict(x=rng.standard_normal((n, 2)), v=rng.standard_normal((n, 2)),
                U=rng.standard_normal((n, 2)), P=rng.standard_normal(tp.Q.n_dofs))
    return jp, tp, js, ts, data


def test_ell_graph_sparsity_equals_jax(coarse):
    _, _, js, ts, _ = coarse
    jg, tg = js._mom_graph, ts._mom_graph
    np.testing.assert_array_equal(tg.cols_np, np.asarray(jg.cols_np))
    np.testing.assert_array_equal(tg.dest_np, jg.dest_np)
    assert (tg.n_vert, tg.w_edge, tg.width) == (jg.n_vert, jg.w_edge, jg.width)


@pytest.mark.parametrize("block", [False, True], ids=["scalar", "block"])
@pytest.mark.parametrize("op", ["assemble", "apply", "diag"])
def test_ell_graph_ops_match_jax(coarse, op, block):
    _, tp, js, ts, d = coarse
    jg, tg = js._mom_graph, ts._mom_graph
    rng = np.random.default_rng(10)
    shape = (tp.mesh.n_cells, jg.n_local, jg.n_local) + ((2, 2) if block else ())
    loc = rng.standard_normal(shape)
    jv, tv = jg.assemble(jnp.asarray(loc)), tg.assemble(torch.as_tensor(loc))
    if op == "assemble":
        want, got = jv, tv
        np.testing.assert_allclose(tg.assemble_np(loc), np.asarray(jv), rtol=0, atol=1e-13)
    elif op == "apply":
        want, got = jg.apply(jv, jnp.asarray(d["v"])), tg.apply(tv, torch.as_tensor(d["v"]))
    else:
        want, got = jg.diag(jv), tg.diag(tv)
    assert _rel(got, want) <= 1e-12


def test_momentum_constant_blocks_match_jax(coarse):
    jp, tp, js, ts, _ = coarse
    for name in ("mass", "visc1", "visc2"):
        assert _rel(getattr(ts, f"_mom_{name}"), getattr(js, f"_mom_{name}")) <= 1e-12, name
        assert _rel(getattr(ts, f"_lagmom_{name}"), getattr(js, f"_lagmom_{name}")) <= 1e-12
    assert _rel(ts._lagmom_dvisc2, js._lagmom_dvisc2) <= 1e-12
    s = np.random.default_rng(11).standard_normal(tuple(ts.ctx.btab.wl.shape))
    want = js._lagmom_fm.assemble(jnp.asarray(s))
    assert _rel(ts._lagmom_fm.assemble(torch.as_tensor(s)), want) <= 1e-12


@pytest.mark.parametrize("form", ["conv_jacobian_loc", "convection_rhs", "skew_convection_rhs"])
def test_convection_forms_match_jax(coarse, form):
    jp, tp, js, ts, d = coarse
    x, v = d["x"], d["v"]
    if form == "conv_jacobian_loc":
        want = jforms.conv_jacobian_loc(jp.V, js.ctx.geom, jp.V.gather(jnp.asarray(x)))
        got = forms.conv_jacobian_loc(tp.V, ts.ctx.geom, tp.V.gather(torch.as_tensor(x)))
    else:
        want = getattr(jforms, form)(jp.V, js.ctx.geom, jnp.asarray(x), jnp.asarray(v))
        got = getattr(forms, form)(tp.V, ts.ctx.geom, torch.as_tensor(x), torch.as_tensor(v))
    assert _rel(got, want) <= 1e-12


def test_assembled_newton_jacobian_matches_jax(coarse):
    jp, tp, js, ts, d = coarse
    dt = 2.5e-2
    x, v = d["x"], d["v"]
    g = js._mom_graph
    conv_el = jforms.conv_jacobian_loc(jp.V, js.ctx.geom, jp.V.gather(jnp.asarray(x)))
    s = dt / js.rho
    vals = (s * js.rho) * g.assemble(conv_el) + (s * js.mu) * js._mom_visc2
    sc = js._mom_mass + (s * js.mu) * js._mom_visc1
    vals = vals + sc[:, :, None, None] * jnp.eye(2)
    want = (1.0 - js.mask_u) * g.apply(vals, jnp.asarray(v)) + js.mask_u * jnp.asarray(v)
    got = ts._assembled_Jv(torch.as_tensor(x), ts._scalar(dt))(torch.as_tensor(v))
    assert _rel(got, want) <= 1e-12


def test_lagged_ell_operator_matches_jax_linearize(coarse):
    jp, tp, js, ts, d = coarse
    dt = 2.0e-2
    x0, v, U, P = (d[k] for k in ("x", "v", "U", "P"))
    free = 1.0 - js.mask_u

    def res_lag(x):
        r = js.ctx._residual(x, jnp.asarray(U), None, None, jnp.asarray(P), js.rho, js.mu,
                             jnp.asarray(dt), js.theta, transport=jnp.asarray(x0))
        return free * r + js.mask_u * (x - js.val_u)

    # jitted: eager jax.linearize takes ~9 s here
    Jv = jax.jit(lambda w: jax.linearize(res_lag, jnp.asarray(x0))[1](w))
    got, dex = ts._lagged_ell_Jv(torch.as_tensor(x0), ts._scalar(dt))
    assert _rel(got(torch.as_tensor(v)), Jv(jnp.asarray(v))) <= 1e-12
    assert bool((dex > 0).all())


@pytest.fixture(scope="module")
def karman_problems():
    return (jax_karman.KarmanProblem(lcar=0.2, n_refine=2),
            karman.KarmanProblem(lcar=0.2, n_refine=2, dtype=torch.float64, device="cpu"))


CASES = {
    "assembled-newton": (dict(DRIVER, assembled_jacobian=True), {}),
    "lagged-ell": (dict(DRIVER, convection="lagged"), dict(lagged_ell=True)),
    "forward-euler-divergence": (
        dict(DRIVER, time_step_method="forward euler", divergence_probe=True), {}),
}


@pytest.fixture(scope="module")
def jax_runs(karman_problems):
    """Each case's JAX stepper (FLOW_LAGGED_ELL=1 while the lagged-ELL one
    is built) on one P1Hierarchy, its 3-step run from dt0 = 1e-3 ->
    ({case: (stepper, output)}, the hierarchy's lambda_max). The programs
    are traced in turn and compiled at once (XLA compiles outside the
    GIL)."""
    jp, _ = karman_problems
    args = (jp.V.zeros(), jp.Q.zeros(), jnp.asarray(1e-3))
    jh, steppers, lowered = None, {}, []
    for case, (kw, port_kw) in CASES.items():
        mp = pytest.MonkeyPatch()
        if port_kw.get("lagged_ell"):
            mp.setenv("FLOW_LAGGED_ELL", "1")
        try:
            js = JaxStepper(jp.V, jp.Q, jp.u_bcs, jp.p_bcs, jp.rho, jp.mu, **kw)
        finally:
            mp.undo()
        if jh is None:
            jh = JaxHierarchy(jp.mesh_hierarchy, bc_mask=js.mask_p, smoother_degree=3)
        js.pressure_precond = jh.v_cycle
        steppers[case] = js
        lowered.append(js._run_jit.lower(*args, n_steps=3))
    with ThreadPoolExecutor(len(lowered)) as pool:
        compiled = list(pool.map(lambda low: low.compile(), lowered))
    out = {case: (steppers[case], run(*args)) for case, run in zip(CASES, compiled)}
    return out, [float(L.lmax) for L in jh.levels]


@pytest.mark.parametrize("case", list(CASES))
def test_stepper_iterate_exact_with_jax(karman_problems, jax_runs, case):
    _, tp = karman_problems
    kw, port_kw = CASES[case]
    (js, outj), lmax = jax_runs[0][case], jax_runs[1]
    ts = FastStepper(tp.V, tp.Q, tp.u_bcs, tp.p_bcs, tp.rho, tp.mu, device="cpu", **kw,
                     **port_kw)
    assert not ts.packed and not js.packed
    assert (ts._mom_graph is None) == (js._mom_graph is None)
    assert (ts._lagmom_graph is None) == (js._lagmom_graph is None)
    th = P1Hierarchy(tp.mesh_hierarchy, bc_mask=ts.mask_p, smoother_degree=3)
    interop.load_hierarchy_lmax(th, lmax)
    ts.pressure_precond = th.v_cycle
    outt = ts.run(*ts.zeros(), 1e-3, n_steps=3)
    for key in ITERS:
        assert outt[3][key].tolist() == np.asarray(outj[3][key]).tolist(), key
    np.testing.assert_allclose(outt[3]["dt"].numpy(), np.asarray(outj[3]["dt"]), rtol=1e-12)
    np.testing.assert_allclose(outt[0].numpy(), np.asarray(outj[0]), rtol=0, atol=TOL)
    np.testing.assert_allclose(outt[1].numpy(), np.asarray(outj[1]), rtol=0, atol=TOL)
    if kw.get("divergence_probe"):
        dn = outt[3]["div_norm"].numpy()
        assert dn.shape == (3,) and np.isfinite(dn).all() and (dn >= 0).all()
        np.testing.assert_allclose(dn, np.asarray(outj[3]["div_norm"]), rtol=0, atol=TOL)
    assert np.abs(outt[0].numpy()).max() > 1e-3
