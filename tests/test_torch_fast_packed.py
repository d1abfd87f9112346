# FastStepper's lane-packed layout (fem/packed.py, packed=True/"auto")
# against the JAX package in float64 on the CPU:
# - every PackedContext method against the JAX PackedContext's on the DFG
#   2D-2 channel (open outflow, so the do-nothing terms act) from the same
#   numpy inputs, to 1e-12 relative (a JAX list loc[a][i] of [nc] vectors
#   is the port's [2, nl, nc] tensor), and the packed operators against the
#   port's own einsum layout (NSContext, forms, assembly);
# - the packed Newton tangent against the einsum route's (itself held
#   against jax.linearize in test_torch_fast_einsum.py), and the packed EMA
#   lagged tangent against the dense one (tests/test_ema.py:151);
# - the stepper on KarmanProblem(lcar=0.2, n_refine=2), 3 steps with the CFL
#   controller from dt0 = 1e-3 and the JAX P1Hierarchy's lambda_max carried
#   across: the bench configuration (lagged, GMRES(32), BDF2) and Newton
#   with the vertex preconditioner, in the packed and the spaces' layout,
#   against the JAX einsum stepper (the JAX packed stepper
#   repeats its counts, and its states to ~5e-11, but its unrolled program
#   compiles in ~30 s): equal per-step counts, U and P within 1e-8;
# - run_karman_fast taking the packed layout from PACKED_MIN_DOFS (lowered
#   here) with global-layout results and checkpoints, equal to the
#   unpacked driver;
# - ema_bf16 and a bfloat16 GMRES basis, one step in both layouts against
#   the JAX einsum stepper under FLOW_EMA_PREC=bf16 / FLOW_GMRES_BASIS=bf16:
#   equal counts, U and P within 1e-8, and away from the float64 step.
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flow_tpu.fem.packed import PackedContext as JaxPacked
from flow_tpu.models import karman as jax_karman
from flow_tpu.navier_stokes.fast import FastStepper as JaxStepper
from flow_tpu.navier_stokes.pressure_correction import _get_ctx
from flow_tpu.solvers.multigrid import P1Hierarchy as JaxHierarchy
from flow_tpu_torch import interop
from flow_tpu_torch.fem import assembly, forms
from flow_tpu_torch.io import load_checkpoint
from flow_tpu_torch.models import karman
from flow_tpu_torch.navier_stokes import fast as fast_mod
from flow_tpu_torch.navier_stokes.fast import FastStepper
from flow_tpu_torch.solvers.multigrid import P1Hierarchy

torch.set_num_threads(1)

ITERS = ("newton_iters", "linear_iters", "pressure_iters", "correction_iters")
TOL = 1e-8
DRIVER = dict(rotational_form=True, newton_tol=0.0, newton_rtol=1e-3, newton_maxiter=3,
              linear_rtol=1e-4, pressure_rtol=1e-4, correction_rtol=1e-5)
BENCH = dict(rotational_form=True, convection="lagged", momentum_solver="gmres",
             newton_tol=0.0, newton_rtol=1e-2, newton_maxiter=4, linear_rtol=1e-1,
             pressure_rtol=3e-4, pressure_maxiter=600, correction_rtol=1e-4)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.fixture(scope="module")
def channel():
    jp = jax_karman.schafer_turek_problem(lcar=0.1, n_refine=0)
    tp = karman.schafer_turek_problem(lcar=0.1, n_refine=0, dtype=torch.float64,
                                      device="cpu")
    jst = _get_ctx(jp.V, jp.Q)  # the JAX context's boundary tables
    tst = FastStepper(tp.V, tp.Q, tp.u_bcs, tp.p_bcs, tp.rho, tp.mu, packed=True,
                      convection="lagged", device="cpu")
    assert tst.packed
    rng = np.random.default_rng(11)
    n, nq = tp.V.n_dofs, tp.Q.n_dofs
    data = dict(U=rng.standard_normal(2 * n), U0=rng.standard_normal(2 * n),
                T=rng.standard_normal(2 * n), P=rng.standard_normal(nq))
    return JaxPacked(jp.V, jp.Q), tst.pctx, jst, tst, tp, data


def _lists(pc, Uf):
    """JAX packed locals of a flat state: [[gatherV(U_a)]]."""
    a, b = pc.comps(Uf)
    return [pc.gatherV(a), pc.gatherV(b)]


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.as_tensor(x)


METHODS = {
    "pack-unpack": lambda jc, tc, d: (
        jc.unpack(jc.pack(_j(d["U"].reshape(2, -1).T))),
        tc.unpack(tc.pack(_t(d["U"].reshape(2, -1).T.copy())))),
    "gatherV-dof_sum_V2": lambda jc, tc, d: (
        jc.dof_sum_V2(_lists(jc, _j(d["U"]))), tc.dof_sum_V2(tc.gatherV(tc.comps(_t(d["U"]))))),
    "mass_loc_acc": lambda jc, tc, d: (
        jc.mass_loc_acc(jc._zero_loc(_j(d["U"])), _lists(jc, _j(d["U"])), 0.7),
        tc.mass_loc_acc(tc._zero_loc(_t(d["U"])), tc.gatherV(tc.comps(_t(d["U"]))), 0.7)),
    "sym_grad_loc_acc": lambda jc, tc, d: (
        jc.sym_grad_loc_acc(jc._zero_loc(_j(d["U"])), _lists(jc, _j(d["U"])), 0.3),
        tc.sym_grad_loc_acc(tc._zero_loc(_t(d["U"])), tc.gatherV(tc.comps(_t(d["U"]))), 0.3)),
    "pressure_grad_loc_acc": lambda jc, tc, d: (
        jc.pressure_grad_loc_acc(jc._zero_loc(_j(d["U"])), jc.gatherQ(_j(d["P"])), -0.2),
        tc.pressure_grad_loc_acc(tc._zero_loc(_t(d["U"])), tc.gatherQ(_t(d["P"])), -0.2)),
    "skew_conv_loc_acc": lambda jc, tc, d: (
        jc.skew_conv_loc_acc(jc._zero_loc(_j(d["U"])), _lists(jc, _j(d["U"])), 1.3),
        tc.skew_conv_loc_acc(tc._zero_loc(_t(d["U"])), tc.gatherV(tc.comps(_t(d["U"]))), 1.3)),
    "skew_conv_lagged_loc_acc": lambda jc, tc, d: (
        jc.skew_conv_lagged_loc_acc(jc._zero_loc(_j(d["U"])), _lists(jc, _j(d["T"])),
                                    _lists(jc, _j(d["U"])), 1.3),
        tc.skew_conv_lagged_loc_acc(tc._zero_loc(_t(d["U"])), tc.gatherV(tc.comps(_t(d["T"]))),
                                    tc.gatherV(tc.comps(_t(d["U"]))), 1.3)),
    "residual_volume": lambda jc, tc, d: (
        jc.residual_volume(_j(d["U"]), _j(d["U0"]), _j(d["P"]), 1.0, 1e-3, 0.02, 1.0),
        tc.residual_volume(_t(d["U"]), _t(d["U0"]), _t(d["P"]), 1.0, 1e-3, 0.02, 1.0)),
    "residual_volume-lagged": lambda jc, tc, d: (
        jc.residual_volume(_j(d["U"]), _j(d["U0"]), _j(d["P"]), 1.0, 1e-3, 0.02, 0.5,
                           Tf=_j(d["T"])),
        tc.residual_volume(_t(d["U"]), _t(d["U0"]), _t(d["P"]), 1.0, 1e-3, 0.02, 0.5,
                           Tf=_t(d["T"]))),
    "lagged_scalar_tensor": lambda jc, tc, d: (
        jc.lagged_scalar_tensor(_lists(jc, _j(d["T"])), 1.0, 0.01, 0.03,
                                jc.stiffness_scalar_pairs()),
        tc.lagged_scalar_tensor(tc.gatherV(tc.comps(_t(d["T"]))), 1.0, 0.01, 0.03,
                                tc.stiffness_scalar_pairs())),
    "ema_scalar_apply": lambda jc, tc, d: (
        jc.ema_scalar_apply(jc._zero_loc(_j(d["U"])), jc.lagged_scalar_tensor(
            _lists(jc, _j(d["T"])), 1.0, 0.01, 0.03, jc.stiffness_scalar_pairs()),
            _lists(jc, _j(d["U"]))),
        tc.ema_scalar_apply(tc._zero_loc(_t(d["U"])), tc.lagged_scalar_tensor(
            tc.gatherV(tc.comps(_t(d["T"]))), 1.0, 0.01, 0.03, tc.stiffness_scalar_pairs()),
            tc.gatherV(tc.comps(_t(d["U"]))))),
    "sym_grad_transpose_loc_acc": lambda jc, tc, d: (
        jc.sym_grad_transpose_loc_acc(jc._zero_loc(_j(d["U"])), _lists(jc, _j(d["U"])), 0.4),
        tc.sym_grad_transpose_loc_acc(tc._zero_loc(_t(d["U"])),
                                      tc.gatherV(tc.comps(_t(d["U"]))), 0.4)),
    "div_rhs": lambda jc, tc, d: (jc.div_rhs(_j(d["U"])), tc.div_rhs(_t(d["U"]))),
    "grad_div_cell": lambda jc, tc, d: (jc.grad_div_cell(_j(d["U"])),
                                        tc.grad_div_cell(_t(d["U"]))),
    "grad_div_rhs": lambda jc, tc, d: (jc.grad_div_rhs(_j(d["U"])),
                                       tc.grad_div_rhs(_t(d["U"]))),
    "mass_apply": lambda jc, tc, d: (jc.mass_apply(_j(d["U"])), tc.mass_apply(_t(d["U"]))),
    "grad_phi_rhs": lambda jc, tc, d: (
        jc.grad_phi_rhs(_j(d["P"]), div_part=list(jc.grad_div_cell(_j(d["U"])))),
        tc.grad_phi_rhs(_t(d["P"]), div_part=tc.grad_div_cell(_t(d["U"])))),
}


@pytest.mark.parametrize("method", list(METHODS))
def test_packed_context_matches_jax(channel, method):
    jc, tc, *_, d = channel
    want, got = METHODS[method](jc, tc, d)
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    assert _rel(got, want) <= 1e-12


@pytest.mark.parametrize("lagged", [False, True])
def test_packed_boundary_rhs_matches_jax(channel, lagged):
    jc, tc, jst, tst, tp, d = channel
    T = dict(Tf=_j(d["T"])) if lagged else {}
    want = jc.boundary_rhs(jst.btab, jst.btabQ, _j(d["U"]), _j(d["P"]), 1.0, 1e-3,
                           **T)
    T = dict(Tf=_t(d["T"])) if lagged else {}
    got = tc.boundary_rhs(tst.ctx.btab, tst.ctx.btabQ, _t(d["U"]), _t(d["P"]), 1.0, 1e-3,
                          **T)
    assert _rel(got, want) <= 1e-12


def test_packed_operators_match_einsum_layout(channel):
    """The packed residual, pressure and correction pieces against the
    port's einsum layout (NSContext, forms, assembly)."""
    _, tc, _, tst, tp, d = channel
    ctx, V, Q = tst.ctx, tp.V, tp.Q
    U, U0, T, P = (_t(d[k]) for k in ("U", "U0", "T", "P"))
    Ud, U0d, Td = tc.unpack(U), tc.unpack(U0), tc.unpack(T)
    for Tf, Tdn in ((None, None), (T, Td)):
        r = ctx.residual(Ud, U0d, P, 1.0, 1e-3, 0.02, (0.0, 1.0), transport=Tdn)
        got = tc.residual_volume(U, U0, P, 1.0, 1e-3, 0.02, 1.0, Tf=Tf) - 0.02 * tc.boundary_rhs(
            ctx.btab, ctx.btabQ, U, P, 1.0, 1e-3, Tf=Tf)
        assert _rel(got, tc.pack(r)) <= 1e-12
    geom = ctx.geom
    assert _rel(tc.div_rhs(U), forms.div_rhs(V, Q, geom, Ud)) <= 1e-12
    assert _rel(tc.grad_div_rhs(U), forms.grad_div_ustar_rhs(V, Q, geom, Ud)) <= 1e-12
    assert _rel(tc.mass_apply(U), tc.pack(assembly.mass_apply(V, geom, Ud))) <= 1e-12
    gd = forms.grad_div_ustar(V, geom, Ud)
    want = forms.grad_phi_rhs(V, Q, geom, P, div_part=gd, rule_degree=4)
    assert _rel(tc.grad_phi_rhs(P, div_part=tc.grad_div_cell(U)), tc.pack(want)) <= 1e-12


def test_packed_tangents_match_dense(channel):
    _, tc, _, tst, tp, d = channel
    kw = dict(rotational_form=True, device="cpu")
    dense = FastStepper(tp.V, tp.Q, tp.u_bcs, tp.p_bcs, tp.rho, tp.mu, packed=False,
                        convection="lagged", **kw)
    newton_pk = FastStepper(tp.V, tp.Q, tp.u_bcs, tp.p_bcs, tp.rho, tp.mu, packed=True, **kw)
    newton_d = FastStepper(tp.V, tp.Q, tp.u_bcs, tp.p_bcs, tp.rho, tp.mu, packed=False, **kw)
    x, v = _t(d["T"]), _t(d["U"])
    dt = tst._scalar(0.02)
    want = dense._ema_Jv(dense._ema_S(tc.unpack(x), dt), tc.unpack(x), dt)(tc.unpack(v))
    got = tst._ema_Jv_pk(tst._ema_S_pk(x, dt), x, dt)(v)
    assert _rel(got, tc.pack(want)) <= 1e-12
    assert _rel(tst._lagged_Jv_pk(x, dt)(v), tc.pack(want)) <= 1e-12
    for mode in ("linearize", "jvp"):
        newton_pk.tangent_mode = newton_d.tangent_mode = mode
        want = newton_d._newton_Jv(tc.unpack(x), dt)(tc.unpack(v))
        assert _rel(newton_pk._newton_Jv_pk(x, dt)(v), tc.pack(want)) <= 1e-12


@pytest.fixture(scope="module")
def karman_problems():
    return (jax_karman.KarmanProblem(lcar=0.2, n_refine=2),
            karman.KarmanProblem(lcar=0.2, n_refine=2, dtype=torch.float64, device="cpu"))


CASES = {
    "bench-lagged-gmres-bdf2": dict(BENCH, time_step_method="bdf2"),
    "newton-vertex-be": dict(DRIVER, momentum_precond="vertex"),
}
EMA = dict(convection="lagged", newton_tol=1e-12)
# option: (settings, the port's option, dt, the JAX package's knob)
REDUCED = {"ema_bf16": (EMA, dict(ema_bf16=True), 1e-2, "FLOW_EMA_PREC"),
           "gmres_basis": (BENCH, dict(gmres_basis=torch.bfloat16), 1e-3, "FLOW_GMRES_BASIS")}


@pytest.fixture(scope="module")
def jax_runs(karman_problems):
    """The JAX einsum stepper on one P1Hierarchy (one pressure mask): each
    case's 3-step run from dt0 = 1e-3, and each reduced-precision option's
    step from rest under FLOW_EMA_PREC=bf16 (read when the stepper is
    built) or FLOW_GMRES_BASIS=bf16 (read when the step is traced) ->
    ({name: output}, the hierarchy's lambda_max). The four programs are
    traced in turn and compiled at once (XLA compiles outside the GIL)."""
    jp, _ = karman_problems
    zeros = (jp.V.zeros(), jp.Q.zeros())
    jh, jobs = None, {}
    for name, kw in list(CASES.items()) + [(k, v[0]) for k, v in REDUCED.items()]:
        mp = pytest.MonkeyPatch()
        if name in REDUCED:
            mp.setenv(REDUCED[name][3], "bf16")
        try:
            js = JaxStepper(jp.V, jp.Q, jp.u_bcs, jp.p_bcs, jp.rho, jp.mu, packed=False, **kw)
            assert not js.packed and js._ema_bf16 == (name == "ema_bf16")
            if jh is None:
                jh = JaxHierarchy(jp.mesh_hierarchy, bc_mask=js.mask_p, smoother_degree=3)
            js.pressure_precond = jh.v_cycle
            if name in REDUCED:
                args = zeros + (jnp.asarray(REDUCED[name][2]),)
                jobs[name] = js.step.lower(*args), args
            else:
                args = zeros + (jnp.asarray(1e-3),)
                jobs[name] = js._run_jit.lower(*args, n_steps=3), args
        finally:
            mp.undo()
    with ThreadPoolExecutor(len(jobs)) as pool:
        compiled = list(pool.map(lambda job: job[0].compile(), jobs.values()))
    out = {name: run(*job[1]) for (name, job), run in zip(jobs.items(), compiled)}
    return out, [float(L.lmax) for L in jh.levels]


def _port_mg(tp, ts, lmax):
    th = P1Hierarchy(tp.mesh_hierarchy, bc_mask=ts.mask_p, smoother_degree=3)
    interop.load_hierarchy_lmax(th, lmax)
    ts.pressure_precond = th.v_cycle


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "dense"])
@pytest.mark.parametrize("case", list(CASES))
def test_stepper_iterate_exact_with_jax(karman_problems, jax_runs, case, packed):
    # GMRES momentum, BDF2 and the vertex preconditioner in both layouts
    _, tp = karman_problems
    outj, lmax = jax_runs[0][case], jax_runs[1]
    ts = FastStepper(tp.V, tp.Q, tp.u_bcs, tp.p_bcs, tp.rho, tp.mu, packed=packed,
                     device="cpu", **CASES[case])
    assert ts.packed == packed
    _port_mg(tp, ts, lmax)
    outt = ts.run(*ts.zeros(), 1e-3, n_steps=3)
    for key in ITERS:
        assert outt[3][key].tolist() == np.asarray(outj[3][key]).tolist(), key
    np.testing.assert_allclose(outt[3]["dt"].numpy(), np.asarray(outj[3]["dt"]), rtol=1e-12)
    assert outt[0].shape == (tp.V.n_dofs, 2)
    np.testing.assert_allclose(outt[0].numpy(), np.asarray(outj[0]), rtol=0, atol=TOL)
    np.testing.assert_allclose(outt[1].numpy(), np.asarray(outj[1]), rtol=0, atol=TOL)
    if ts.bdf2:
        np.testing.assert_allclose(outt[4][0].numpy(), np.asarray(outj[4][0]), rtol=0,
                                   atol=TOL)
    assert np.abs(outt[0].numpy()).max() > 1e-3


def test_driver_takes_packed_layout_from_the_threshold(monkeypatch, tmp_path):
    """run_karman_fast's default FastStepper resolves packed="auto" on the
    DoF count; its result and checkpoints stay in the global layout."""
    kw = dict(num_steps=3, lcar=0.2, n_refine=2, chunk_size=2, device="cpu",
              dtype=torch.float64)
    flat = karman.run_karman_fast(**kw)
    assert not flat["stepper"].packed
    monkeypatch.setattr(fast_mod, "PACKED_MIN_DOFS", 0)
    ck = tmp_path / "packed.npz"
    out = karman.run_karman_fast(checkpoint_path=str(ck), **kw)
    assert out["stepper"].packed
    for key in ITERS:
        assert out["telemetry"][key].tolist() == flat["telemetry"][key].tolist(), key
    np.testing.assert_allclose(out["u"].numpy(), flat["u"].numpy(), rtol=0, atol=1e-10)
    np.testing.assert_allclose(out["forces"], flat["forces"], rtol=0,
                               atol=1e-10 * np.abs(flat["forces"]).max())
    arrays, _ = load_checkpoint(ck)
    assert arrays["U"].shape == (out["stepper"].V.n_dofs, 2)
    np.testing.assert_array_equal(arrays["U"], out["u"].numpy())


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "dense"])
@pytest.mark.parametrize("option", list(REDUCED))
def test_reduced_precision_options_stay_near_the_solution(karman_problems, jax_runs, option,
                                                          packed):
    """ema_bf16 (the EMA tensor and the Krylov vectors it meets in
    bfloat16) and gmres_basis=torch.bfloat16 (the momentum GMRES's Arnoldi
    basis, at the bench's settings), on the JAX P1Hierarchy's lambda_max:
    iterate-exact with the JAX stepper under FLOW_EMA_PREC=bf16 or
    FLOW_GMRES_BASIS=bf16 (equal counts, U and P within 1e-8), away from
    the float64 step by more than that, and near
    it: ema_bf16 as tests/test_ema.py:202 pins (the lagged solve measured
    against the bfloat16 operator: U within 3e-5, P within 1e-1 at dt =
    1e-2), the bfloat16 basis with its solve converged and U within 1e-3 of
    max|U|."""
    _, tp = karman_problems
    kw, low, dt, _ = REDUCED[option]
    kw = dict(kw, packed=packed, device="cpu")
    exact = FastStepper(tp.V, tp.Q, tp.u_bcs, tp.p_bcs, tp.rho, tp.mu, **kw)
    st = FastStepper(tp.V, tp.Q, tp.u_bcs, tp.p_bcs, tp.rho, tp.mu, **kw, **low)
    assert st.packed == packed and st._ema_bf16 == (option == "ema_bf16")
    steps, lmax = jax_runs
    for stepper in (exact, st):
        _port_mg(tp, stepper, lmax)
    Ue, Pe, _ = exact.step(*exact.zeros(), dt)
    Ul, Pl, sl = st.step(*st.zeros(), dt)
    Uj, Pj, sj = steps[option]
    for key in ITERS:
        assert int(getattr(sl, key)) == int(getattr(sj, key)), key
    np.testing.assert_allclose(Ul.numpy(), np.asarray(Uj), rtol=0, atol=TOL)
    np.testing.assert_allclose(Pl.numpy(), np.asarray(Pj), rtol=0, atol=TOL)
    assert np.abs(Ul.numpy() - Ue.numpy()).max() > 10 * TOL
    if option == "ema_bf16":
        np.testing.assert_allclose(Ul.numpy(), Ue.numpy(), rtol=0, atol=3e-5)
        np.testing.assert_allclose(Pl.numpy(), Pe.numpy(), rtol=0, atol=1e-1)
    else:
        assert bool(sl.momentum_converged) and sl.linear_iters > 0
        np.testing.assert_allclose(Ul.numpy(), Ue.numpy(), rtol=0,
                                   atol=1e-3 * np.abs(Ue.numpy()).max())
