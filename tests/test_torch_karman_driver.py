# flow_tpu_torch.models.karman's driver and probes against the JAX package,
# float64 on the CPU:
# - run_karman_fast(num_steps=3, lcar=0.2, n_refine=0, use_multigrid=False,
#   chunk_size=2) at its defaults (Newton, backward Euler, consistent force
#   probe; chunk plus remainder): the port on the window route against the
#   JAX driver on its default route (the einsum Newton tangent in float64;
#   its window route runs the Pallas kernels in interpret mode, ~2 minutes
#   here). Telemetry keys, t, dt and iteration counts equal; forces within
#   5e-5 of max|F| and the state at float32 level (the port's window route
#   computes in float32);
# - the Newton stepper with backward Euler and Crank-Nicolson at n_refine=0
#   with no pressure preconditioner (the Jacobi-CG pressure solve), 2 steps,
#   against the JAX FastStepper on the same route as above, with the same
#   bounds, and with a tight Newton target and Eisenstat-Walker forcing;
# - a JAX-written checkpoint loads and resumes in the port; the port's
#   4 + 2 resumed steps equal a contiguous 6-step run to 1e-12 (BE and BDF2);
# - ConsistentForceProbe and the traction integral against JAX on a random
#   state to 1e-12; strouhal_number on a synthetic sine; the DFG 2D-2
#   problem's invariants;
# - the Stokes bootstrap (KarmanProblem.stokes_bootstrap) against JAX's:
#   the dense path at lcar=0.2 (u, p within 1e-11 of their largest
#   entries: the same matrix, right-hand sides summed in other orders), and
#   MINRES (rtol 1e-6, JAX's lambda_max) with equal iterations at lcar=0.1
#   n_refine=2 (within 1e-9) and at lcar=0.2, where both raise after the
#   same count (the recurrence stops with the true residual above the
#   target); run_karman (2 Rotational steps from the bootstrap: t, dt,
#   forces and state against JAX's) and run_karman_fast(from_rest=False)
#   on both backends, 2 steps, equal counts, the state within 1e-8 and the
#   forces within 3e-8 of their largest entries (measured 1.1e-8 on the
#   packed route).
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from flow_tpu.io import save_checkpoint as jax_save_checkpoint
from flow_tpu.models import karman as jax_karman
from flow_tpu.navier_stokes.fast import FastStepper as JaxStepper
from flow_tpu_torch import interop
from flow_tpu_torch.io import load_checkpoint, save_checkpoint
from flow_tpu_torch.models import karman
from flow_tpu_torch.navier_stokes.fast import FastStepper

torch.set_num_threads(1)

SMALL = dict(lcar=0.2, n_refine=0, use_multigrid=False)
PORT = dict(winkernel=True, device="cpu", dtype=torch.float64)
ITERS = ("newton_iters", "linear_iters", "pressure_iters", "correction_iters")
FLAGS = ("momentum_converged", "pressure_converged", "correction_converged")


def _shared(module, name, mp):
    """Make the JAX driver's stepper class `module.name` hand back one
    instance per (spaces, settings): the JAX driver builds and compiles a
    stepper in every call, and a stepper's compiled chunk serves every later
    call with the same settings (the forces probe of the first call stays:
    it is the same problem's)."""
    cls = getattr(module, name)
    built = {}

    def make(V, *args, **kw):
        key = (id(V), repr(sorted((k, v) for k, v in kw.items() if k != "forces_probe")))
        if key not in built:
            built[key] = cls(V, *args, **kw)
        return built[key]

    mp.setattr(module, name, make)


@pytest.fixture(scope="module")
def jax_problems():
    """The JAX problems whose driver steppers the JAX runs of this module
    share (einsum at n_refine=0, packed at n_refine=2)."""
    import flow_tpu.navier_stokes.fast as jfast
    import flow_tpu.navier_stokes.patchfast as jpatchfast

    mp = pytest.MonkeyPatch()
    _shared(jfast, "FastStepper", mp)
    _shared(jpatchfast, "PackedPatchStepper", mp)
    yield {0: jax_karman.KarmanProblem(lcar=0.2, n_refine=0),
           2: jax_karman.KarmanProblem(lcar=0.2, n_refine=2)}
    mp.undo()


@pytest.fixture(scope="module")
def drivers(tmp_path_factory, jax_problems):
    ck = str(tmp_path_factory.mktemp("ck") / "jax.npz")
    mp = pytest.MonkeyPatch()
    mp.delenv("FLOW_WINKERNEL", raising=False)
    try:
        jout = jax_karman.run_karman_fast(num_steps=3, chunk_size=2, checkpoint_path=ck,
                                          problem=jax_problems[0], **SMALL)
    finally:
        mp.undo()
    tout = karman.run_karman_fast(num_steps=3, chunk_size=2, **SMALL, **PORT)
    return jout, tout, ck


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
    F = np.asarray(jout["forces"])
    assert tout["forces"].shape == F.shape == (3, 2)
    np.testing.assert_allclose(tout["forces"], F, rtol=0, atol=5e-5 * np.abs(F).max())
    Pj = np.asarray(jout["p"].vector)
    np.testing.assert_allclose(tout["u"].numpy(), np.asarray(jout["u"].vector),
                               rtol=0, atol=2e-7)
    np.testing.assert_allclose(tout["p"].numpy(), Pj, rtol=0,
                               atol=1.5e-5 * np.abs(Pj).max())


@pytest.mark.parametrize("method, extra", [
    ("backward euler", {}),
    ("crank-nicolson", {}),
    # a tight Newton target takes several Newton iterations per step, so
    # the Eisenstat-Walker inner tolerance moves
    ("backward euler", dict(newton_rtol=1e-8, ew_forcing=True)),
], ids=["be", "cn", "be-eisenstat-walker"])
def test_newton_stepper_without_preconditioner_matches_jax(method, extra):
    kw = dict(convection="newton", time_step_method=method, rotational_form=True,
              newton_tol=0.0, newton_rtol=1e-3, newton_maxiter=3,
              linear_rtol=1e-4, pressure_rtol=1e-4, correction_rtol=1e-5,
              ew_forcing=False, cfl_target=1.0, dt_max=1.0, packed=False)
    kw.update(extra)
    jp = jax_karman.KarmanProblem(lcar=0.2)
    js = JaxStepper(jp.V, jp.Q, jp.u_bcs, jp.p_bcs, jp.rho, jp.mu, **kw)
    assert js.pressure_precond is None
    Uj, Pj, _, telj = js._run_jit(jp.V.zeros(), jp.Q.zeros(), jnp.asarray(1e-4),
                                  n_steps=2)
    tp = karman.KarmanProblem(lcar=0.2, dtype=torch.float64, device="cpu")
    ts = FastStepper(tp.V, tp.Q, tp.u_bcs, tp.p_bcs, tp.rho, tp.mu,
                     winkernel=True, **kw)
    Ut, Pt, _, telt = ts.run(*ts.zeros(), 1e-4, n_steps=2)
    for key in ITERS:
        assert telt[key].tolist() == np.asarray(telj[key]).tolist(), key
    assert max(telt["newton_iters"].tolist()) > 1 or not kw["ew_forcing"]
    np.testing.assert_allclose(telt["dt"].numpy(), np.asarray(telj["dt"]), rtol=1e-12)
    for key in FLAGS[1:] if kw["ew_forcing"] else FLAGS:
        assert bool(telt[key].all()), key
    Pj = np.asarray(Pj)
    np.testing.assert_allclose(Ut.numpy(), np.asarray(Uj), rtol=0, atol=2e-7)
    np.testing.assert_allclose(Pt.numpy(), Pj, rtol=0, atol=1.5e-5 * np.abs(Pj).max())


def test_jax_checkpoint_resumes_in_the_port(drivers, tmp_path):
    jout, _, ck = drivers
    arrays, scalars = load_checkpoint(ck)
    np.testing.assert_array_equal(arrays["U"], np.asarray(jout["u"].vector))
    np.testing.assert_array_equal(arrays["P"], np.asarray(jout["p"].vector))
    assert scalars["dt"] == jout["dt"]
    out = karman.run_karman_fast(num_steps=1, checkpoint_path=ck, resume=True,
                                 **SMALL, **PORT)
    assert out["telemetry"]["dt"][0] == jout["dt"]
    assert np.isfinite(out["u"].numpy()).all() and np.isfinite(out["forces"]).all()


@pytest.mark.parametrize("method", ["backward euler", "bdf2"])
def test_checkpoint_resume_equals_contiguous_run(method, tmp_path):
    ck = str(tmp_path / "state.npz")
    kw = dict(SMALL, time_step_method=method, **PORT)
    karman.run_karman_fast(num_steps=4, checkpoint_path=ck, **kw)
    assert os.path.exists(ck)
    arrays, scalars = load_checkpoint(ck)
    assert ("Um1" in arrays and "dtp" in scalars) == (method == "bdf2")
    resumed = karman.run_karman_fast(num_steps=2, checkpoint_path=ck, resume=True, **kw)
    full = karman.run_karman_fast(num_steps=6, **kw)
    np.testing.assert_allclose(resumed["u"].numpy(), full["u"].numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(resumed["p"].numpy(), full["p"].numpy(), rtol=0,
                               atol=1e-12 * np.abs(full["p"].numpy()).max())
    np.testing.assert_allclose(resumed["telemetry"]["dt"], full["telemetry"]["dt"][4:],
                               rtol=1e-12)


def test_checkpoint_format_is_the_jax_packages(tmp_path):
    rng = np.random.default_rng(0)
    U, P = rng.standard_normal((7, 2)), rng.standard_normal(3)
    jax_save_checkpoint(str(tmp_path / "j.npz"), {"U": U, "P": P}, {"dt": 0.5})
    save_checkpoint(str(tmp_path / "t.npz"), {"U": torch.as_tensor(U), "P": P},
                    {"dt": 0.5})
    for name in ("j.npz", "t.npz"):
        arrays, scalars = load_checkpoint(str(tmp_path / name))
        np.testing.assert_array_equal(arrays["U"], U)
        np.testing.assert_array_equal(arrays["P"], P)
        assert scalars == {"dt": 0.5}
    with np.load(tmp_path / "t.npz") as data:
        assert sorted(data.files) == ["__version__", "arr_P", "arr_U", "scl_dt"]


def test_force_probes_match_jax():
    jp = jax_karman.KarmanProblem(lcar=0.2)
    tp = karman.KarmanProblem(lcar=0.2, dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(4)
    U1, U0 = (rng.standard_normal((tp.V.n_dofs, 2)) for _ in range(2))
    P1 = rng.standard_normal(tp.Q.n_dofs)
    jprobe, tprobe = jp.consistent_force_probe(), tp.consistent_force_probe()
    assert tprobe.needs_history
    for args in ((U1, P1), (U1, P1, U0, 3e-4)):
        ref = np.asarray(jprobe(*(jnp.asarray(a) for a in args)))
        # dt stays a Python float: a 0-d torch.as_tensor(float) is float32
        got = tprobe(*(torch.as_tensor(a) if isinstance(a, np.ndarray) else a
                       for a in args)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12 * np.abs(ref).max())
    from flow_tpu.fem.spaces import Function

    ref = jp.forces(Function(jp.V, jnp.asarray(U1)), Function(jp.Q, jnp.asarray(P1)))
    Ut, Pt = interop.state_to_torch(U1, P1, device="cpu")
    np.testing.assert_allclose(tp.forces(Ut, Pt), ref, rtol=1e-12)
    np.testing.assert_allclose(tp.drag_lift_coefficients(Ut, Pt),
                               jp.drag_lift_coefficients(Function(jp.V, jnp.asarray(U1)),
                                                         Function(jp.Q, jnp.asarray(P1))),
                               rtol=1e-12)


def test_strouhal_estimator_synthetic():
    # pure-sine lift at f=2 Hz -> St = f d / U = 2 * 0.04 / 0.01 = 8
    t = np.linspace(0.0, 5.0, 400)
    assert abs(karman.strouhal_number(t, np.sin(2 * np.pi * 2.0 * t)) - 8.0) < 0.2
    assert karman.strouhal_number(t[:40], np.sin(2 * np.pi * 2.0 * t[:40])) is None


def test_schafer_turek_problem():
    prob = karman.schafer_turek_problem(lcar=0.05, n_refine=0,
                                        dtype=torch.float64, device="cpu")
    assert abs(prob.reynolds - 100.0) < 1e-12
    assert abs(prob.force_scale - 0.5 * 1.0 * 1.0**2 * 0.1) < 1e-12
    # open outflow: 4 velocity BCs (walls, obstacle, inlet), no outlet u BC
    assert len(prob.u_bcs) == 4 and len(prob.p_bcs) == 1
    out = karman.run_karman_fast(num_steps=4, dt0=1e-4, dt_max=2e-3, problem=prob,
                                 chunk_size=2, winkernel=True)
    assert np.isfinite(out["forces"]).all()
    assert out["t"][-1] > 0


# -- the packed backend (PackedPatchStepper, the bench's default path) --------
PACKED = dict(backend="packed", convection="lagged", lcar=0.2, n_refine=2)


@pytest.fixture(scope="module")
def packed_drivers(tmp_path_factory, jax_problems):
    """run_karman_fast(backend="packed") at its defaults (GMRES, backward
    Euler, consistent force probe) for 2 steps: the JAX driver writing a
    checkpoint, and the port with the JAX hierarchy's lambda_max."""
    ck = str(tmp_path_factory.mktemp("ck") / "jax_packed.npz")
    jout = jax_karman.run_karman_fast(num_steps=2, checkpoint_path=ck,
                                      problem=jax_problems[2], **PACKED)
    lmax = [float(L.lmax) for L in jout["stepper"].pressure_precond.__self__.levels]
    tout = karman.run_karman_fast(num_steps=2, lmax=lmax, device="cpu",
                                  dtype=torch.float64, **PACKED)
    return jout, tout, lmax, ck


def test_packed_driver_matches_jax(packed_drivers):
    jout, tout, _, _ = packed_drivers
    jt, tt = jout["telemetry"], tout["telemetry"]
    assert set(tt) == set(jt) | set(FLAGS)
    for key in ITERS:
        assert tt[key].tolist() == np.asarray(jt[key]).tolist(), key
    assert tt["linear_iters"].min() > 1
    for key in ("t", "dt"):
        np.testing.assert_allclose(tt[key], np.asarray(jt[key]), rtol=1e-12)
    for key in FLAGS:
        assert tt[key].all(), key
    F = np.asarray(jout["forces"])
    assert tout["forces"].shape == F.shape == (2, 2)
    np.testing.assert_allclose(tout["forces"], F, rtol=0, atol=1e-8 * np.abs(F).max())
    Uj, Pj = np.asarray(jout["u"].vector), np.asarray(jout["p"].vector)
    assert tout["u"].shape == Uj.shape and tout["p"].shape == Pj.shape
    np.testing.assert_allclose(tout["u"].numpy(), Uj, rtol=0, atol=1e-8 * np.abs(Uj).max())
    np.testing.assert_allclose(tout["p"].numpy(), Pj, rtol=0, atol=1e-8 * np.abs(Pj).max())


def test_packed_driver_resumes_global_checkpoints(packed_drivers, tmp_path):
    # the JAX packed driver's checkpoint is in the global layout; the port
    # packs it once, and its own checkpoints are global too
    jout, tout, lmax, ck = packed_drivers
    arrays, scalars = load_checkpoint(ck)
    assert arrays["U"].shape == tuple(tout["u"].shape)
    kw = dict(PACKED, lmax=lmax, device="cpu", dtype=torch.float64)
    out = karman.run_karman_fast(num_steps=1, checkpoint_path=ck, resume=True, **kw)
    assert out["telemetry"]["dt"][0] == jout["dt"] == scalars["dt"]
    own = str(tmp_path / "port.npz")
    a = karman.run_karman_fast(num_steps=3, checkpoint_path=own, **kw)
    arrays, _ = load_checkpoint(own)
    np.testing.assert_array_equal(arrays["U"], a["u"].numpy())
    np.testing.assert_array_equal(arrays["P"], a["p"].numpy())
    b = karman.run_karman_fast(num_steps=1, checkpoint_path=own, resume=True, **kw)
    # a global initial_state is packed once: the same step as the resume
    c = karman.run_karman_fast(num_steps=1, initial_state=(a["u"], a["p"]),
                               dt0=a["dt"], **kw)
    full = karman.run_karman_fast(num_steps=4, **kw)
    for run in (b, c):
        np.testing.assert_allclose(run["u"].numpy(), full["u"].numpy(), rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(run["p"].numpy(), full["p"].numpy(), rtol=0,
                                   atol=1e-12 * np.abs(full["p"].numpy()).max())
        assert run["telemetry"]["dt"][0] == pytest.approx(full["telemetry"]["dt"][3],
                                                          rel=1e-12)


@pytest.mark.parametrize("bad", [dict(convection="newton"), dict(n_refine=0),
                                 dict(backend="window")])
def test_packed_driver_refuses_other_routes(bad):
    kw = dict(PACKED, num_steps=1, device="cpu", dtype=torch.float64)
    kw.update(bad)
    with pytest.raises(ValueError):
        karman.run_karman_fast(**kw)


# -- the Stokes bootstrap and the drivers that start from it ------------------
def _stokes_spy(monkeypatch):
    """Record the JAX Stokes MINRES counts and its lambda_max."""
    import flow_tpu.stokes as jstokes
    from flow_tpu.solvers import krylov as jkrylov

    seen = {}
    orig_minres, orig_lmax = jkrylov.minres, jstokes.power_iteration_lmax

    def minres(*a, **k):
        x, s = orig_minres(*a, **k)
        seen["iters"] = int(s.iters)
        return x, s

    def lmax(*a, **k):
        seen["lmax"] = orig_lmax(*a, **k)
        return seen["lmax"]

    monkeypatch.setattr(jkrylov, "minres", minres)
    monkeypatch.setattr(jstokes, "power_iteration_lmax", lmax)
    return seen


@pytest.mark.parametrize("path, mesh", [
    ("dense", dict(lcar=0.2)),
    ("minres", dict(lcar=0.1, n_refine=2)),
    ("minres-fails", dict(lcar=0.2)),
], ids=["dense", "minres", "minres-fails"])
def test_stokes_bootstrap_matches_jax(path, mesh, monkeypatch):
    # run_karman's bootstrap (rtol 1e-13: the dense path at this size) and
    # run_karman_fast(from_rest=False)'s (MINRES at rtol 1e-6, at most 2000
    # iterations; forced with DENSE_THRESHOLD = 0 on both sides, JAX's
    # lambda_max). MINRES stops on its preconditioned recurrence; at
    # lcar=0.2 the true residual is then above the target on both sides
    # (3.4e-5 after 48 iterations), and both raise
    import flow_tpu.stokes as jstokes
    from flow_tpu_torch import stokes as tstokes

    jp = jax_karman.KarmanProblem(**mesh)
    tp = karman.KarmanProblem(dtype=torch.float64, device="cpu", **mesh)
    assert tp.WP.V is tp.V and tp.WP.Q is tp.Q
    kw = {}
    if path != "dense":
        seen = _stokes_spy(monkeypatch)
        monkeypatch.setattr(jstokes, "DENSE_THRESHOLD", 0)
        monkeypatch.setattr(tstokes, "DENSE_THRESHOLD", 0)
        kw = dict(tol=1e-6, max_iter=2000)
    if path == "minres-fails":
        with pytest.raises(RuntimeError, match="did not converge"):
            jp.stokes_bootstrap(**kw)
        monkeypatch.setattr(tstokes, "power_iteration_lmax", lambda *a, **k: seen["lmax"])
        with pytest.raises(RuntimeError, match="did not converge in 2000"):
            tp.stokes_bootstrap(**kw)
        assert tstokes.last_info["iters"] == seen["iters"] < 2000
        return
    ju, jpp = jp.stokes_bootstrap(**kw)
    if path == "minres":
        monkeypatch.setattr(tstokes, "power_iteration_lmax", lambda *a, **k: seen["lmax"])
    tu, tpp = tp.stokes_bootstrap(**kw)
    assert tstokes.last_info["solver"] == path
    if path == "minres":
        assert tstokes.last_info["iters"] == seen["iters"] > 10
    # dense: the same matrix, right-hand sides summed in other orders
    # (|u| ~ 0.01); minres: stopped at rtol 1e-6, the two sides' roundoff
    # stays far below it
    tol = 1e-11 if path == "dense" else 1e-9
    Uj, Pj = np.asarray(ju.vector), np.asarray(jpp.vector)
    np.testing.assert_allclose(tu.vector.numpy(), Uj, rtol=0, atol=tol * np.abs(Uj).max())
    np.testing.assert_allclose(tpp.vector.numpy(), Pj, rtol=0, atol=tol * np.abs(Pj).max())


def test_run_karman_matches_jax():
    jout = jax_karman.run_karman(num_steps=2, lcar=0.2, collect_forces=True)
    tout = karman.run_karman(num_steps=2, lcar=0.2, collect_forces=True, device="cpu",
                             dtype=torch.float64)
    np.testing.assert_allclose(tout["t"], jout["t"], rtol=1e-12)
    np.testing.assert_allclose(tout["dt"], jout["dt"], rtol=1e-12)
    Uj, Pj = np.asarray(jout["u"].vector), np.asarray(jout["p"].vector)
    np.testing.assert_allclose(tout["u"].vector.numpy(), Uj, rtol=0,
                               atol=1e-10 * np.abs(Uj).max())
    np.testing.assert_allclose(tout["p"].vector.numpy(), Pj, rtol=0,
                               atol=1e-10 * np.abs(Pj).max())
    F = np.asarray(jout["forces"])
    assert tout["forces"].shape == F.shape == (2, 2)
    np.testing.assert_allclose(tout["forces"], F, rtol=0, atol=1e-9 * np.abs(F).max())
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 6\\b"):
        karman.run_karman(num_steps=1, lcar=0.2, writer=object(), device="cpu")


@pytest.mark.parametrize("route", [
    dict(backend="fast", n_refine=0, use_multigrid=False),
    dict(backend="packed", convection="lagged", n_refine=2),
], ids=["fast", "packed"])
def test_run_karman_fast_from_stokes_matches_jax(route, jax_problems):
    # from_rest=False: the Stokes bootstrap (the dense path at this size;
    # MINRES is held above), then 2 steps on each backend
    kw = dict(num_steps=2, lcar=0.2, from_rest=False, **route)
    jout = jax_karman.run_karman_fast(problem=jax_problems[route["n_refine"]], **kw)
    lmax = None
    if route["backend"] == "packed":
        lmax = [float(L.lmax) for L in jout["stepper"].pressure_precond.__self__.levels]
    tout = karman.run_karman_fast(lmax=lmax, device="cpu", dtype=torch.float64, **kw)
    boot = tout["bootstrap"]
    assert boot["solver"] == "dense" and boot["seconds"] > 0
    jt, tt = jout["telemetry"], tout["telemetry"]
    for key in ITERS:
        assert tt[key].tolist() == np.asarray(jt[key]).tolist(), key
    assert tt["linear_iters"].min() > 0
    np.testing.assert_allclose(tt["dt"], np.asarray(jt["dt"]), rtol=1e-10)
    Uj, Pj = np.asarray(jout["u"].vector), np.asarray(jout["p"].vector)
    np.testing.assert_allclose(tout["u"].numpy(), Uj, rtol=0, atol=1e-8 * np.abs(Uj).max())
    np.testing.assert_allclose(tout["p"].numpy(), Pj, rtol=0, atol=1e-8 * np.abs(Pj).max())
    # the probe differences the bootstrap's larger state: 1.1e-8 of max|F|
    # measured on the packed route
    F = np.asarray(jout["forces"])
    np.testing.assert_allclose(tout["forces"], F, rtol=0, atol=3e-8 * np.abs(F).max())
