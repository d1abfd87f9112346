# flow_tpu_torch's steady Stokes and its solvers against the JAX package,
# float64 on the CPU:
# - chebyshev_preconditioner on a P1 stiffness (Jacobi-scaled, degree 6):
#   the same M(r) within 1e-13 of max|M(r)|;
# - minres on a symmetric indefinite system (400 unknowns, converging in
#   ~70 steps) with an SPD diagonal preconditioner at rtol 1e-8, with and
#   without a null space: the same iterations, x within 1e-12 of max|x|,
#   the same true residual to 1e-6 relative;
# - forms.vector_laplacian_apply, pressure_grad_rhs and div_rhs within
#   1e-13, summed by dof_sum and by member tables; dense.add_block exactly;
# - stokes.solve on Guermond1 at n = 8: the dense path within 1e-12 of the
#   JAX solution; the MINRES path (DENSE_THRESHOLD = 0 on both sides, the
#   JAX lambda_max through a monkeypatched stokes.power_iteration_lmax) at
#   rtol 1e-9 with the same iterations, u within 1e-9 of max|u| and p
#   within 3e-8 of max|p| (measured 7.6e-11 and 6.1e-9: the solve stops at
#   rtol 1e-9, and the two sides' Lanczos vectors, summed in other orders,
#   drift apart in the last bits over ~80 steps; the pressure carries most
#   of it); the port's own lambda_max converges within 20% of the count;
# - the lid-driven cavity with no pressure BC (the null space): MINRES
#   against the dense path as the JAX package's test holds it (u within
#   2e-7, mean-free p within 2e-5), and the dense path against JAX's;
# - the MMS orders of tests/test_stokes.py (> 1.9 at n = 8, 16) and the
#   SolverConfig (its defaults JAX's, field by field, and its threading).
import numpy as np
import pytest
import sympy
import torch
import jax.numpy as jnp

from test_stokes import Guermond1
from helpers import compute_numerical_order_of_convergence, lambdify_x

import flow_tpu
import flow_tpu.stokes as jstokes
from flow_tpu.fem import dense as jdense
from flow_tpu.fem import forms as jforms
from flow_tpu.fem.assembly import geometry as jgeometry
from flow_tpu.solvers import chebyshev as jcheb
from flow_tpu.solvers import krylov as jkrylov

import flow_tpu_torch as ft
import flow_tpu_torch.stokes as tstokes
from flow_tpu_torch.fem import assembly, dense, forms
from flow_tpu_torch.fem.gathersum import gather_sum_of
from flow_tpu_torch.solvers import chebyshev, krylov
from flow_tpu_torch.utils import SolverConfig

torch.set_num_threads(1)
CPU = dict(dtype=torch.float64, device="cpu")


def np_fn(expr):
    """A sympy expression in x as a callable of host points or CPU tensors."""
    x = sympy.DeferredVector("x")
    f = sympy.lambdify((x[0], x[1]), expr, modules="numpy")

    def fn(pts):
        a = pts.numpy() if isinstance(pts, torch.Tensor) else pts
        v = np.broadcast_to(np.asarray(f(a[..., 0], a[..., 1]), dtype=np.float64),
                            a.shape[:-1]).copy()
        return torch.as_tensor(v, dtype=pts.dtype) if isinstance(pts, torch.Tensor) else v

    return fn


def _spd_problem(n=6, seed=0):
    """A P1 stiffness plus mass (SPD) on unit_square_mesh(n) on both sides."""
    jm = flow_tpu.unit_square_mesh(n, diagonal="crossed")
    tm = ft.unit_square_mesh(n, diagonal="crossed", **CPU)
    jV, tV = flow_tpu.FunctionSpace(jm, 1), ft.FunctionSpace(tm, 1)
    from flow_tpu.fem import assembly as jassembly

    jg, hg = jgeometry(jm), assembly.geometry(tm)
    tg = assembly.geometry_on(tm, torch.float64, "cpu")

    def jA(x):
        return jassembly.stiffness_apply(jV, jg, x) + jassembly.mass_apply(jV, jg, x)

    def tA(x):
        return assembly.stiffness_apply(tV, tg, x) + assembly.mass_apply(tV, tg, x)

    diag = assembly.stiffness_diag(tV, hg) + assembly.mass_diag(tV, hg)
    return jA, tA, diag, tV.n_dofs


def test_chebyshev_preconditioner_matches_jax():
    jA, tA, diag, n = _spd_problem()
    lmax = 1.7
    r = np.random.default_rng(1).standard_normal(n)
    ref = np.asarray(jcheb.chebyshev_preconditioner(jA, jnp.asarray(diag), lmax, degree=6)(
        jnp.asarray(r)))
    got = chebyshev.chebyshev_preconditioner(tA, torch.as_tensor(diag), lmax, degree=6)(
        torch.as_tensor(r)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-13 * np.abs(ref).max())


def _indefinite(n=400, seed=2, null=False):
    """A symmetric indefinite matrix whose Krylov solve converges well
    before n steps (so both sides' roundoff stays small)."""
    rng = np.random.default_rng(seed)
    Qm, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.concatenate([rng.uniform(1.0, 3.0, n // 2), -rng.uniform(1.0, 2.0, n - n // 2)])
    ns = None
    if null:
        v = np.ones(n) / np.sqrt(n)
        Qm[:, 0] = v
        Qm, _ = np.linalg.qr(Qm)
        lam[0] = 0.0
        ns = Qm[:, 0]
    A = (Qm * lam) @ Qm.T
    A = 0.5 * (A + A.T)
    b = rng.standard_normal(n)
    if null:
        b = b - ns * (ns @ b)
    d = rng.uniform(0.5, 2.0, n)
    return A, b, d, ns


@pytest.mark.parametrize("null", [False, True], ids=["plain", "nullspace"])
def test_minres_matches_jax(null):
    A, b, d, ns = _indefinite(null=null)
    jns = None if ns is None else [jnp.asarray(ns)]
    tns = None if ns is None else [torch.as_tensor(ns)]
    jA = jnp.asarray(A)
    xj, sj = jkrylov.minres(lambda x: jA @ x, jnp.asarray(b), M=lambda r: r / jnp.asarray(d),
                            rtol=1e-8, maxiter=500, nullspace=jns)
    tA = torch.as_tensor(A)
    xt, st = krylov.minres(lambda x: tA @ x, torch.as_tensor(b),
                           M=lambda r: r / torch.as_tensor(d), rtol=1e-8, maxiter=500,
                           nullspace=tns)
    assert st.iters == int(sj.iters) > 10
    assert bool(st.converged) and bool(sj.converged)
    xj = np.asarray(xj)
    np.testing.assert_allclose(xt.numpy(), xj, rtol=0, atol=1e-12 * np.abs(xj).max())
    assert float(st.resnorm) == pytest.approx(float(sj.resnorm), rel=1e-6)


def test_minres_cap_reports_unconverged():
    A, b, d, _ = _indefinite()
    tA = torch.as_tensor(A)
    _, st = krylov.minres(lambda x: tA @ x, torch.as_tensor(b), rtol=1e-12, maxiter=3)
    assert st.iters == 3 and not bool(st.converged)


@pytest.mark.parametrize("summed", ["dof_sum", "member_tables"])
def test_vector_laplacian_and_add_block_match_jax(summed):
    # the Stokes blocks, summed by the spaces' dof_sum and by the member
    # tables stokes._Operator hands the forms
    jm = flow_tpu.unit_square_mesh(5, diagonal="crossed")
    tm = ft.unit_square_mesh(5, diagonal="crossed", **CPU)
    jV, tV = flow_tpu.VectorFunctionSpace(jm, 2), ft.VectorFunctionSpace(tm, 2)
    jQ, tQ = flow_tpu.FunctionSpace(jm, 1), ft.FunctionSpace(tm, 1)
    sum_V, sum_Q = ((gather_sum_of(tV, "cpu"), gather_sum_of(tQ, "cpu"))
                    if summed == "member_tables" else (None, None))
    jg, tg = jgeometry(jm), assembly.geometry_on(tm, torch.float64, "cpu")
    U = np.random.default_rng(3).standard_normal((tV.n_dofs, 2))
    P = np.random.default_rng(6).standard_normal(tQ.n_dofs)
    coeff = np.random.default_rng(4).uniform(0.5, 2.0, tm.n_cells)
    pairs = [(jforms.vector_laplacian_apply(jV, jg, jnp.asarray(U),
                                            coeff=None if c is None else jnp.asarray(c)),
              forms.vector_laplacian_apply(tV, tg, torch.as_tensor(U), coeff=c,
                                           dof_sum=sum_V))
             for c in (None, coeff)]
    pairs.append((jforms.pressure_grad_rhs(jV, jQ, jg, jnp.asarray(P)),
                  forms.pressure_grad_rhs(tV, tQ, tg, torch.as_tensor(P), dof_sum=sum_V)))
    pairs.append((jforms.div_rhs(jV, jQ, jg, jnp.asarray(U)),
                  forms.div_rhs(tV, tQ, tg, torch.as_tensor(U), dof_sum=sum_Q)))
    for ref, got in pairs:
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-13 * np.abs(ref).max())
    rng = np.random.default_rng(5)
    rows, cols = rng.integers(0, 9, (4, 3)), rng.integers(0, 9, (4, 2))
    loc = rng.standard_normal((4, 3, 2))
    np.testing.assert_array_equal(dense.add_block(np.zeros((9, 9)), rows, cols, loc),
                                  jdense.add_block(np.zeros((9, 9)), rows, cols, loc))


def _guermond_case(n, mod, problem):
    mesh = (flow_tpu.unit_square_mesh(n, diagonal="left/right") if mod is flow_tpu
            else ft.unit_square_mesh(n, diagonal="left/right", **CPU))
    WP = (jstokes if mod is flow_tpu else tstokes).TaylorHood(mesh)
    if mod is flow_tpu:
        u_sol = tuple(lambdify_x(c) for c in problem.u)
        p_sol = lambdify_x(problem.p)
        f = tuple(lambdify_x(c) for c in problem.f)
    else:
        u_sol = tuple(np_fn(c) for c in problem.u)
        p_sol = np_fn(problem.p)
        f = tuple(np_fn(c) for c in problem.f)
    bcs = [mod.DirichletBC(WP.sub(0), u_sol, "on_boundary"),
           mod.DirichletBC(WP.sub(1), p_sol, "on_boundary")]
    return WP, bcs, f, u_sol, p_sol


@pytest.fixture(scope="module")
def guermond():
    return Guermond1()


def test_stokes_dense_matches_jax(guermond):
    jWP, jbcs, jf, _, _ = _guermond_case(8, flow_tpu, guermond)
    tWP, tbcs, tf, _, _ = _guermond_case(8, ft, guermond)
    ju, jp = flow_tpu.stokes.solve(jWP, jbcs, guermond.mu, jf, verbose=False, tol=1e-12)
    tu, tp = tstokes.solve(tWP, tbcs, guermond.mu, tf, verbose=False, tol=1e-12)
    assert tstokes.last_info["solver"] == "dense"
    assert tu.vector.shape == (tWP.V.n_dofs, 2) and tp.vector.device.type == "cpu"
    np.testing.assert_allclose(tu.vector.numpy(), np.asarray(ju.vector), rtol=0, atol=1e-12)
    Pj = np.asarray(jp.vector)
    np.testing.assert_allclose(tp.vector.numpy(), Pj, rtol=0, atol=1e-12 * np.abs(Pj).max())


def _jax_minres_spy(monkeypatch):
    """Record the JAX MINRES counts and the JAX Stokes lambda_max."""
    seen = {}
    orig_minres, orig_lmax = jkrylov.minres, jstokes.power_iteration_lmax

    def minres(*a, **k):
        x, s = orig_minres(*a, **k)
        seen["iters"], seen["resnorm"] = int(s.iters), float(s.resnorm)
        return x, s

    def lmax(*a, **k):
        seen["lmax"] = orig_lmax(*a, **k)
        return seen["lmax"]

    monkeypatch.setattr(jkrylov, "minres", minres)
    monkeypatch.setattr(jstokes, "power_iteration_lmax", lmax)
    return seen


def test_stokes_minres_matches_jax(guermond, monkeypatch):
    seen = _jax_minres_spy(monkeypatch)
    monkeypatch.setattr(jstokes, "DENSE_THRESHOLD", 0)
    monkeypatch.setattr(tstokes, "DENSE_THRESHOLD", 0)
    jWP, jbcs, jf, _, _ = _guermond_case(8, flow_tpu, guermond)
    tWP, tbcs, tf, _, _ = _guermond_case(8, ft, guermond)
    ju, jp = flow_tpu.stokes.solve(jWP, jbcs, guermond.mu, jf, verbose=False, tol=1e-9,
                                   max_iter=3000)
    monkeypatch.setattr(tstokes, "power_iteration_lmax", lambda *a, **k: seen["lmax"])
    tu, tp = tstokes.solve(tWP, tbcs, guermond.mu, tf, verbose=False, tol=1e-9,
                           max_iter=3000)
    info = tstokes.last_info
    assert info["solver"] == "minres" and info["iters"] == seen["iters"] > 20
    # both true residuals sit at the float64 floor of the operator, below
    # the target
    assert info["resnorm"] < 1e-8 and seen["resnorm"] < 1e-8
    Uj, Pj = np.asarray(ju.vector), np.asarray(jp.vector)
    du = np.abs(tu.vector.numpy() - Uj).max() / np.abs(Uj).max()
    dp = np.abs(tp.vector.numpy() - Pj).max() / np.abs(Pj).max()
    assert du < 1e-9 and dp < 3e-8, (du, dp)
    # the port's own lambda_max (a torch start vector) lands within a few
    # percent of JAX's and still converges
    monkeypatch.setattr(tstokes, "power_iteration_lmax", chebyshev.power_iteration_lmax)
    tstokes.solve(tWP, tbcs, guermond.mu, tf, verbose=False, tol=1e-9, max_iter=3000)
    assert abs(tstokes.last_info["iters"] - seen["iters"]) <= 0.2 * seen["iters"]
    # the iteration cap raises
    with pytest.raises(RuntimeError, match="did not converge"):
        tstokes.solve(tWP, tbcs, guermond.mu, tf, verbose=False, tol=1e-9, max_iter=5)


def _lid_bcs(WP, mod):
    def lid(x):
        return np.where(x[:, 1] > 1 - 1e-12, 1.0, 0.0)

    return [mod.DirichletBC(WP.sub(0).sub(0), lid, "on_boundary"),
            mod.DirichletBC(WP.sub(0).sub(1), 0.0, "on_boundary")]


def test_lid_cavity_without_pressure_bc(monkeypatch):
    jm = flow_tpu.unit_square_mesh(10, diagonal="crossed")
    tm = ft.unit_square_mesh(10, diagonal="crossed", **CPU)
    jWP, tWP = jstokes.TaylorHood(jm), tstokes.TaylorHood(tm)
    ju, jp = flow_tpu.stokes.solve(jWP, _lid_bcs(jWP, flow_tpu), 1.0, (0.0, 0.0),
                                   verbose=False)
    u_d, p_d = tstokes.solve(tWP, _lid_bcs(tWP, ft), 1.0, (0.0, 0.0), verbose=False)
    np.testing.assert_allclose(u_d.vector.numpy(), np.asarray(ju.vector), rtol=0, atol=1e-12)
    dpj = np.asarray(jp.vector) - np.mean(np.asarray(jp.vector))
    dpt = p_d.vector.numpy() - p_d.vector.numpy().mean()
    np.testing.assert_allclose(dpt, dpj, rtol=0, atol=1e-10 * np.abs(dpj).max())
    monkeypatch.setattr(tstokes, "DENSE_THRESHOLD", 0)
    u_i, p_i = tstokes.solve(tWP, _lid_bcs(tWP, ft), 1.0, (0.0, 0.0), verbose=False,
                             tol=1e-10, max_iter=4000)
    assert tstokes.last_info["solver"] == "minres"
    np.testing.assert_allclose(u_i.vector.numpy(), u_d.vector.numpy(), atol=2e-7)
    dp = p_i.vector - p_i.vector.mean() - (p_d.vector - p_d.vector.mean())
    assert float(dp.abs().max()) < 2e-5


def test_stokes_order(guermond):
    errs = []
    for n in (8, 16):
        WP, bcs, f, u_sol, p_sol = _guermond_case(n, ft, guermond)
        u, p = tstokes.solve(WP, bcs, guermond.mu, f, verbose=False, tol=1e-12)
        errs.append((WP.mesh.hmax, ft.errornorm(u_sol, u), ft.errornorm(p_sol, p)))
    hmax, u_err, p_err = np.array(errs).T
    assert compute_numerical_order_of_convergence(hmax, u_err)[0] > 1.9
    assert compute_numerical_order_of_convergence(hmax, p_err)[0] > 1.9


def test_solver_config_threading(guermond, monkeypatch):
    from flow_tpu.utils import SolverConfig as JaxSolverConfig

    # the fields stokes.solve reads, with the JAX package's defaults
    for field in ("rtol", "maxiter", "monitor_convergence"):
        assert getattr(SolverConfig(), field) == getattr(JaxSolverConfig(), field)
    WP, bcs, f, u_sol, _ = _guermond_case(6, ft, guermond)
    cfg = SolverConfig(rtol=1e-11, maxiter=2000, monitor_convergence=False)
    u, _ = tstokes.solve(WP, bcs, guermond.mu, f, solver_config=cfg)
    assert ft.errornorm(u_sol, u) < 0.1
    # the config's rtol and maxiter reach MINRES
    monkeypatch.setattr(tstokes, "DENSE_THRESHOLD", 0)
    with pytest.raises(RuntimeError, match="in 4 iterations"):
        tstokes.solve(WP, bcs, guermond.mu, f, solver_config=SolverConfig(maxiter=4))


def test_bcs_must_live_on_the_mixed_spaces():
    tm = ft.unit_square_mesh(4, **CPU)
    WP = tstokes.TaylorHood(tm)
    other = ft.FunctionSpace(tm, 1)
    with pytest.raises(ValueError, match="neither WP.V nor WP.Q"):
        tstokes.solve(WP, [ft.DirichletBC(other, 0.0)], 1.0, (0.0, 0.0), verbose=False)
