# The time orders of the port's projection schemes (flow_tpu_torch.
# navier_stokes Chorin, IPCS, Rotational), float64 on the CPU, by the
# manufactured-solution harness of tests/test_navier_stokes.py: the same
# sympy solutions and forcing (taken from that file), errors over a
# (mesh sizes x dt) grid, and the observed order held to each scheme's
# advertised order less 0.1. The quick Chorin case runs in the default
# gate, the rest are marked slow as in the JAX suite. Also the do-nothing
# boundary identity of the port's momentum residual (NSContext.residual)
# on an exact plane Poiseuille flow.
import numpy as np
import pytest
import sympy
import torch

import flow_tpu_torch.navier_stokes as navsto
from flow_tpu_torch import (DirichletBC, Function, FunctionSpace, VectorFunctionSpace,
                            errornorm, project, rectangle_mesh, unit_square_mesh)
from flow_tpu_torch.fem import assembly
from test_navier_stokes import problem_flat, problem_guermond1, problem_guermond2

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64, device="cpu")

# the port's meshes of the JAX problems' mesh generators
MESHES = {
    problem_flat: lambda n: unit_square_mesh(n, diagonal="left/right", **F64),
    problem_guermond1: lambda n: rectangle_mesh((-1, -1), (1, 1), n, n, diagonal="crossed",
                                                **F64),
    problem_guermond2: lambda n: unit_square_mesh(n, diagonal="crossed", **F64),
}


def compute_numerical_order_of_convergence(Dt, errors):
    """tests/helpers.py's order estimate: log(e_k / e_k+1) / log(dt_k / dt_k+1)."""
    Dt = np.asarray(Dt, dtype=float)
    errors = np.asarray(errors, dtype=float)
    return np.array([np.log(errors[k] / errors[k + 1]) / np.log(Dt[k] / Dt[k + 1])
                     for k in range(len(Dt) - 1)])


def lambdify_xt(expr, t_value, subs=None):
    """tests/helpers.py's lambdify_xt for the port: a sympy expression in
    (x, t) -> a callable of points [..., 2] at time t_value, on tensors
    (the quadrature points; evaluated in numpy on the host) and on numpy
    arrays (the Dirichlet conditions' dof points)."""
    x = sympy.DeferredVector("x")
    t = sympy.symbols("t")
    if subs:
        expr = expr.subs(subs)
    f = sympy.lambdify((x[0], x[1], t), expr, modules="numpy")

    def fn(pts):
        if isinstance(pts, torch.Tensor):
            val = np.ascontiguousarray(fn(pts.detach().cpu().numpy()))
            return torch.as_tensor(val, dtype=pts.dtype, device=pts.device)
        val = np.asarray(f(pts[..., 0], pts[..., 1], t_value), dtype=pts.dtype)
        return np.broadcast_to(val, pts.shape[:-1])

    return fn


def _exact_mean(fn, mesh, rule_degree=6):
    """int_Omega fn dx for a callable, by quadrature."""
    geom = assembly.geometry(mesh)
    tab = assembly.tabulation(FunctionSpace(mesh, 1), rule_degree)
    xq = torch.as_tensor(geom.physical_points(tab.ref_pts))
    return float(np.einsum("eq,q,e->", fn(xq).numpy(), tab.w, geom.detJ))


def compute_time_errors(problem, method, mesh_sizes, Dt):
    _, u_sym, p_sym, f_sym, mu, rho = problem()
    subs = {sympy.symbols("mu"): mu, sympy.symbols("rho"): rho}
    errors = {"u": np.empty((len(mesh_sizes), len(Dt))),
              "p": np.empty((len(mesh_sizes), len(Dt)))}
    for k, mesh_size in enumerate(mesh_sizes):
        mesh = MESHES[problem](mesh_size)
        mesh_area = float(np.sum(mesh.cell_volumes()))
        W = VectorFunctionSpace(mesh, 2)
        P = FunctionSpace(mesh, 1)
        geom = assembly.geometry_on(mesh, torch.float64, "cpu")
        for j, dt in enumerate(Dt):
            u_at = lambda tv: tuple(lambdify_xt(c, tv, subs=subs) for c in u_sym)
            p_at = lambda tv: lambdify_xt(p_sym, tv, subs=subs)
            f_at = lambda tv: tuple(lambdify_xt(c, tv, subs=subs) for c in f_sym)
            u1, p1 = method.step(
                dt, {-1: project(u_at(-dt), W), 0: project(u_at(0.0), W)},
                project(p_at(0.0), P), u_bcs=[DirichletBC(W, u_at(dt), "on_boundary")],
                p_bcs=[], rho=rho, mu=mu, f={0: f_at(0.0), 1: f_at(dt)}, verbose=False,
                tol=1.0e-10,
            )
            errors["u"][k][j] = errornorm(u_at(dt), u1)
            # the free pressure constant: p1 += mean(p - p1)
            alpha = _exact_mean(p_at(dt), mesh) - float(assembly.integral(P, geom, p1.vector))
            p1 = Function(P, p1.vector + alpha / mesh_area)
            errors["p"][k][j] = errornorm(p_at(dt), p1)
    return errors


def assert_time_order(problem, method, mesh_sizes, Dt):
    errors = compute_time_errors(problem, method, mesh_sizes, Dt)
    orders = {key: compute_numerical_order_of_convergence(Dt, errors[key].T).T
              for key in errors}
    assert (orders["u"][:, 0] > method.order["velocity"] - 0.1).all(), orders
    assert (orders["p"][:, 0] > method.order["pressure"] - 0.1).all(), orders
    return errors, orders


def test_order_harness_matches_helpers():
    # the copy of the order estimate is tests/helpers.py's, and the torch
    # lambdify agrees with the jnp one at the quadrature points
    from helpers import compute_numerical_order_of_convergence as jax_order
    from helpers import lambdify_xt as jax_lambdify_xt

    Dt = [1e-2, 5e-3, 2.5e-3]
    err = np.array([[4e-3, 1e-3, 2.6e-4], [1e-2, 5e-3, 2.4e-3]]).T
    np.testing.assert_array_equal(compute_numerical_order_of_convergence(Dt, err),
                                  jax_order(Dt, err))
    _, u_sym, p_sym, f_sym, mu, rho = problem_guermond1()
    subs = {sympy.symbols("mu"): mu, sympy.symbols("rho"): rho}
    pts = np.random.default_rng(1).uniform(-1, 1, (5, 7, 2))
    for expr in (*u_sym, p_sym, *f_sym):
        fn = lambdify_xt(expr, 0.3, subs=subs)
        want = np.asarray(jax_lambdify_xt(expr, 0.3, subs=subs)(pts))
        np.testing.assert_allclose(fn(torch.as_tensor(pts)).numpy(), want, rtol=1e-13,
                                   atol=1e-13)
        np.testing.assert_allclose(fn(pts), want, rtol=1e-13, atol=1e-13)


def test_chorin_flat_quick():
    # the one time-order case of the default gate: coarsest-grid Chorin on
    # the flat problem (its exact solution is in the spaces: the errors are
    # the splitting's)
    errors, _ = assert_time_order(problem_flat, navsto.Chorin(), Dt=[1.0e-3, 0.5e-3],
                                  mesh_sizes=[16])
    assert np.isfinite(errors["u"]).all() and np.isfinite(errors["p"]).all()


@pytest.mark.parametrize("problem", [problem_flat, problem_guermond1, problem_guermond2])
@pytest.mark.slow
def test_chorin(problem):
    assert_time_order(problem, navsto.Chorin(), Dt=[1.0e-3, 0.5e-3], mesh_sizes=[16, 32])


@pytest.mark.parametrize("problem", [problem_guermond2])
@pytest.mark.slow
def test_ipcs(problem):
    assert_time_order(problem, navsto.IPCS(time_step_method="backward euler"),
                      mesh_sizes=[8, 16, 32], Dt=[0.5**k for k in range(2)])


@pytest.mark.parametrize("problem", [problem_guermond1])
@pytest.mark.slow
def test_rotational(problem):
    assert_time_order(problem, navsto.Rotational(time_step_method="backward euler"),
                      mesh_sizes=[32, 64], Dt=[1.0e-2, 0.5e-2])


@pytest.mark.parametrize("problem", [problem_guermond1])
@pytest.mark.slow
def test_rotational_bdf2(problem):
    # BDF2: second order in velocity at backward-Euler cost; the harness
    # hands the exact u(-dt) as history ({-1: u_1})
    assert_time_order(problem, navsto.Rotational(time_step_method="bdf2"),
                      mesh_sizes=[32, 64], Dt=[1.0e-2, 0.5e-2])


def test_open_boundary_2d_poiseuille_residual_identity():
    # plane Poiseuille with an open outflow, u = (y(1-y), 0), p = 2(2-x) + 1,
    # mu = rho = 1: an exact steady solution in the P2/P1 spaces. With the
    # directional do-nothing term the momentum residual at the exact state
    # equals exactly
    #   -(dt/2) oint (u.n)_- (u.phi_i) ds + dt oint (grad u) n . phi_i ds
    # (the inflow part of the skew flux and the do-nothing remainder on the
    # walls, rows a real solve masks with Dirichlet conditions): every
    # volume term integrates by parts against the ds terms
    from flow_tpu_torch.fem.assembly import BoundaryTab
    from flow_tpu_torch.navier_stokes.pressure_correction import _get_ctx

    mesh = rectangle_mesh((0.0, 0.0), (2.0, 1.0), 8, 4, **F64)
    V = VectorFunctionSpace(mesh, 2)
    Q = FunctionSpace(mesh, 1)
    U0 = project((lambda x: x[..., 1] * (1.0 - x[..., 1]), 0.0), V).vector
    P0 = project(lambda x: 2.0 * (2.0 - x[..., 0]) + 1.0, Q).vector

    dt = 5.0e-2
    r = _get_ctx(V, Q).residual(U0, U0, P0, 1.0, 1.0, dt, (0.0, 1.0))

    bt = BoundaryTab(V, rule_degree=6)
    uq = bt.values(U0)
    un = torch.einsum("bqd,bd->bq", uq, bt.normals)
    gradun = torch.einsum("bqad,bd->bqa", bt.grads(U0), bt.normals)
    expected = (-(dt / 2.0) * bt.integrate_rhs(torch.clamp(un, max=0.0)[:, :, None] * uq)
                + dt * bt.integrate_rhs(gradun))
    np.testing.assert_allclose(r.numpy(), expected.numpy(), atol=1e-13)
