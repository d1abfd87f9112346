# flow_tpu_torch.experimental.ab2tr.AB2TR against the JAX package's,
# float64 on the CPU, on the Guermond 2 solution of tests/test_ab2tr.py:
# the bootstrap's acceleration and pressure and one adaptive step (AB2
# predictor, Newton-GMRES trapezoid corrector, LTE controller) at
# unit_square_mesh(8): u within 1e-12, du/dt within 1e-9 of their largest
# entries (the bootstrap solve stops at rtol 1e-10), p within 1e-10 of
# max|p|, the proposed dt and the LTE to 1e-9 relative. The MMS accuracy
# check of one step at n = 16 is slow-marked, as the JAX package's is.
import numpy as np
import pytest
import sympy
import torch

from helpers import lambdify_xt
from test_ab2tr import _guermond2

import flow_tpu
from flow_tpu.experimental.ab2tr import AB2TR as JaxAB2TR

import flow_tpu_torch as ft
from flow_tpu_torch.experimental.ab2tr import AB2TR

torch.set_num_threads(1)
CPU = dict(dtype=torch.float64, device="cpu")
DT = 1.0e-2


def np_at(expr, tv):
    """A sympy expression in (x, t) at t = tv as a callable of host points
    or CPU tensors."""
    x, t = sympy.DeferredVector("x"), sympy.symbols("t")
    f = sympy.lambdify((x[0], x[1], t), expr, modules="numpy")

    def fn(pts):
        a = pts.numpy() if isinstance(pts, torch.Tensor) else pts
        v = np.broadcast_to(np.asarray(f(a[..., 0], a[..., 1], tv), dtype=np.float64),
                            a.shape[:-1]).copy()
        return torch.as_tensor(v, dtype=pts.dtype) if isinstance(pts, torch.Tensor) else v

    return fn


def _port_run(n):
    u_sym, _, f_sym = _guermond2()
    mesh = ft.unit_square_mesh(n, diagonal="crossed", **CPU)
    V, Q = ft.VectorFunctionSpace(mesh, 2), ft.FunctionSpace(mesh, 1)
    u0 = ft.project(tuple(np_at(c, 0.0) for c in u_sym), V)
    bcs = [ft.DirichletBC(V, tuple(np_at(c, DT) for c in u_sym), "on_boundary")]
    integ = AB2TR(V, Q, bcs, rho=1.0, mu=1.0, f=tuple(np_at(c, 0.5 * DT) for c in f_sym))
    state = integ.bootstrap(u0)
    return V, state, integ.step(state, DT)


def test_ab2tr_step_matches_jax():
    u_sym, _, f_sym = _guermond2()
    mesh = flow_tpu.unit_square_mesh(8, diagonal="crossed")
    V, Q = flow_tpu.VectorFunctionSpace(mesh, 2), flow_tpu.FunctionSpace(mesh, 1)
    u0 = flow_tpu.project(tuple(lambdify_xt(c, 0.0) for c in u_sym), V)
    bcs = [flow_tpu.DirichletBC(V, tuple(lambdify_xt(c, DT) for c in u_sym), "on_boundary")]
    jinteg = JaxAB2TR(V, Q, bcs, rho=1.0, mu=1.0,
                      f=tuple(lambdify_xt(c, 0.5 * DT) for c in f_sym))
    jstate = jinteg.bootstrap(u0)
    jnew, jdt, jlte = jinteg.step(jstate, DT)

    _, state, (new, dt_next, lte) = _port_run(8)
    assert state["dt_old"] is None and new["dt_old"] == DT

    def close(a, b, tol):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=tol * np.abs(b).max())

    close(state["udot"], jstate["udot"], 1e-9)
    close(state["p"], jstate["p"], 1e-10)
    close(new["u"], jnew["u"], 1e-12)
    close(new["p"], jnew["p"], 1e-10)
    close(new["udot"], jnew["udot"], 1e-9)
    assert dt_next == pytest.approx(jdt, rel=1e-9)
    assert lte == pytest.approx(jlte, rel=1e-9)


@pytest.mark.slow
def test_ab2tr_step_accuracy():
    u_sym, _, _ = _guermond2()
    V, state, (new, dt_next, lte) = _port_run(16)
    assert bool(torch.isfinite(state["udot"]).all())
    assert float(state["udot"].abs().max()) > 1e-3
    err = ft.errornorm(tuple(np_at(c, DT) for c in u_sym), ft.Function(V, new["u"]))
    # one TR step from the exact projection: O(dt^3) LTE plus the spatial error
    assert err < 5e-4, err
    assert dt_next > 0 and np.isfinite(lte)
