# The public pressure-correction schemes of flow_tpu_torch (Chorin, IPCS,
# Rotational) against the JAX package's on the CPU in float64, on a
# lid-driven unit_square_mesh(8) P2/P1 cavity with a body force (a
# constant tuple, or a tuple of callables of the quadrature points, as
# f[0] and f[1]): three steps of backward Euler, Crank-Nicolson, forward
# Euler and BDF2 (the u_hat step from the second step on), equal Newton,
# pressure-CG and mass-CG iterations a step, velocity within 1e-10 and
# pressure within 1e-10 of max|p| after each step. Then the port alone: the
# sealed box of fluid under gravity stays at rest below 1e-13 (einsum and
# packed routes), the packed route (Rotational(backend="packed"), GMRES
# Picard) agrees with the einsum context within 1e-8, and the routing
# errors. The packed route against the JAX package's packed route is in
# tests/test_torch_boussinesq.py (its JAX compile is shared with the
# driver's there).
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import flow_tpu
import flow_tpu.navier_stokes.pressure_correction as jpc
import flow_tpu_torch
from flow_tpu_torch import navier_stokes as tns
from flow_tpu_torch.fem.spaces import Function as TFunction

torch.set_num_threads(1)
F64 = torch.float64
RHO, MU, DT = 1.0, 0.02, 0.05


def _lid(x):
    return np.where(x[:, 1] > 1 - 1e-12, 1.0, 0.0)


def _fx(x):
    return 0.5 * x[..., 1] ** 2 - 0.25


def _fy(x):
    return x[..., 0] * x[..., 1] - 1.0


def _problem(pkg, mesh):
    V = pkg.VectorFunctionSpace(mesh, 2)
    Q = pkg.FunctionSpace(mesh, 1)
    u_bcs = [pkg.DirichletBC(V.sub(0), _lid), pkg.DirichletBC(V.sub(1), 0.0)]
    return V, Q, u_bcs


@pytest.fixture(scope="module")
def cavity():
    """JAX and port problems, and the JAX context's per-substep iteration
    record (its jitted substeps wrapped once)."""
    jV, jQ, jb = _problem(flow_tpu, flow_tpu.unit_square_mesh(8))
    tV, tQ, tb = _problem(flow_tpu_torch, flow_tpu_torch.unit_square_mesh(
        8, dtype=F64, device="cpu"))
    ctx = jpc._get_ctx(jV, jQ)
    rec = []
    for name, k in (("_tentative_newton", 2), ("_pressure_solve", 1),
                    ("_velocity_correction", 1)):
        fn = getattr(ctx, name)

        def wrapped(*a, fn=fn, k=k, name=name, **kw):
            out = fn(*a, **kw)
            rec.append((name, int(out[k])))
            return out

        setattr(ctx, name, wrapped)
    return (jV, jQ, jb), (tV, tQ, tb), rec


CASES = [("Chorin", "backward euler", "tuple"),
         ("IPCS", "backward euler", "callable"),
         ("IPCS", "crank-nicolson", "tuple"),
         ("IPCS", "bdf2", "callable"),
         ("IPCS", "forward euler", "tuple"),
         ("Rotational", "backward euler", "tuple"),
         ("Rotational", "crank-nicolson", "callable"),
         ("Rotational", "bdf2", "tuple")]


@pytest.mark.parametrize("scheme,method,force", CASES)
def test_schemes_match_jax(cavity, scheme, method, force):
    (jV, jQ, jb), (tV, tQ, tb), rec = cavity
    kw = {} if scheme == "Chorin" else {"time_step_method": method}
    js = getattr(flow_tpu.navier_stokes, scheme)(**kw)
    ts = getattr(tns, scheme)(**kw)
    if force == "tuple":
        f = {0: (0.1, -1.0), 1: (0.2, -1.0)}
    else:
        f = {0: (_fx, _fy), 1: (_fy, _fx)}
    dt = DT if method != "forward euler" else 0.1 * DT
    ju = {0: flow_tpu.project((0.0, 0.0), jV)}
    jp = flow_tpu.project(0.0, jQ)
    tu = {0: flow_tpu_torch.project((0.0, 0.0), tV)}
    tp = flow_tpu_torch.project(0.0, tQ)
    for step in range(3):
        del rec[:]
        ju1, jp1 = js.step(dt, ju, jp, jb, [], RHO, MU, f=f, verbose=False)
        tu1, tp1 = ts.step(dt, tu, tp, tb, [], RHO, MU, f=f, verbose=False)
        jcounts = [n for _, n in rec]
        st = ts.last_stats
        tcounts = [st["newton_iters"], st["pressure_iters"], st["correction_iters"]]
        assert tcounts == jcounts, (step, tcounts, jcounts)
        assert jcounts[1] > 0 and jcounts[2] > 0
        U, Uj = tu1.vector.numpy(), np.asarray(ju1.vector)
        np.testing.assert_allclose(U, Uj, rtol=0, atol=1e-10)
        P, Pj = tp1.vector.numpy(), np.asarray(jp1.vector)
        np.testing.assert_allclose(P, Pj, rtol=0, atol=1e-10 * np.abs(Pj).max())
        if method == "bdf2":
            ju, tu = {-1: ju[0], 0: ju1}, {-1: tu[0], 0: tu1}
        else:
            ju, tu = {0: ju1}, {0: tu1}
        jp, tp = jp1, tp1
    assert np.abs(U).max() > 0.1


def _refined_box(n0=4, n_refine=2):
    mesh = flow_tpu_torch.unit_square_mesh(n0, "left", dtype=F64, device="cpu")
    for _ in range(n_refine):
        mesh = flow_tpu_torch.refine_uniform(mesh)
    return mesh


@pytest.mark.parametrize("backend", [None, "packed"])
def test_sealed_box_stays_at_rest(backend):
    g = -9.81
    if backend is None:
        mesh = flow_tpu_torch.rectangle_with_hole_mesh(
            0.0, 0.1, 0.0, 0.2, cx=0.05, cy=0.05, r=0.02, lcar=0.02, dtype=F64,
            device="cpu")
    else:
        mesh = _refined_box()
    V = flow_tpu_torch.VectorFunctionSpace(mesh, 2)
    Q = flow_tpu_torch.FunctionSpace(mesh, 1)
    u_bcs = [flow_tpu_torch.DirichletBC(V, (0.0, 0.0), "on_boundary")]
    mu = float(flow_tpu_torch.materials.water.dynamic_viscosity(293.0))
    rho = float(flow_tpu_torch.materials.water.density(293.0))
    u0 = flow_tpu_torch.project((0.0, 0.0), V)
    p0 = flow_tpu_torch.project(lambda x: g * x[..., 1], Q)
    forces = [(0.0, g)]
    if backend == "packed":
        # a nodal vector Function: the Boussinesq buoyancy's shape
        gf = torch.zeros((V.n_dofs, 2), dtype=F64)
        gf[:, 1] = g
        forces.append(TFunction(V, gf))
    for fb in forces:
        stepper = tns.IPCS(backend=backend)
        u, p = u0, p0
        for _ in range(2):
            u, p = stepper.step(1e-2, {0: u}, p, u_bcs, [], rho, mu,
                                f={0: fb, 1: fb}, verbose=False, tol=1e-10)
        assert flow_tpu_torch.norm(u.vector, "linf") < 1e-13
    if backend == "packed":
        assert V._packed_api_cache, "the packed route was not taken"


def test_packed_route_matches_einsum():
    mesh = _refined_box()
    V = flow_tpu_torch.VectorFunctionSpace(mesh, 2)
    Q = flow_tpu_torch.FunctionSpace(mesh, 1)
    u_bcs = [flow_tpu_torch.DirichletBC(V.sub(0), _lid),
             flow_tpu_torch.DirichletBC(V.sub(1), 0.0)]
    f = {0: (0.0, 0.0), 1: (0.0, 0.0)}
    ref, pk = tns.Rotational(), tns.Rotational(backend="packed")
    u = flow_tpu_torch.project((0.0, 0.0), V)
    p = flow_tpu_torch.project(0.0, Q)
    for _ in range(2):
        u, p = ref.step(1e-2, {0: u}, p, u_bcs, [], 1.0, 0.05, f=f, verbose=False)
    ur, pr = ref.step(1e-2, {0: u}, p, u_bcs, [], 1.0, 0.05, f=f, verbose=False)
    up, pp = pk.step(1e-2, {0: u}, p, u_bcs, [], 1.0, 0.05, f=f, verbose=False)
    assert pk.last_stats["newton_iters"] >= 1 and pk.last_stats["linear_iters"] > 0
    np.testing.assert_allclose(up.vector.numpy(), ur.vector.numpy(), rtol=0, atol=1e-8)
    d = (pp.vector - pr.vector).numpy()
    np.testing.assert_allclose(d - d.mean(), 0.0, atol=1e-7)
    # what the packed route cannot represent raises; "auto" falls back
    with pytest.raises(ValueError):
        tns.IPCS(backend="packed", time_step_method="crank-nicolson").step(
            1e-2, {0: u}, p, u_bcs, [], 1.0, 0.05, f=f, verbose=False)
    with pytest.raises(ValueError):
        pk.step(1e-2, {0: u}, p, u_bcs, [], 1.0, 0.05,
                f={0: (_fx, _fy), 1: (_fx, _fy)}, verbose=False)
    ua, _ = tns.Rotational(backend="auto").step(
        1e-2, {0: u}, p, u_bcs, [], 1.0, 0.05, f={0: (_fx, _fy), 1: (_fx, _fy)},
        verbose=False)
    assert bool(torch.isfinite(ua.vector).all())
    coarse = flow_tpu_torch.unit_square_mesh(4, dtype=F64, device="cpu")
    Vc = flow_tpu_torch.VectorFunctionSpace(coarse, 2)
    Qc = flow_tpu_torch.FunctionSpace(coarse, 1)
    with pytest.raises(ValueError):
        tns.IPCS(backend="packed").step(
            1e-2, {0: flow_tpu_torch.project((0.0, 0.0), Vc)},
            flow_tpu_torch.project(0.0, Qc),
            [flow_tpu_torch.DirichletBC(Vc, (0.0, 0.0))], [], 1.0, 0.05, f=f,
            verbose=False)
    # the public contract's errors
    with pytest.raises(AssertionError):
        ref.step(1e-2, {0: u}, p, u_bcs, [], 1.0, -1.0, f=f, verbose=False)
    with pytest.raises(AssertionError):
        ref.step(0.0, {0: u}, p, u_bcs, [], 1.0, 0.05, f=f, verbose=False)
