# flow_tpu_torch.attic.winkernel.WindowMassOperator (K4a),
# attic.winform.window_operator (K5) and WindowStiffnessOperator on P2 (K4b
# P2) against the JAX package's Pallas kernels in interpret mode, through the
# port's plain versions on the CPU: P2 on unit_square_mesh(12, 'crossed'),
# P2 tets on box_mesh 3x3x3 and the Karman velocity space of
# tests/test_winkernel.py, at 1e-6 relative to the largest entry (both
# compute in float32, in another summation order); set_matrix re-blocks a
# second coefficient's matrix. Then the implicit convection-diffusion step
# of the smoke run's formwin2d phase (K4a right-hand side, K5 matvec,
# Jacobi-BiCGStab) against the same composition of the JAX package's
# CompiledForm.apply, mass_apply and krylov.bicgstab: equal iteration
# counts, states within 1e-5 relative (the window kernels are float32).
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from flow_tpu import mesh as jax_mesh
from flow_tpu.attic.winform import window_operator as jax_window_operator
from flow_tpu.attic.winkernel import WindowMassOperator as JaxMass
from flow_tpu.attic.winkernel import WindowStiffnessOperator as JaxStiffness
from flow_tpu.fem import assembly as jax_assembly
from flow_tpu.fem import bc as jax_bc
from flow_tpu.fem import formlang as jfl
from flow_tpu.fem.spaces import FunctionSpace as JaxSpace
from flow_tpu.mesh3d import box_mesh as jax_box_mesh
from flow_tpu.models.karman import KarmanProblem as JaxKarman
from flow_tpu.solvers import krylov as jax_krylov
from flow_tpu_torch.attic import winform, winkernel
from flow_tpu_torch.fem import assembly, formlang as tfl
from flow_tpu_torch.fem.bc import DirichletBC, combine_bcs
from flow_tpu_torch.fem.spaces import FunctionSpace
from flow_tpu_torch.mesh import unit_square_mesh
from flow_tpu_torch.mesh3d import box_mesh
from flow_tpu_torch.models.karman import KarmanProblem
from flow_tpu_torch.solvers import krylov

torch.set_num_threads(1)

RTOL = 1e-6


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _crossed():
    return (JaxSpace(jax_mesh.unit_square_mesh(12, "crossed"), 2),
            FunctionSpace(unit_square_mesh(12, "crossed", dtype=torch.float64,
                                           device="cpu"), 2))


def _tets():
    return (JaxSpace(jax_box_mesh((0, 0, 0), (1, 1, 1), 3, 3, 3), 2),
            FunctionSpace(box_mesh((0, 0, 0), (1, 1, 1), 3, 3, 3, dtype=torch.float64,
                                   device="cpu"), 2))


def _karman():
    return (JaxKarman(lcar=0.1, n_refine=1).V,
            KarmanProblem(lcar=0.1, n_refine=1, dtype=torch.float64, device="cpu").V)


SPACES = {"crossed P2": _crossed, "tets P2": _tets, "karman P2": _karman}


@pytest.fixture(scope="module", params=sorted(SPACES))
def spaces(request):
    js, ts = SPACES[request.param]()
    # the Karman space is a vector space: the window operators are scalar
    if ts.n_components > 1:
        js, ts = JaxSpace(js.mesh, 2), FunctionSpace(ts.mesh, 2)
    x = np.random.default_rng(1).standard_normal(ts.n_dofs)
    return js, ts, x


def test_window_mass_plain_matches_jax_interpret(spaces):
    js, ts, x = spaces
    got = winkernel.WindowMassOperator(ts, S=128).apply(torch.as_tensor(x))
    ref = JaxMass(js, S=128, interpret=True).apply(jnp.asarray(x))
    assert got.dtype == torch.float64 and _rel(got, ref) <= RTOL
    # and the port's own float64 assembled mass apply
    dg = assembly.geometry_on(ts.mesh, torch.float64, "cpu")
    assert _rel(got, assembly.mass_apply(ts, dg, torch.as_tensor(x))) <= RTOL


def _forms(fl, V, geom, coef):
    u, v = fl.TrialFunction(V), fl.TestFunction(V)
    b = fl.Coefficient(coef, vector=True)
    return fl.compile_form(-0.1 * fl.dot(fl.grad(u), fl.grad(v)) - fl.dot(b, fl.grad(u)) * v,
                           geom, 3)


def test_window_operator_plain_matches_jax_interpret(spaces):
    # a coefficient-bearing form (the SUPG-heat operator class); set_matrix
    # re-blocks a second coefficient's matrix into the same layout
    js, ts, x = spaces
    nq = len(assembly._tab_cached(2, 3, ts.dim).w)
    rng = np.random.default_rng(13)
    bq = [rng.standard_normal((ts.mesh.n_cells, nq, ts.dim)) for _ in range(2)]
    jgeom, tgeom = jax_assembly.geometry(js.mesh), assembly.geometry(ts.mesh)
    jforms = [_forms(jfl, js, jgeom, jnp.asarray(b)) for b in bq]
    tforms = [_forms(tfl, ts, tgeom, torch.as_tensor(b)) for b in bq]
    jop = jax_window_operator(jforms[0], S=128, interpret=True)
    op = winform.window_operator(tforms[0], S=128)
    assert op.aloc.is_contiguous() and op.aloc.dtype == torch.float32
    xt, xj = torch.as_tensor(x), jnp.asarray(x)
    assert _rel(op.apply(xt), jop.apply(xj)) <= RTOL
    wl = op.wl
    jop.set_matrix(jforms[1].local())
    op.set_matrix(tforms[1].local())
    assert op.wl is wl
    assert _rel(op.apply(xt), jop.apply(xj)) <= RTOL
    # the JAX package's own tolerance against the compiled einsum apply
    np.testing.assert_allclose(op.apply(xt).numpy(), tforms[1].apply(xt).numpy(),
                               rtol=3e-5, atol=1e-5)


def test_window_stiffness_p2_plain_matches_jax_interpret(spaces):
    js, ts, x = spaces
    got = winkernel.WindowStiffnessOperator(ts, S=128).apply(torch.as_tensor(x))
    ref = JaxStiffness(js, S=128, interpret=True).apply(jnp.asarray(x))
    assert _rel(got, ref) <= RTOL


def test_window_wrappers_refuse_devices_without_a_kernel():
    _, ts = _crossed()
    op = winkernel.WindowMassOperator(ts, S=128)
    with pytest.raises(ValueError, match="no kernel for device"):
        op.windows(torch.zeros(op.wl.n_pad, device="meta"))
    u, v = tfl.TrialFunction(ts), tfl.TestFunction(ts)
    eop = winform.window_operator(tfl.compile_form(u * v, assembly.geometry(ts.mesh), 4), S=128)
    with pytest.raises(ValueError, match="no kernel for device"):
        eop.windows(torch.zeros(eop.wl.n_pad, device="meta"))
    with pytest.raises(AssertionError, match="scalar bilinear"):
        winform.window_operator(tfl.compile_form(v, assembly.geometry(ts.mesh), 2))


# ---------------------------------------------------------------------------
# the formwin2d step: implicit Euler for u_t + b.grad u = kappa lap u with a
# rotating b, homogeneous Dirichlet, on unit_square_mesh(8) P2
# ---------------------------------------------------------------------------
DT, KAPPA, STEPS = 0.02, 0.01, 3


def _rotating(x, lib):
    return lib.stack([-(x[..., 1] - 0.5), x[..., 0] - 0.5], axis=-1)


def _bump(points):
    r2 = (points[:, 0] - 0.5) ** 2 + (points[:, 1] - 0.75) ** 2
    return np.exp(-r2 / (2 * 0.1 ** 2))


def _torch_steps(n):
    mesh = unit_square_mesh(n, "right", dtype=torch.float64, device="cpu")
    V = FunctionSpace(mesh, 2)
    u, v = tfl.TrialFunction(V), tfl.TestFunction(V)
    b = tfl.Coefficient(lambda x: _rotating(x, torch), vector=True)
    S = tfl.compile_form(u * v + DT * (KAPPA * tfl.dot(tfl.grad(u), tfl.grad(v))
                                       + tfl.dot(b, tfl.grad(u)) * v),
                         assembly.geometry(mesh), 3)
    mask = torch.as_tensor(combine_bcs(V, [DirichletBC(V, 0.0)])[0])
    free = 1.0 - mask
    jac = free * S.assemble_diag() + mask
    K, M = winform.window_operator(S), winkernel.WindowMassOperator(V)
    U = torch.as_tensor(_bump(V.dof_points_np)) * free
    iters = []
    for _ in range(STEPS):
        U, info = krylov.bicgstab(lambda x: free * K.apply(x) + mask * x, free * M.apply(U),
                                  x0=U, M=lambda r: r / jac, rtol=1e-5, maxiter=200)
        assert bool(info.converged)
        iters.append(info.iters)
    return U.numpy(), iters


def _jax_steps(n):
    mesh = jax_mesh.unit_square_mesh(n, "right")
    V = JaxSpace(mesh, 2)
    geom = jax_assembly.geometry(mesh)
    u, v = jfl.TrialFunction(V), jfl.TestFunction(V)
    b = jfl.Coefficient(lambda x: _rotating(x, jnp), vector=True)
    S = jfl.compile_form(u * v + DT * (KAPPA * jfl.dot(jfl.grad(u), jfl.grad(v))
                                       + jfl.dot(b, jfl.grad(u)) * v), geom, 3)
    mask = jax_bc.combine_bcs(V, [jax_bc.DirichletBC(V, 0.0)])[0]
    free = 1.0 - mask
    jac = free * S.assemble_diag() + mask
    U = jnp.asarray(_bump(V.dof_points_np)) * free
    iters = []
    for _ in range(STEPS):
        U, info = jax_krylov.bicgstab(lambda x: free * S.apply(x) + mask * x,
                                      free * jax_assembly.mass_apply(V, geom, U), x0=U,
                                      M=lambda r: r / jac, rtol=1e-5, maxiter=200)
        assert bool(info.converged)
        iters.append(int(info.iters))
    return np.asarray(U), iters


def test_formwin2d_step_matches_jax_composition():
    U, iters = _torch_steps(8)
    U_jax, iters_jax = _jax_steps(8)
    assert iters == iters_jax and min(iters) >= 2
    assert _rel(U, U_jax) <= 1e-5
