# flow_tpu_torch.fem.formlang against the JAX package's form compiler, in
# float64 on the CPU: the element kernels (local()) and their applies,
# diagonals and assembled load vectors of the forms tests/test_formlang.py
# compiles (mass, stiffness, convection with a Function coefficient, a
# callable source, SUPG with lap(), the vertex-rule mass, the coupled
# div/inner/sym/transpose blocks), to 1e-12 relative: the two packages run
# the same einsum chains in another summation order.
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from flow_tpu import mesh as jax_mesh
from flow_tpu.fem import assembly as jax_assembly
from flow_tpu.fem import formlang as jfl
from flow_tpu.fem import quadrature as jax_quadrature
from flow_tpu.fem.spaces import Function as JaxFunction
from flow_tpu.fem.spaces import FunctionSpace as JaxSpace
from flow_tpu_torch.fem import assembly, formlang as tfl, quadrature
from flow_tpu_torch.fem.spaces import Function, FunctionSpace
from flow_tpu_torch.mesh import unit_square_mesh

torch.set_num_threads(1)

RTOL = 1e-12


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-300)
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * scale)


class _Side:
    """One package's mesh, spaces, geometry and form language."""

    def __init__(self, fl, mesh, Space, Function, geometry, arr):
        self.fl, self.mesh, self.geom = fl, mesh, geometry(mesh)
        self.V = Space(mesh, 2)
        self.W = Space(mesh, 2, n_components=2)
        self.Q = Space(mesh, 1)
        self.Function = Function
        self.arr = arr


@pytest.fixture(scope="module")
def sides():
    jm = jax_mesh.unit_square_mesh(5, diagonal="crossed", dtype=jnp.float64)
    tm = unit_square_mesh(5, diagonal="crossed", dtype=torch.float64, device="cpu")
    return (_Side(jfl, jm, JaxSpace, JaxFunction, jax_assembly.geometry, jnp.asarray),
            _Side(tfl, tm, FunctionSpace, Function, assembly.geometry, torch.as_tensor))


def _rng_state(side, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((side.W.n_dofs, 2)), rng.standard_normal(side.V.n_dofs),
            rng.standard_normal(side.Q.n_dofs))


# each case builds, on one side, (the compiled form, the kind of its apply's
# input: 'V', 'Q', 'W' or 'Wdiag' for the component-diagonal vector apply)
def _mass(s):
    fl = s.fl
    return fl.compile_form(fl.TrialFunction(s.V) * fl.TestFunction(s.V), s.geom, 4), "V"


def _stiffness(s):
    fl = s.fl
    u, v = fl.TrialFunction(s.V), fl.TestFunction(s.V)
    return fl.compile_form(fl.dot(fl.grad(u), fl.grad(v)), s.geom, 3), "V"


def _vertex_mass(s):
    fl = s.fl
    vertex = quadrature.VERTEX if fl is tfl else jax_quadrature.VERTEX
    return fl.compile_form(fl.TrialFunction(s.Q) * fl.TestFunction(s.Q), s.geom, vertex), "Q"


def _convection(s):
    fl = s.fl
    W, _, _ = _rng_state(s, 2)
    w = fl.Coefficient(s.Function(s.W, s.arr(W)))
    u, v = fl.TrialFunction(s.V), fl.TestFunction(s.V)
    return fl.compile_form(fl.dot(w, fl.grad(u)) * v, s.geom, 5), "V"


def _supg(s):
    fl = s.fl
    B, _, _ = _rng_state(s, 3)
    b = fl.Coefficient(s.Function(s.W, s.arr(B)))
    u, v = fl.TrialFunction(s.V), fl.TestFunction(s.V)
    form = 0.7 * fl.dot(b, fl.grad(u)) * fl.dot(b, fl.grad(v)) \
        + fl.lap(u) * fl.dot(b, fl.grad(v)) - 0.01 * fl.lap(u) * fl.lap(v)
    return fl.compile_form(form, s.geom, 5), "V"


def _rotating(x, lib):
    # a rotating field about (0.5, 0.5), evaluated at [nc, nq, 2] points
    return lib.stack([-(x[..., 1] - 0.5), x[..., 0] - 0.5], axis=-1)


def _callable_convection(s):
    fl = s.fl
    lib = torch if fl is tfl else jnp
    b = fl.Coefficient(lambda x: _rotating(x, lib), vector=True)
    kappa = fl.Coefficient(lambda x: 1.0 + x[..., 0] * x[..., 1])
    u, v = fl.TrialFunction(s.V), fl.TestFunction(s.V)
    form = u * v + 0.1 * (kappa * fl.dot(fl.grad(u), fl.grad(v)) + fl.dot(b, fl.grad(u)) * v)
    return fl.compile_form(form, s.geom, 3), "V"


def _qp_coefficient(s):
    fl = s.fl
    nq = len(quadrature.simplex_rule(3, 2)[1])
    c = np.random.default_rng(4).standard_normal((s.mesh.n_cells, nq, 2))
    u, v = fl.TrialFunction(s.V), fl.TestFunction(s.V)
    form = -0.1 * fl.dot(fl.grad(u), fl.grad(v)) - fl.dot(fl.Coefficient(s.arr(c), vector=True),
                                                          fl.grad(u)) * v
    return fl.compile_form(form, s.geom, 3), "V"


def _stress(s):
    fl = s.fl
    u, v = fl.TrialFunction(s.W), fl.TestFunction(s.W)
    return fl.compile_form(0.74 * fl.inner(fl.sym(fl.grad(u)), fl.grad(v)), s.geom, 2), "W"


def _stress_transpose(s):
    fl = s.fl
    u, v = fl.TrialFunction(s.W), fl.TestFunction(s.W)
    form = 0.37 * fl.inner(fl.grad(u) + fl.transpose(fl.grad(u)), fl.grad(v))
    return fl.compile_form(form, s.geom, 2), "W"


def _div_block(s):
    fl = s.fl
    return fl.compile_form(fl.div(fl.TrialFunction(s.W)) * fl.TestFunction(s.Q), s.geom, 2), "W"


def _grad_block(s):
    fl = s.fl
    return fl.compile_form(fl.TrialFunction(s.Q) * fl.div(fl.TestFunction(s.W)), s.geom, 2), "Q"


def _vector_convection(s):
    fl = s.fl
    W, _, _ = _rng_state(s, 7)
    w = fl.Coefficient(s.Function(s.W, s.arr(W)))
    u, v = fl.TrialFunction(s.W), fl.TestFunction(s.W)
    return fl.compile_form(fl.dot(fl.dot(w, fl.grad(u)), v), s.geom, 5), "W"


def _vector_mass(s):
    fl = s.fl
    return fl.compile_form(fl.dot(fl.TrialFunction(s.W), fl.TestFunction(s.W)), s.geom, 4), "W"


def _component_mass(s):
    # the scalar-product mass on the vector space: component-diagonal apply
    fl = s.fl
    return fl.compile_form(fl.TrialFunction(s.V) * fl.TestFunction(s.V), s.geom, 4), "Wdiag"


def _div_coefficient(s):
    fl = s.fl
    W, _, _ = _rng_state(s, 8)
    w = s.Function(s.W, s.arr(W))
    u, v = fl.TrialFunction(s.V), fl.TestFunction(s.V)
    form = fl.div(fl.Coefficient(w)) * u * v + fl.inner(fl.grad(fl.Coefficient(w)),
                                                         fl.grad(fl.Coefficient(w))) * u * v
    return fl.compile_form(form, s.geom, 4), "V"


CASES = [_mass, _stiffness, _vertex_mass, _convection, _supg, _callable_convection,
         _qp_coefficient, _stress, _stress_transpose, _div_block, _grad_block,
         _vector_convection, _vector_mass, _component_mass, _div_coefficient]


def _input(side, which, seed=11):
    W, V, Q = _rng_state(side, seed)
    return side.arr({"V": V, "Q": Q, "W": W, "Wdiag": W}[which])


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__.strip("_"))
def test_local_and_apply_match_jax(sides, case):
    js, ts = sides
    jf, which = case(js)
    tf, _ = case(ts)
    assert tf.axes == jf.axes
    _close(tf.local(), jf.local())
    _close(tf.apply(_input(ts, which)), jf.apply(_input(js, which)))


@pytest.mark.parametrize("case", [_mass, _stiffness, _callable_convection, _supg,
                                  _vector_mass, _stress],
                         ids=lambda c: c.__name__.strip("_"))
def test_assemble_diag_matches_jax(sides, case):
    js, ts = sides
    _close(case(ts)[0].assemble_diag(), case(js)[0].assemble_diag())


def _linear_source(s):
    fl = s.fl
    lib = torch if fl is tfl else jnp
    f = fl.Coefficient(lambda x: lib.sin(x[..., 0]) * x[..., 1])
    return fl.compile_form(f * fl.TestFunction(s.V), s.geom, 5)


def _linear_vector(s):
    fl = s.fl
    W, _, _ = _rng_state(s, 9)
    w = fl.Coefficient(s.Function(s.W, s.arr(W)))
    return fl.compile_form(fl.dot(w, fl.TestFunction(s.W)) + fl.div(fl.TestFunction(s.W)) * 0.3,
                           s.geom, 4)


def _linear_grad(s):
    fl = s.fl
    W, _, _ = _rng_state(s, 10)
    w = fl.Coefficient(s.Function(s.W, s.arr(W)))
    return fl.compile_form(fl.dot(w, fl.grad(fl.TestFunction(s.V))), s.geom, 4)


@pytest.mark.parametrize("case", [_linear_source, _linear_vector, _linear_grad],
                         ids=lambda c: c.__name__.strip("_"))
def test_linear_assemble_matches_jax(sides, case):
    js, ts = sides
    jf, tf = case(js), case(ts)
    assert tf.space_j is None and tf.axes == jf.axes
    _close(tf.local(), jf.local())
    _close(tf.assemble(), jf.assemble())


def test_mass_apply_and_vertex_rule(sides):
    # assembly.mass_apply (K4a's reference) and the vertex rule of the port
    js, ts = sides
    _, V, _ = _rng_state(ts, 12)
    dg = assembly.geometry_on(ts.mesh, torch.float64, "cpu")
    got = assembly.mass_apply(ts.V, dg, torch.as_tensor(V))
    _close(got, jax_assembly.mass_apply(js.V, js.geom, jnp.asarray(V)))
    for dim in (2, 3):
        p, w = quadrature.simplex_rule(quadrature.VERTEX, dim)
        pj, wj = jax_quadrature.simplex_rule(jax_quadrature.VERTEX, dim)
        np.testing.assert_array_equal(p, pj)
        np.testing.assert_array_equal(w, wj)
    xq = ts.geom.physical_points(quadrature.simplex_rule(5, 2)[0])
    _close(xq, js.geom.physical_points(jax_quadrature.simplex_rule(5, 2)[0]))


def test_form_errors(sides):
    _, ts = sides
    fl = ts.fl
    u, v = fl.TrialFunction(ts.V), fl.TestFunction(ts.V)
    with pytest.raises(AssertionError, match="derivative"):
        fl.compile_form(fl.grad(u) * v, ts.geom, 2)
    with pytest.raises(ValueError, match="share no"):
        fl.compile_form(fl.dot(u, v), ts.geom, 2)
    with pytest.raises(TypeError):
        fl.compile_form(u * [1.0], ts.geom, 2)
