# State transfer along refine_uniform hierarchies (flow_tpu_torch/fem/
# transfer.py) against the JAX package's (flow_tpu/fem/transfer.py), float64
# on the CPU: prolongation and restriction bitwise equal to JAX's on a
# two-level hierarchy for P1 and P2, scalar and [n, 2] vectors, and the
# properties tests/test_transfer.py holds JAX's to (linear fields transfer
# exactly, smooth P2 fields at second order, restriction undoes
# prolongation and takes point values).
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from flow_tpu import FunctionSpace as JFunctionSpace
from flow_tpu import VectorFunctionSpace as JVectorFunctionSpace
from flow_tpu import unit_square_mesh as j_unit_square_mesh
from flow_tpu.fem import transfer as jtransfer
from flow_tpu.mesh import refine_uniform as j_refine_uniform
from flow_tpu_torch import (FunctionSpace, VectorFunctionSpace, errornorm, project,
                            refine_uniform, unit_square_mesh)
from flow_tpu_torch.fem import prolong, prolong_vector, transfer

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64, device="cpu")


def _hierarchy(n, diagonal, levels=2):
    meshes = [unit_square_mesh(n, diagonal=diagonal, **F64)]
    jmeshes = [j_unit_square_mesh(n, diagonal=diagonal)]
    for _ in range(levels):
        meshes.append(refine_uniform(meshes[-1]))
        jmeshes.append(j_refine_uniform(jmeshes[-1]))
    for m, jm in zip(meshes, jmeshes):
        np.testing.assert_array_equal(m.points_np, jm.points_np)
        np.testing.assert_array_equal(m.edges_np, jm.edges_np)
    return meshes, jmeshes


def _spaces(meshes, degree, vector, module):
    if module == "jax":
        make = JVectorFunctionSpace if vector else JFunctionSpace
    else:
        make = VectorFunctionSpace if vector else FunctionSpace
    return [make(m, degree) for m in meshes]


@pytest.mark.parametrize("degree, vector", [(1, False), (2, False), (1, True), (2, True)],
                         ids=["P1", "P2", "P1-vector", "P2-vector"])
def test_prolong_and_restrict_bitwise_equal_jax(degree, vector):
    meshes, jmeshes = _hierarchy(5, "crossed")
    S = _spaces(meshes, degree, vector, "torch")
    J = _spaces(jmeshes, degree, vector, "jax")
    rng = np.random.default_rng(7)
    x = rng.standard_normal((S[0].n_dofs, 2) if vector else S[0].n_dofs)
    xt, xj = torch.as_tensor(x), jnp.asarray(x)
    for lvl in range(2):
        xt = prolong_vector(xt, S[lvl], S[lvl + 1])
        xj = jtransfer.prolong_vector(xj, J[lvl], J[lvl + 1])
        assert xt.shape == tuple(xj.shape) == ((S[lvl + 1].n_dofs, 2) if vector
                                               else (S[lvl + 1].n_dofs,))
        np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    for lvl in (1, 0):
        xt = transfer.restrict_vector(xt, S[lvl + 1], S[lvl])
        xj = jtransfer.restrict_vector(xj, J[lvl + 1], J[lvl])
        np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(xt.numpy(), x)


def test_prolong_p1_exact_for_linear():
    mc = unit_square_mesh(6, diagonal="crossed", **F64)
    mf = refine_uniform(mc)
    Qc, Qf = FunctionSpace(mc, 1), FunctionSpace(mf, 1)
    f = lambda x: 2.0 * x[..., 0] - 3.0 * x[..., 1] + 0.5
    pf = prolong(project(f, Qc), Qf)
    assert pf.space is Qf
    np.testing.assert_allclose(pf.vector.numpy(), project(f, Qf).vector.numpy(), atol=1e-10)


def test_prolong_p2_exact_for_linear_and_second_order():
    mc = unit_square_mesh(8, **F64)
    mf = refine_uniform(mc)
    Vc, Vf = VectorFunctionSpace(mc, 2), VectorFunctionSpace(mf, 2)
    lin = (lambda x: x[..., 0] + 2 * x[..., 1], lambda x: -x[..., 0])
    uf = prolong(project(lin, Vc), Vf)
    np.testing.assert_allclose(uf.vector.numpy(), project(lin, Vf).vector.numpy(), atol=1e-9)
    f = (lambda x: torch.sin(2 * x[..., 0]) * torch.cos(x[..., 1]),
         lambda x: torch.cos(x[..., 0] + x[..., 1]))
    errs = []
    for n in (4, 8, 16):
        mc = unit_square_mesh(n, **F64)
        Vc, Vf = VectorFunctionSpace(mc, 2), VectorFunctionSpace(refine_uniform(mc), 2)
        errs.append(errornorm(f, prolong(project(f, Vc), Vf)))
    orders = np.log2(np.array(errs[:-1]) / np.array(errs[1:]))
    assert (orders > 1.9).all(), (errs, orders)


def test_prolong_vector_shapes():
    mc = unit_square_mesh(5, **F64)
    Vc, Vf = VectorFunctionSpace(mc, 2), VectorFunctionSpace(refine_uniform(mc), 2)
    Uf = prolong_vector(torch.ones((Vc.n_dofs, 2), dtype=torch.float64), Vc, Vf)
    assert Uf.shape == (Vf.n_dofs, 2)
    np.testing.assert_array_equal(Uf.numpy(), 1.0)
    with pytest.raises(AssertionError, match="not refine_uniform"):
        prolong_vector(Uf, Vf, VectorFunctionSpace(refine_uniform(mc), 2))


def test_restrict_is_left_inverse_of_prolong():
    rng = np.random.default_rng(3)
    mc = unit_square_mesh(7, diagonal="crossed", **F64)
    mf = refine_uniform(mc)
    for deg, shape in [(1, ()), (2, ()), (2, (2,))]:
        if shape:
            Sc, Sf = VectorFunctionSpace(mc, deg), VectorFunctionSpace(mf, deg)
        else:
            Sc, Sf = FunctionSpace(mc, deg), FunctionSpace(mf, deg)
        x = torch.as_tensor(rng.standard_normal((Sc.n_dofs, *shape)))
        back = transfer.restrict_vector(prolong_vector(x, Sc, Sf), Sf, Sc)
        assert torch.equal(back, x)


def test_restrict_matches_point_values():
    mc = unit_square_mesh(6, **F64)
    mf = refine_uniform(mc)
    Qc, Qf = FunctionSpace(mc, 2), FunctionSpace(mf, 2)
    f = lambda x: x[..., 0] ** 2 - 0.5 * x[..., 0] * x[..., 1]
    pc = transfer.restrict(project(f, Qf), Qc)
    assert pc.space is Qc
    np.testing.assert_allclose(pc.vector.numpy(), project(f, Qc).vector.numpy(), atol=1e-9)
