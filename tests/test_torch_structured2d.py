# The 2-D structured-grid route of flow_tpu_torch against the JAX package,
# in float64 on the CPU (the port's plain stencil path): rectangle_mesh
# (bitwise), StructuredLaplacian on 'right' and 'left' grids (1e-12), the
# StructuredHierarchy transfers and V-cycle (1e-10, lambda_max carried
# across), and MG-preconditioned CG iterate-exact (equal iteration counts,
# states within 1e-8) for the pure-Neumann and the Dirichlet Poisson
# problems of tests/test_structured_mg.py.
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from flow_tpu import mesh as jax_mesh
from flow_tpu.fem import assembly as jax_assembly
from flow_tpu.fem.spaces import FunctionSpace as JaxSpace
from flow_tpu.ops.structured import StructuredLaplacian as JaxLaplacian
from flow_tpu.solvers import krylov as jax_krylov
from flow_tpu.solvers.structured_mg import StructuredHierarchy as JaxHierarchy
from flow_tpu_torch import interop
from flow_tpu_torch.fem import assembly
from flow_tpu_torch.fem.assembly import geometry
from flow_tpu_torch.fem.spaces import FunctionSpace
from flow_tpu_torch.mesh import rectangle_mesh, unit_square_mesh
from flow_tpu_torch.ops.structured import StructuredLaplacian, supports
from flow_tpu_torch.solvers import krylov
from flow_tpu_torch.solvers.structured_mg import StructuredHierarchy

torch.set_num_threads(1)

DIAGONALS = ["left", "right", "left/right", "right/left", "crossed"]


@pytest.mark.parametrize("diagonal", DIAGONALS)
def test_rectangle_mesh_equals_jax(diagonal):
    args = ((0.0, -0.5), (2.0, 1.0), 7, 5, diagonal)
    jm = jax_mesh.rectangle_mesh(*args)
    tm = rectangle_mesh(*args, device="cpu")
    np.testing.assert_array_equal(tm.points_np, jm.points_np)
    for name in ("cells_np", "edges_np", "cell_edges_np", "boundary_edges_np"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name), err_msg=name)
    assert getattr(tm, "grid_shape", None) == getattr(jm, "grid_shape", None)
    assert getattr(tm, "grid_spacing", None) == getattr(jm, "grid_spacing", None)
    assert supports(tm) == (diagonal in ("left", "right"))


def test_unit_square_mesh_and_errors():
    tm = unit_square_mesh(4, device="cpu")
    jm = jax_mesh.unit_square_mesh(4)
    np.testing.assert_array_equal(tm.cells_np, jm.cells_np)
    assert tm.grid_shape == (5, 5) and tm.device == torch.device("cpu")
    with pytest.raises(ValueError, match="unknown diagonal"):
        rectangle_mesh((0, 0), (1, 1), 2, 2, "up", device="cpu")


_GRIDS = {
    "square-right": ((0, 0), (1, 1), 9, 9, "right"),
    "rect-left": ((0, 0), (2.0, 1.0), 10, 6, "left"),
}


@pytest.mark.parametrize("grid", sorted(_GRIDS))
def test_laplacian_2d_matches_jax(grid):
    args = _GRIDS[grid]
    jm = jax_mesh.rectangle_mesh(*args, dtype=jnp.float64)
    tm = rectangle_mesh(*args, dtype=torch.float64, device="cpu")
    x = np.random.default_rng(0).standard_normal(tm.n_points)
    y = StructuredLaplacian(tm)(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(y, np.asarray(JaxLaplacian(jm)(jnp.asarray(x))),
                               rtol=0, atol=1e-12)
    y_asm = assembly.stiffness_apply(FunctionSpace(tm, 1), geometry(tm), x)
    np.testing.assert_allclose(y, y_asm, rtol=0, atol=1e-12)


def _meshes(diagonal="right", n=32):
    return (jax_mesh.unit_square_mesh(n, diagonal, dtype=jnp.float64),
            unit_square_mesh(n, diagonal, dtype=torch.float64, device="cpu"))


def _mask(tm):
    Q = FunctionSpace(tm, 1)
    mask = np.zeros(Q.n_dofs)
    mask[Q.boundary_dofs()] = 1.0
    return mask


def _hierarchies(jm, tm, bc, n_levels=None):
    mask = _mask(tm) if bc == "dirichlet" else None
    jh = JaxHierarchy(jm, n_levels=n_levels,
                      bc_mask=None if mask is None else jnp.asarray(mask))
    th = StructuredHierarchy(tm, n_levels=n_levels, bc_mask=mask)
    assert th.nlevels == jh.nlevels
    interop.load_hierarchy_lmax(th, [float(L.lmax) for L in jh.levels])
    return jh, th, mask


@pytest.mark.parametrize("direction", ["prolong", "restrict"])
def test_transfers_2d_match_jax(direction):
    jm, tm = _meshes(n=16)
    jh, th = JaxHierarchy(jm), StructuredHierarchy(tm)
    level = th.nlevels - 2
    n = th.levels[level if direction == "prolong" else level + 1].n
    x = np.random.default_rng(1).standard_normal(n)
    y = getattr(th, direction)(level, torch.as_tensor(x)).numpy()
    y_jax = np.asarray(getattr(jh, direction)(level, jnp.asarray(x)))
    np.testing.assert_allclose(y, y_jax, rtol=0, atol=4e-15)


@pytest.mark.parametrize("diagonal", ["right", "left"])
@pytest.mark.parametrize("bc", ["neumann", "dirichlet"])
def test_v_cycle_2d_matches_jax(diagonal, bc):
    # a 'left' fine grid has 'right' coarse levels in both packages
    jm, tm = _meshes(diagonal)
    jh, th, _ = _hierarchies(jm, tm, bc, n_levels=3)
    assert [m.grid_shape for m in th.meshes] == [tuple(m.grid_shape) for m in jh.meshes]
    for tmesh, jmesh in zip(th.meshes[:-1], jh.meshes[:-1]):
        np.testing.assert_array_equal(tmesh.cells_np, jmesh.cells_np)
    b = np.random.default_rng(2).standard_normal(th.levels[-1].n)
    y = th.v_cycle(torch.as_tensor(b)).numpy()
    y_jax = np.asarray(jh.v_cycle(jnp.asarray(b)))
    np.testing.assert_allclose(y, y_jax, rtol=0, atol=1e-10 * np.abs(y_jax).max())


@pytest.mark.parametrize("bc", ["neumann", "dirichlet"])
def test_mg_preconditioned_cg_2d_is_iterate_exact(bc):
    # the solve of tests/test_structured_mg.py on unit_square_mesh(32): the
    # JAX side applies the assembled stiffness, the port its stencil operator
    jm, tm = _meshes()
    jh, th, mask = _hierarchies(jm, tm, bc)
    jS = JaxSpace(jm, 1)
    jgeom = jax_assembly.geometry(jm)
    b = np.random.default_rng(0).standard_normal(jS.n_dofs)
    K = StructuredLaplacian(tm)

    def jax_K(x):
        return jax_assembly.stiffness_apply(jS, jgeom, x)

    if bc == "neumann":
        b = b - b.mean()
        xj, ij = jax_krylov.cg(jax_K, jnp.asarray(b), M=jh.v_cycle, rtol=1e-10, maxiter=200,
                               nullspace=[jnp.ones(jS.n_dofs)])
        xt, it = krylov.cg(K, torch.as_tensor(b), M=th.v_cycle, rtol=1e-10, maxiter=200,
                           nullspace=[torch.ones(jS.n_dofs, dtype=torch.float64)])
    else:
        free = 1.0 - mask
        b = free * b
        jfree, jmask = jnp.asarray(free), jnp.asarray(mask)
        tfree, tmask = torch.as_tensor(free), torch.as_tensor(mask)
        xj, ij = jax_krylov.cg(lambda x: jfree * jax_K(jfree * x) + jmask * x, jnp.asarray(b),
                               M=jh.v_cycle, rtol=1e-10, maxiter=200)
        xt, it = krylov.cg(lambda x: tfree * K(tfree * x) + tmask * x, torch.as_tensor(b),
                           M=th.v_cycle, rtol=1e-10, maxiter=200)
    assert bool(it.converged) and bool(ij.converged)
    assert it.iters == int(ij.iters) < 40
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0, atol=1e-8)
