# flow_tpu_torch.ops.structured.StructuredLaplacian and
# solvers.structured_mg.StructuredHierarchy against the JAX package, in
# float64 on the CPU (the port's plain stencil path).
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from flow_tpu.mesh3d import box_mesh as jax_box_mesh
from flow_tpu.ops.structured import StructuredLaplacian as JaxLaplacian
from flow_tpu.solvers.structured_mg import StructuredHierarchy as JaxHierarchy
from flow_tpu_torch import interop
from flow_tpu_torch.fem import assembly
from flow_tpu_torch.fem.assembly import geometry
from flow_tpu_torch.fem.spaces import FunctionSpace
from flow_tpu_torch.mesh3d import box_mesh
from flow_tpu_torch.ops.structured import StructuredLaplacian
from flow_tpu_torch.solvers.structured_mg import StructuredHierarchy

torch.set_num_threads(1)

P1 = (1.0, 1.2, 0.8)


def _meshes(n):
    return (
        jax_box_mesh((0, 0, 0), P1, *n, dtype=jnp.float64),
        box_mesh((0, 0, 0), P1, *n, dtype=torch.float64, device="cpu"),
    )


@pytest.mark.parametrize("n", [(4, 6, 8), (1, 3, 2)])
def test_laplacian_matches_jax(n):
    jm, tm = _meshes(n)
    x = np.random.default_rng(0).standard_normal(int(np.prod(tm.grid_shape)))
    y = StructuredLaplacian(tm)(torch.as_tensor(x))
    y_jax = np.asarray(JaxLaplacian(jm)(jnp.asarray(x)))
    np.testing.assert_allclose(y.numpy(), y_jax, rtol=0, atol=1e-12)
    # and the assembled P1 stiffness apply of the port itself
    S = FunctionSpace(tm, 1)
    y_asm = assembly.stiffness_apply(S, geometry(tm), x)
    np.testing.assert_allclose(y.numpy(), y_asm, rtol=0, atol=1e-12)


@pytest.fixture(scope="module")
def meshes():
    jm, tm = _meshes((4, 6, 8))
    return jm, tm


@pytest.mark.parametrize("direction", ["prolong", "restrict"])
def test_transfers_match_jax(meshes, direction):
    jm, tm = meshes
    jh, th = JaxHierarchy(jm), StructuredHierarchy(tm)
    level = th.nlevels - 2
    n = th.levels[level if direction == "prolong" else level + 1].n
    x = np.random.default_rng(1).standard_normal(n)
    y = getattr(th, direction)(level, torch.as_tensor(x)).numpy()
    y_jax = np.asarray(getattr(jh, direction)(level, jnp.asarray(x)))
    # weights are powers of 1/2; the two libraries sum the taps in another
    # order, so the results agree to the last bit or two
    np.testing.assert_allclose(y, y_jax, rtol=0, atol=4e-15)


@pytest.mark.parametrize("bc", ["neumann", "dirichlet"])
def test_v_cycle_matches_jax_with_lmax_carried(meshes, bc):
    jm, tm = meshes
    mask = None
    if bc == "dirichlet":
        Q = FunctionSpace(tm, 1)
        mask = np.zeros(Q.n_dofs)
        mask[Q.boundary_dofs()] = 1.0
    jh = JaxHierarchy(jm, bc_mask=None if mask is None else jnp.asarray(mask))
    th = StructuredHierarchy(tm, bc_mask=mask)
    assert th.nlevels == jh.nlevels == 2
    interop.load_hierarchy_lmax(th, [float(L.lmax) for L in jh.levels])
    for Lt, Lj in zip(th.levels, jh.levels):
        assert Lt.theta == pytest.approx(float(Lj.theta), rel=1e-15)
        assert Lt.delta == pytest.approx(float(Lj.delta), rel=1e-15)
    b = np.random.default_rng(2).standard_normal(th.levels[-1].n)
    y = th.v_cycle(torch.as_tensor(b)).numpy()
    y_jax = np.asarray(jh.v_cycle(jnp.asarray(b)))
    np.testing.assert_allclose(y, y_jax, rtol=0, atol=1e-12)


def test_power_iteration_lmax_close_to_jax(meshes):
    # 30 power steps from a random start stop short of convergence on these
    # levels, and the two packages start from different random vectors: both
    # estimates are lower bounds within 5% of the exact lambda_max of
    # diag^-1 K (measured: 2.2% below it, and 1.1% apart, on the coarse
    # level), which is why the stepper tests carry the JAX values across.
    jm, tm = meshes
    jh, th = JaxHierarchy(jm), StructuredHierarchy(tm)
    for Lt, Lj in zip(th.levels, jh.levels):
        K = torch.stack([Lt.K(e) for e in torch.eye(Lt.n, dtype=torch.float64)])
        d = Lt.diag.rsqrt()
        exact = float(torch.linalg.eigvalsh(d[:, None] * K * d[None, :]).max())
        for est in (Lt.lmax, float(Lj.lmax)):
            assert exact * (1 - 5e-2) <= est <= exact * (1 + 1e-12)
        assert Lt.lmax == pytest.approx(float(Lj.lmax), rel=5e-2)


def test_load_hierarchy_lmax_checks_level_count(meshes):
    _, tm = meshes
    th = StructuredHierarchy(tm)
    with pytest.raises(ValueError, match="levels"):
        interop.load_hierarchy_lmax(th, [2.0])
