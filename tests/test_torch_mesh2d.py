# The 2-D foundation of flow_tpu_torch against the JAX package on
# KarmanProblem(lcar=0.2, n_refine=1), float64 on the CPU: the triangle mesh
# and its refinement, the meshkit library, the P2/P1 spaces, the Dirichlet
# masks, the geometry, the boundary tabulation and the forms of the
# momentum residual. Host setup must agree exactly (it is the same numpy
# code); the float64 forms agree to 1e-12 relative (another summation
# order). Also: the port's entry points default to the card and refuse to
# land on the CPU when there is none.
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from flow_tpu import native as jax_native
from flow_tpu.fem import assembly as jax_assembly
from flow_tpu.fem import bc as jax_bc
from flow_tpu.fem import forms as jax_forms
from flow_tpu.models.karman import KarmanProblem as JaxKarman
from flow_tpu.navier_stokes.pressure_correction import _get_ctx
from flow_tpu_torch import interop, native
from flow_tpu_torch.fem import assembly, forms
from flow_tpu_torch.fem.bc import combine_bcs
from flow_tpu_torch.mesh import rectangle_with_hole_mesh
from flow_tpu_torch.mesh3d import box_mesh
from flow_tpu_torch.models.karman import KarmanProblem
from flow_tpu_torch.navier_stokes.pressure_correction import NSContext

torch.set_num_threads(1)

F64_RTOL = 1e-12  # float64 forms: only the summation order differs


@pytest.fixture(scope="module")
def problems():
    return (JaxKarman(lcar=0.2, n_refine=1),
            KarmanProblem(lcar=0.2, n_refine=1, dtype=torch.float64, device="cpu"))


def test_meshes_equal_jax(problems):
    jp, tp = problems
    assert len(jp.mesh_hierarchy) == len(tp.mesh_hierarchy) == 2
    for jm, tm in zip(jp.mesh_hierarchy, tp.mesh_hierarchy):
        np.testing.assert_array_equal(tm.points_np, jm.points_np)
        for name in ("cells_np", "edges_np", "cell_edges_np",
                     "boundary_edges_np", "boundary_cells_np",
                     "boundary_local_np"):
            np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name),
                                          err_msg=name)
        np.testing.assert_array_equal(tm.boundary_normals_np, jm.boundary_normals_np)
        np.testing.assert_array_equal(tm.boundary_lengths_np, jm.boundary_lengths_np)
        assert (tm.hmax, tm.hmin) == (jm.hmax, jm.hmin)
    assert tp.mesh_hierarchy[1]._coarse is tp.mesh_hierarchy[0]
    assert tp.rho == jp.rho and tp.reynolds == jp.reynolds


def test_meshkit_matches_jax_package(problems):
    jp, _ = problems
    cells = jp.mesh.cells_np
    for a, b in zip(native.build_edges(cells), jax_native.build_edges(cells)):
        np.testing.assert_array_equal(a, b)
    edges = jp.mesh.edges_np
    np.testing.assert_array_equal(native.rcm_order(jp.mesh.n_points, edges),
                                  jax_native.rcm_order(jp.mesh.n_points, edges))
    assert native.library_path().parent.name == "build"


def test_spaces_and_bc_masks_equal_jax(problems):
    jp, tp = problems
    for js, ts in ((jp.V, tp.V), (jp.Q, tp.Q)):
        assert ts.n_dofs == js.n_dofs and ts.n_local == js.n_local
        np.testing.assert_array_equal(ts.cell_dofs_np, js.cell_dofs_np)
        np.testing.assert_array_equal(ts.dof_points_np, js.dof_points_np)
        np.testing.assert_array_equal(ts.boundary_dofs(), js.boundary_dofs())
    for space, jbcs, tbcs in ((tp.V, jp.u_bcs, tp.u_bcs), (tp.Q, jp.p_bcs, tp.p_bcs)):
        jmask, jval = jax_bc.combine_bcs(jbcs[0].space, jbcs)
        tmask, tval = combine_bcs(space, tbcs)
        np.testing.assert_array_equal(tmask, np.asarray(jmask))
        np.testing.assert_array_equal(tval, np.asarray(jval))
    assert tp.n_dofs == 2 * jp.V.n_dofs + jp.Q.n_dofs


def test_geometry_and_boundary_tab_match_jax(problems):
    jp, tp = problems
    jg, tg = jax_assembly.geometry(jp.mesh), assembly.geometry(tp.mesh)
    for name in ("detJ", "G", "C"):
        np.testing.assert_allclose(getattr(tg, name), np.asarray(getattr(jg, name)),
                                   rtol=F64_RTOL, atol=0)
    rng = np.random.default_rng(4)
    U = rng.standard_normal((tp.V.n_dofs, 2))
    jbt = jax_assembly.BoundaryTab(jp.V, rule_degree=6)
    tbt = assembly.BoundaryTab(tp.V, rule_degree=6)
    Ut = torch.as_tensor(U)
    np.testing.assert_allclose(tbt.values(Ut).numpy(),
                               np.asarray(jbt.values(jnp.asarray(U))), rtol=F64_RTOL)
    np.testing.assert_allclose(tbt.grads(Ut).numpy(),
                               np.asarray(jbt.grads(jnp.asarray(U), jg)),
                               rtol=1e-11, atol=1e-11)
    val = rng.standard_normal((tbt.wl.shape[0], tbt.nq1, 2))
    np.testing.assert_allclose(
        tbt.integrate_rhs(torch.as_tensor(val)).numpy(),
        np.asarray(jbt.integrate_rhs(jnp.asarray(val))), rtol=F64_RTOL, atol=1e-15)


def test_forms_and_residual_match_jax(problems):
    jp, tp = problems
    V, Q = tp.V, tp.Q
    rng = np.random.default_rng(5)
    U, U0, T = (rng.standard_normal((V.n_dofs, 2)) for _ in range(3))
    P = rng.standard_normal(Q.n_dofs)
    jctx = _get_ctx(jp.V, jp.Q)
    ctx = NSContext(V, Q, torch.float64, torch.device("cpu"))
    jg, g = jctx.geom, ctx.geom
    J, Tt = jnp.asarray, torch.as_tensor

    def close(a, b, atol=1e-12):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=F64_RTOL,
                                   atol=atol * np.abs(b).max())

    close(forms.div_rhs(V, Q, g, Tt(U)), jax_forms.div_rhs(jp.V, jp.Q, jg, J(U)))
    close(forms.grad_div_ustar_rhs(V, Q, g, Tt(U)),
          jax_forms.grad_div_ustar_rhs(jp.V, jp.Q, jg, J(U)))
    dp = 0.3 * forms.grad_div_ustar(V, g, Tt(U))
    jdp = 0.3 * jax_forms.grad_div_ustar(jp.V, jg, J(U))
    close(dp, jdp)
    close(forms.grad_phi_rhs(V, Q, g, Tt(P), div_part=dp, rule_degree=4),
          jax_forms.grad_phi_rhs(jp.V, jp.Q, jg, J(P), div_part=jdp, rule_degree=4))
    rho, mu, dt = jp.rho, jp.mu, 2e-3
    r = ctx.residual(Tt(U), Tt(U0), Tt(P), rho, mu, torch.tensor(dt, dtype=torch.float64),
                     transport=Tt(T))
    jr = jctx._residual(J(U), J(U0), None, None, J(P), rho, mu, dt, (0.0, 1.0),
                        transport=J(T))
    close(r, jr)
    close(ctx.mass_diag_V, jctx.mass_diag_V)
    close(ctx.stiff_diag_V, jctx.stiff_diag_V)


def test_main_path_size_equals_jax():
    # the smoke's Karman main path (lcar=0.02, n_refine=5): the same fine
    # mesh and the same 1,905,056 unknowns as the JAX package (setup only,
    # ~2 s each; nothing is stepped)
    jp = JaxKarman(lcar=0.02, n_refine=5)
    tp = KarmanProblem(lcar=0.02, n_refine=5, dtype=torch.float32, device="cpu")
    assert tp.n_dofs == 2 * jp.V.n_dofs + jp.Q.n_dofs == 1905056
    np.testing.assert_array_equal(tp.mesh.cells_np, jp.mesh.cells_np)
    np.testing.assert_array_equal(tp.mesh.points_np, jp.mesh.points_np)


def test_entry_points_default_to_the_card(monkeypatch):
    # device=None means the card; without one, the port refuses rather than
    # landing on the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rectangle_with_hole_mesh(0.0, 0.6, -0.07, 0.07, 0.1, 0.01, 0.02, lcar=0.2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KarmanProblem(lcar=0.2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        box_mesh((0, 0, 0), (1, 1, 1), 2, 2, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.state_to_torch(np.zeros((3, 2)), np.zeros(2))
    assert KarmanProblem(lcar=0.2, device="cpu").mesh.device == torch.device("cpu")
