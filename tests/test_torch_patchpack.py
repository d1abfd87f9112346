# flow_tpu_torch.fem.patch and fem.patchpack against the JAX package, float64
# on the CPU, on tests/test_patchfast.py's fixture mesh (the Karman channel
# at lcar=0.1, refined 3 times):
# - the host maps (PatchInfo.vmaps, p2map, fine_cell_slot), PatchGeom at
#   every level, and every packed layout's L, weights, representative
#   slots and seam tables equal JAX's exactly; refine_uniform numbers edge
#   e's midpoint n_points + e, which the lattice maps rely on;
# - every PackedPatch operator, the seam sum, PackedBoundary's operators,
#   P1LevelKernels.stiffness_apply on every level, the hierarchy's
#   prolong/restrict and its V-cycle (Dirichlet and Neumann, lambda_max
#   carried across) against JAX's on random inputs made with numpy: 1e-12
#   of the largest reference value, 1e-10 for ema_volume_apply and the
#   V-cycle; restrict is the adjoint of prolong in the layouts' metric.
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from flow_tpu.fem.assembly import BoundaryTab as JaxBoundaryTab, geometry as jax_geometry
from flow_tpu.fem.patch import PatchGeom as JaxPatchGeom, build_patch_info as jax_patch_info
from flow_tpu.fem.patchpack import (
    PackedBoundary as JaxPackedBoundary,
    PackedPatch as JaxPackedPatch,
    PackedPatchP1Hierarchy as JaxHierarchy,
    make_p1_layout as jax_p1_layout,
)
from flow_tpu.fem.spaces import FunctionSpace as JaxFunctionSpace
from flow_tpu.fem.spaces import VectorFunctionSpace as JaxVectorFunctionSpace
from flow_tpu.mesh import rectangle_with_hole_mesh as jax_mesh, refine_uniform as jax_refine
from flow_tpu_torch import interop
from flow_tpu_torch.fem.assembly import BoundaryTab
from flow_tpu_torch.fem.patch import PatchGeom, build_patch_info
from flow_tpu_torch.fem.patchpack import (
    PackedBoundary,
    PackedPatch,
    PackedPatchP1Hierarchy,
    make_p1_layout,
)
from flow_tpu_torch.fem.spaces import FunctionSpace, VectorFunctionSpace
from flow_tpu_torch.mesh import rectangle_with_hole_mesh, refine_uniform

torch.set_num_threads(1)

MESH = dict(x0=0, x1=0.6, y0=-0.07, y1=0.07, cx=0.1, cy=0.01, r=0.02, lcar=0.1)
LAYOUT_HOST = ("L", "valid", "weight", "slot_of_dof", "offsets", "_nbr", "_flip",
               "_corner_slots", "_corner_group")


@pytest.fixture(scope="module")
def packs():
    jm = [jax_mesh(**MESH)]
    tm = [rectangle_with_hole_mesh(**MESH, dtype=torch.float64, device="cpu")]
    for _ in range(3):
        jm.append(jax_refine(jm[-1]))
        tm.append(refine_uniform(tm[-1]))
    ji, ti = jax_patch_info(jm), build_patch_info(tm)
    return ji, ti, JaxPackedPatch(ji), PackedPatch(ti)


def _rel(ref, got):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert ref.shape == got.shape
    return float(np.abs(ref - got).max() / max(1.0e-300, np.abs(ref).max()))


def _inputs(pp, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(2 * pp.n2), rng.standard_normal(2 * pp.n2),
            rng.standard_normal(pp.n1))


def _consistent(lay_j, x):
    """A replica-consistent packed vector from any: the JAX seam sum."""
    return np.array(lay_j.seam_sum(jnp.asarray(x)))


def test_refine_uniform_numbers_midpoints_after_vertices():
    coarse = rectangle_with_hole_mesh(**MESH, dtype=torch.float64, device="cpu")
    fine = refine_uniform(coarse)
    e = coarse.edges_np
    mid = 0.5 * (coarse.points_np[e[:, 0]] + coarse.points_np[e[:, 1]])
    np.testing.assert_array_equal(fine.points_np[: coarse.n_points], coarse.points_np)
    np.testing.assert_allclose(fine.points_np[coarse.n_points:], mid, rtol=0, atol=1e-15)


def test_patch_info_matches_jax(packs):
    ji, ti, _, _ = packs
    assert (ti.C, ti.k, ti.n) == (ji.C, ji.k, ji.n)
    for a, b in zip(ji.vmaps, ti.vmaps):
        np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(ti.p2map, ji.p2map)
    np.testing.assert_array_equal(ti.fine_cell_slot(), ji.fine_cell_slot())


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_patch_geom_matches_jax(packs, level):
    ji, ti, _, _ = packs
    jg, tg = JaxPatchGeom(ji, level=level, dtype=np.float64), PatchGeom(ti, level=level)
    np.testing.assert_array_equal(tg.cellvalid_np, jg.cellvalid_np)
    for name in ("detJ", "G", "C", "cell_x0", "dvecs"):
        np.testing.assert_array_equal(getattr(tg, name), np.asarray(getattr(jg, name)))


@pytest.mark.parametrize("which", ["P2", "P1", "level 0", "level 1", "level 2"])
def test_layouts_match_jax(packs, which):
    ji, ti, jp, tp = packs
    if which == "P2":
        lj, lt = jp.lay2, tp.lay2
    elif which == "P1":
        lj, lt = jp.lay1, tp.lay1
    else:
        level = int(which.split()[1])
        lj = jax_p1_layout(ji, level, jnp.float64)
        lt = make_p1_layout(ti, level, torch.float64, "cpu")
    assert lt.planes == lj.planes and lt.win == lj.win and lt.n_flat == lj.n_flat
    for name in LAYOUT_HOST:
        np.testing.assert_array_equal(getattr(lt, name), getattr(lj, name), err_msg=name)
    np.testing.assert_array_equal(lt.weight_t.numpy(), np.asarray(lj.weight_j))


@pytest.mark.parametrize("which", ["lay2", "lay1"])
def test_seam_sum_and_conversions_match_jax(packs, which):
    _, _, jp, tp = packs
    lj, lt = getattr(jp, which), getattr(tp, which)
    rng = np.random.default_rng(1)
    x = rng.standard_normal(lt.n_flat)
    assert _rel(lj.seam_sum(jnp.asarray(x)), lt.seam_sum(torch.as_tensor(x).clone())) <= 1e-15
    g = rng.standard_normal((lt.n_dofs, 2))
    np.testing.assert_array_equal(lt.to_packed(g).numpy(), np.asarray(lj.to_packed(jnp.asarray(g))))
    xc = torch.as_tensor(_consistent(lj, x))
    np.testing.assert_array_equal(lt.from_packed(xc).numpy(),
                                  np.asarray(lj.from_packed(jnp.asarray(xc.numpy()))))
    y = rng.standard_normal(lt.n_flat)
    dj = float(lj.dot(jnp.asarray(x), jnp.asarray(y)))
    assert float(lt.dot(torch.as_tensor(x), torch.as_tensor(y))) == pytest.approx(dj, rel=1e-14)


OPERATORS = ["p1_stiffness_apply", "mass_apply_vec", "div_rhs", "pressure_grad_rhs",
             "grad_div_cell", "grad_div_rhs", "grad_phi_rhs", "ema_S", "ema_volume_apply"]


@pytest.mark.parametrize("name", OPERATORS)
def test_packed_operator_matches_jax(packs, name):
    _, _, jp, tp = packs
    X, T, P = _inputs(tp, OPERATORS.index(name))
    J, Tt = jnp.asarray, torch.as_tensor
    s_mu, s_rho = 0.017, 0.6
    if name in ("p1_stiffness_apply", "pressure_grad_rhs"):
        ref, got = getattr(jp, name)(J(P)), getattr(tp, name)(Tt(P))
    elif name == "grad_div_cell":
        gj, gt = jp.grad_div_cell(J(X)), tp.grad_div_cell(Tt(X))
        ref = np.stack([np.stack([np.asarray(gj[d][t]).reshape(-1) for d in range(2)])
                        for t in range(2)])
        got = gt
    elif name == "grad_phi_rhs":
        ref = jp.grad_phi_rhs(J(P), div_part=jp.grad_div_cell(J(X)), mu=0.3)
        got = tp.grad_phi_rhs(Tt(P), div_part=tp.grad_div_cell(Tt(X)), mu=0.3)
    elif name == "ema_S":
        Sj = jp.ema_S(J(T), s_mu, s_rho)
        ref = np.stack([np.stack([np.stack([np.asarray(Sj[t][i][j]).reshape(-1)
                                            for j in range(6)]) for i in range(6)])
                        for t in range(2)])
        got = tp.ema_S(Tt(T), s_mu, s_rho)
    elif name == "ema_volume_apply":
        ref = jp.ema_volume_apply(jp.ema_S(J(T), s_mu, s_rho), J(X), s_mu)
        got = tp.ema_volume_apply(tp.ema_S(Tt(T), s_mu, s_rho), Tt(X), s_mu)
    else:
        ref, got = getattr(jp, name)(J(X)), getattr(tp, name)(Tt(X))
    tol = 1e-10 if name == "ema_volume_apply" else 1e-12
    assert _rel(ref, got) <= tol


@pytest.fixture(scope="module")
def boundaries(packs):
    ji, ti, jp, tp = packs
    jmesh, tmesh = ji.meshes[-1], ti.meshes[-1]
    jV, jQ = JaxVectorFunctionSpace(jmesh, 2), JaxFunctionSpace(jmesh, 1)
    tV, tQ = VectorFunctionSpace(tmesh, 2), FunctionSpace(tmesh, 1)
    jg = jax_geometry(jmesh)
    return (JaxPackedBoundary(JaxBoundaryTab(jV, rule_degree=6), jp.lay2, jg),
            JaxPackedBoundary(JaxBoundaryTab(jQ, rule_degree=6), jp.lay1, jg),
            PackedBoundary(BoundaryTab(tV, rule_degree=6), tp.lay2),
            PackedBoundary(BoundaryTab(tQ, rule_degree=6), tp.lay1))


@pytest.mark.parametrize("name", ["values_vec", "grads_vec", "values_scalar",
                                  "integrate_rhs_vec"])
def test_packed_boundary_matches_jax(packs, boundaries, name):
    _, _, jp, tp = packs
    jbv, jbq, tbv, tbq = boundaries
    np.testing.assert_array_equal(tbv.cell_dofs.numpy(), np.asarray(jbv.cell_dofs))
    X, _, P = _inputs(tp, 20)
    X = np.concatenate([_consistent(jp.lay2, X[: tp.n2]), _consistent(jp.lay2, X[tp.n2:])])
    if name == "values_scalar":
        ref, got = jbq.values_scalar(jnp.asarray(P)), tbq.values_scalar(torch.as_tensor(P))
    elif name == "integrate_rhs_vec":
        val = np.random.default_rng(21).standard_normal(tuple(tbv.wl.shape) + (2,))
        ref = jbv.integrate_rhs_vec(jnp.asarray(val))
        got = tbv.integrate_rhs_vec(torch.as_tensor(val))
    else:
        ref, got = getattr(jbv, name)(jnp.asarray(X)), getattr(tbv, name)(torch.as_tensor(X))
    assert _rel(ref, got) <= 1e-12


@pytest.fixture(scope="module", params=["dirichlet", "neumann"])
def hierarchies(packs, request):
    """JAX's and the port's PackedPatchP1Hierarchy on the fixture mesh, the
    Dirichlet one pinning the outlet x = 0.6 (as the Karman problem does),
    with JAX's lambda_max carried across."""
    ji, ti, jp, tp = packs
    mask = None
    if request.param == "dirichlet":
        Q = FunctionSpace(ti.meshes[-1], 1)
        g = np.zeros(Q.n_dofs)
        g[Q.boundary_dofs(lambda x: x[:, 0] > 0.6 - 1e-12)] = 1.0
        mask = np.asarray(jp.lay1.to_packed(jnp.asarray(g))) + (1.0 - np.asarray(jp.lay1.valid_j))
    jh = JaxHierarchy(ji, bc_mask=None if mask is None else jnp.asarray(mask))
    th = PackedPatchP1Hierarchy(ti, bc_mask=None if mask is None else torch.as_tensor(mask))
    interop.load_hierarchy_lmax(th, [float(L.lmax) for L in jh.levels])
    return jp, jh, th


def test_level_stiffness_matches_jax(hierarchies):
    jp, jh, th = hierarchies
    rng = np.random.default_rng(30)
    for Lj, Lt in zip(jh.levels, th.levels):
        p = rng.standard_normal(Lt.lay.n_flat)
        assert _rel(Lj.kern.stiffness_apply(jnp.asarray(p)),
                    Lt.kern.stiffness_apply(torch.as_tensor(p))) <= 1e-12
        assert _rel(Lj.K(jnp.asarray(p)), Lt.K(torch.as_tensor(p))) <= 1e-12
        assert _rel(Lj.diag, Lt.diag) <= 1e-15


def test_transfers_match_jax_and_are_adjoint(hierarchies):
    _, jh, th = hierarchies
    rng = np.random.default_rng(31)
    for l in range(th.nlevels - 1):
        layc, layf = th.levels[l].lay, th.levels[l + 1].lay
        xc = rng.standard_normal(layc.n_flat)
        rf = rng.standard_normal(layf.n_flat)
        assert _rel(jh.prolong(l, jnp.asarray(xc)), th.prolong(l, torch.as_tensor(xc))) <= 1e-15
        assert _rel(jh.restrict(l, jnp.asarray(rf)), th.restrict(l, torch.as_tensor(rf))) <= 1e-15
        # the adjoint identity, on consistent vectors of the two levels
        xc = layc.to_packed(rng.standard_normal(layc.n_dofs))
        rf = layf.to_packed(rng.standard_normal(layf.n_dofs))
        lhs = float(layc.dot(th.restrict(l, rf), xc))
        rhs = float(layf.dot(rf, th.prolong(l, xc)))
        assert lhs == pytest.approx(rhs, rel=1e-13)


def test_v_cycle_matches_jax(hierarchies):
    jp, jh, th = hierarchies
    b = np.random.default_rng(32).standard_normal(jp.lay1.n_flat)
    b = _consistent(jp.lay1, b * np.asarray(jp.lay1.weight_j))
    if not th.neumann:
        b = b * (1.0 - th.levels[-1].mask.numpy())
    assert th.levels[-1].lmax == float(jh.levels[-1].lmax)
    assert _rel(jh.v_cycle(jnp.asarray(b)), th.v_cycle(torch.as_tensor(b))) <= 1e-10


def test_new_forms_match_jax(packs):
    # the forms this slice adds to the port: ref_p1_integrals (read by
    # PackedPatch), sym_grad_apply and pressure_grad_rhs
    from flow_tpu.fem import forms as jax_forms
    from flow_tpu_torch.fem import forms
    from flow_tpu_torch.fem.assembly import geometry_on

    ji, ti, _, _ = packs
    for degree in (1, 2):
        np.testing.assert_allclose(forms.ref_p1_integrals(degree, 2),
                                   jax_forms.ref_p1_integrals(degree, 2), rtol=1e-15)
    jm, tm = ji.meshes[-1], ti.meshes[-1]
    jV, jQ = JaxVectorFunctionSpace(jm, 2), JaxFunctionSpace(jm, 1)
    tV, tQ = VectorFunctionSpace(tm, 2), FunctionSpace(tm, 1)
    rng = np.random.default_rng(40)
    U, P = rng.standard_normal((tV.n_dofs, 2)), rng.standard_normal(tQ.n_dofs)
    jg, tg = jax_geometry(jm), geometry_on(tm, torch.float64, "cpu")
    assert _rel(jax_forms.sym_grad_apply(jV, jg, jnp.asarray(U), 0.7),
                forms.sym_grad_apply(tV, tg, torch.as_tensor(U), 0.7)) <= 1e-12
    assert _rel(jax_forms.pressure_grad_rhs(jV, jQ, jg, jnp.asarray(P)),
                forms.pressure_grad_rhs(tV, tQ, tg, torch.as_tensor(P))) <= 1e-12


def test_packed_operators_match_the_global_forms(packs):
    # tests/test_patchfast.py's check of the packed operators against the
    # global einsum forms, in the port
    from flow_tpu_torch.fem import assembly, forms

    _, ti, _, tp = packs
    fine = ti.meshes[-1]
    V, Q = VectorFunctionSpace(fine, 2), FunctionSpace(fine, 1)
    geom = assembly.geometry_on(fine, torch.float64, "cpu")
    rng = np.random.default_rng(41)
    U, T = (torch.as_tensor(rng.standard_normal((V.n_dofs, 2))) for _ in range(2))
    p = torch.as_tensor(rng.standard_normal(Q.n_dofs))
    lay1, lay2 = tp.lay1, tp.lay2

    def pack2(X):
        return torch.cat([lay2.to_packed(X[:, 0]), lay2.to_packed(X[:, 1])])

    def unpack2(Y):
        a, b = tp.comps(Y)
        return torch.stack([lay2.from_packed(a), lay2.from_packed(b)], -1)

    Uf, Tf, Pf = pack2(U), pack2(T), lay1.to_packed(p)
    s_mu, s_rho = 0.017, 0.6
    pairs = [
        (assembly.stiffness_apply(Q, geom, p), lay1.from_packed(tp.p1_stiffness_apply(Pf))),
        (assembly.mass_apply(V, geom, U), unpack2(tp.mass_apply_vec(Uf))),
        (forms.div_rhs(V, Q, geom, U), lay1.from_packed(tp.div_rhs(Uf))),
        (forms.pressure_grad_rhs(V, Q, geom, p), unpack2(tp.pressure_grad_rhs(Pf))),
        (forms.grad_div_ustar_rhs(V, Q, geom, U), lay1.from_packed(tp.grad_div_rhs(Uf))),
    ]
    for ref, got in pairs:
        assert _rel(ref.numpy(), got) <= 1e-12
    ref = (assembly.mass_apply(V, geom, U) + s_mu * forms.sym_grad_apply(V, geom, U, 1.0)
           + s_rho * V.dof_sum(forms.skew_convection_lagged_loc(V, geom, V.gather(T),
                                                                V.gather(U))))
    got = unpack2(tp.ema_volume_apply(tp.ema_S(Tf, s_mu, s_rho), Uf, s_mu))
    assert _rel(ref.numpy(), got) <= 1e-10
