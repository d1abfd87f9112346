# The 3-D foundation of the port's window route against the JAX package on
# box_mesh tet cavities, float64 on the CPU unless stated:
# - BoundaryFaceTab (the 3-D facet tables) against the JAX package's on the
#   3x3x3 box: tables and host points to 1e-12, values, gradients and
#   integrals to 1e-12 relative (another summation order);
# - the forms of the momentum residual and the pressure right-hand sides in
#   3-D against JAX's, to 1e-12 relative;
# - the window layouts of tet spaces equal the JAX package's exactly;
# - the plain K3 3-D (lagged and Newton) against the einsum and
#   jax.linearize references of tests/test_winmom.py on the 2x2x2 box, at
#   the JAX package's tolerance (rtol 3e-5, atol 5e-6: the kernel computes
#   in float32 inside, as in JAX);
# - the plain K4b 3-D against JAX assembly.stiffness_apply on the 4x4x4
#   and 6x6x6 boxes (rtol 3e-5, float32 inside).
# The CUDA kernels themselves are held against these plain versions on the
# card (tests/test_torch_window_cuda.py, chip_smoke.py).
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flow_tpu.attic.window import build_window_layout as jax_layout
from flow_tpu.fem import assembly as jax_assembly
from flow_tpu.fem import forms as jax_forms
from flow_tpu.fem.spaces import FunctionSpace as JaxFunctionSpace
from flow_tpu.fem.spaces import VectorFunctionSpace as JaxVectorSpace
from flow_tpu.mesh3d import box_mesh as jax_box_mesh
from flow_tpu_torch.attic.window import build_scatter_lists, build_window_layout
from flow_tpu_torch.attic.winkernel import WindowStiffnessOperator
from flow_tpu_torch.attic.winmom import WindowLaggedMomentum
from flow_tpu_torch.fem import assembly, forms
from flow_tpu_torch.fem.spaces import FunctionSpace, VectorFunctionSpace
from flow_tpu_torch.mesh3d import box_mesh

torch.set_num_threads(1)

F64_RTOL = 1e-12  # float64: only the summation order differs
J, Tt = jnp.asarray, torch.as_tensor


def _pair(n):
    jm = jax_box_mesh((0, 0, 0), (1, 1, 1), n, n, n)
    tm = box_mesh((0, 0, 0), (1, 1, 1), n, n, n, dtype=torch.float64, device="cpu")
    return ((JaxVectorSpace(jm, 2, n_components=3), JaxFunctionSpace(jm, 1)),
            (VectorFunctionSpace(tm, 2, n_components=3), FunctionSpace(tm, 1)))


@pytest.fixture(scope="module")
def box3():
    return _pair(3)


def _close(a, b, rtol=F64_RTOL, atol=1e-12):
    b = np.asarray(b)
    np.testing.assert_allclose(a.numpy() if isinstance(a, torch.Tensor) else a, b,
                               rtol=rtol, atol=atol * max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("space", ["V", "Q"])
def test_boundary_face_tab_matches_jax(box3, space):
    (jV, jQ), (tV, tQ) = box3
    js, ts = (jV, tV) if space == "V" else (jQ, tQ)
    jbt = jax_assembly.BoundaryFaceTab(js, rule_degree=6)
    tbt = assembly.BoundaryFaceTab(ts, rule_degree=6)
    assert tbt.nq1 == jbt.nq1 == 12
    for name in ("phi", "dphi", "wl", "normals"):
        _close(getattr(tbt, name), getattr(jbt, name), atol=0)
    np.testing.assert_array_equal(tbt.cell_dofs_np, np.asarray(jbt.cell_dofs))
    _close(tbt.x_np, jbt.x_np, atol=0)
    # the faces tile the unit cube's surface: area 6, outward normals
    assert float(tbt.wl.sum()) == pytest.approx(6.0, rel=1e-12)
    assert float(torch.einsum("bq,bd,bqd->", tbt.wl, tbt.normals,
                              torch.as_tensor(tbt.x_np))) == pytest.approx(3.0, rel=1e-12)
    rng = np.random.default_rng(8)
    ncomp = 3 if space == "V" else 1
    U = rng.standard_normal((ts.n_dofs, ncomp) if ncomp > 1 else ts.n_dofs)
    jg = jax_assembly.geometry(js.mesh)
    _close(tbt.values(Tt(U)), jbt.values(J(U)))
    _close(tbt.grads(Tt(U)), jbt.grads(J(U), jg), rtol=1e-11, atol=1e-11)
    val = rng.standard_normal((tbt.wl.shape[0], tbt.nq1) + ((3,) if ncomp > 1 else ()))
    _close(tbt.integrate_rhs(Tt(val)), jbt.integrate_rhs(J(val)), atol=1e-15)
    sval = val if val.ndim == 2 else val[..., 0]
    assert float(tbt.integrate_scalar(Tt(sval))) == pytest.approx(
        float(jbt.integrate_scalar(J(sval))), rel=F64_RTOL)
    # renumbered dofs: a permuted copy reads the permuted field
    perm = rng.permutation(ts.n_dofs)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(ts.n_dofs)
    _close(tbt.permuted(inv).values(Tt(U[perm])), jbt.values(J(U)))


def test_forms_3d_match_jax(box3):
    (jV, jQ), (tV, tQ) = box3
    jg = jax_assembly.geometry(jV.mesh)
    g = assembly.geometry_on(tV.mesh, torch.float64, "cpu")
    rng = np.random.default_rng(9)
    U, T = (rng.standard_normal((tV.n_dofs, 3)) for _ in range(2))
    P = rng.standard_normal(tQ.n_dofs)
    Ul, Tl, Pl = tV.gather(Tt(U)), tV.gather(Tt(T)), tQ.gather(Tt(P))
    jUl, jTl, jPl = jV.gather(J(U)), jV.gather(J(T)), jQ.gather(J(P))
    _close(forms.skew_convection_lagged_loc(tV, g, Tl, Ul),
           jax_forms.skew_convection_lagged_loc(jV, jg, jTl, jUl, rule_degree=5))
    _close(forms.sym_grad_loc(tV, g, Ul, 0.3), jax_forms.sym_grad_loc(jV, jg, jUl, 0.3))
    _close(forms.pressure_grad_loc(tV, tQ, g, Pl),
           jax_forms.pressure_grad_loc(jV, jQ, jg, jPl))
    _close(forms.mass_loc(tV, g, Ul), jax_forms.mass_loc(jV, jg, jUl))
    _close(forms.div_rhs(tV, tQ, g, Tt(U)), jax_forms.div_rhs(jV, jQ, jg, J(U)))
    _close(forms.grad_div_ustar_rhs(tV, tQ, g, Tt(U)),
           jax_forms.grad_div_ustar_rhs(jV, jQ, jg, J(U)))
    dp = 0.3 * forms.grad_div_ustar(tV, g, Tt(U))
    jdp = 0.3 * jax_forms.grad_div_ustar(jV, jg, J(U))
    _close(dp, jdp)
    _close(forms.grad_phi_rhs(tV, tQ, g, Tt(P), div_part=dp, rule_degree=4),
           jax_forms.grad_phi_rhs(jV, jQ, jg, J(P), div_part=jdp, rule_degree=4))


@pytest.mark.parametrize("space", ["V", "Q"])
@pytest.mark.parametrize("S", [None, 128])
def test_tet_window_layout_equals_jax(box3, space, S):
    (jV, jQ), (tV, tQ) = box3
    js, ts = (jV, tV) if space == "V" else (jQ, tQ)
    jw, tw = jax_layout(js, S=S), build_window_layout(ts, S=S)
    assert (tw.S, tw.W, tw.nb, tw.C) == (jw.S, jw.W, jw.nb, jw.C)
    for name in ("perm", "inv", "cells", "valid", "lidx"):
        np.testing.assert_array_equal(getattr(tw, name), np.asarray(getattr(jw, name)),
                                      err_msg=name)
    # every real (cell, local dof) in exactly one scatter list
    rowptr, ent = build_scatter_lists(tw)
    nl = tw.lidx.shape[2]
    assert rowptr[:, -1].tolist() == (tw.valid.sum(axis=1) * nl).astype(int).tolist()
    for b in range(tw.nb):
        used = ent[b, :rowptr[b, -1]]
        assert len(np.unique(used)) == len(used)


@pytest.fixture(scope="module")
def box2():
    (jV, _), (tV, _) = _pair(2)
    return jV, tV


def _vol_res(V, geom, mass_w, s_rho, s_mu, T=None):
    # tests/test_winmom.py's references: the einsum volume residual, with
    # the transport frozen at T (lagged) or the full skew nonlinearity
    def res(u):
        Uloc = V.gather(u)
        loc = mass_w * jax_forms.mass_loc(V, geom, Uloc)
        if T is None:
            loc = loc + s_rho * jax_forms.skew_convection_combined_loc(
                V, geom, Uloc, rule_degree=5)
        else:
            loc = loc + s_rho * jax_forms.skew_convection_lagged_loc(
                V, geom, V.gather(T), Uloc, rule_degree=5)
        loc = loc + jax_forms.sym_grad_loc(V, geom, Uloc, s_mu)
        return V.dof_sum(loc)
    return res


@pytest.mark.parametrize("S", [128, None])
def test_window_momentum_3d_plain_matches_jax_references(box2, S):
    jV, tV = box2
    geom = jax_assembly.geometry(jV.mesh)
    op = WindowLaggedMomentum(tV, S=S, device="cpu")
    assert op.dim == 3 and op.nq == 27 and op.tabs.numel() == 2107
    rng = np.random.default_rng(7)
    x, v = (rng.standard_normal((tV.n_dofs, 3)) for _ in range(2))
    w = (1.0, 0.21, 0.017)
    perm, inv = op.perm.numpy(), op.inv.numpy()
    # Newton: the tangent of the volume residual about x
    _, Jv = jax.linearize(_vol_res(jV, geom, *w), J(x))
    Tq, Uq, Gu = op.state_qp(Tt(x))
    got = op.apply_perm_rows(Tt(v[perm]), Tq, *w, Uq, Gu)[inv]
    np.testing.assert_allclose(got.numpy(), np.asarray(Jv(J(v))), rtol=3e-5, atol=5e-6)
    # lagged: transport x, no reaction term
    ref = _vol_res(jV, geom, *w, T=J(x))(J(v))
    got = op.apply(Tt(v), Tq, *w)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=3e-5, atol=5e-6)
    for t in (Tq, Gu):
        assert t.is_contiguous() and t.dtype == torch.float32


@pytest.mark.parametrize("n", [4, 6])  # 6: 343 dofs, three blocks of 128
def test_window_stiffness_3d_plain_matches_jax(n):
    (_, jQ), (_, tQ) = _pair(n)
    op = WindowStiffnessOperator(tQ, S=128, device="cpu")
    assert op.wl.nb == -(-tQ.n_dofs // 128) and op.kref.shape == (36, 4)
    x = np.random.default_rng(3).standard_normal(tQ.n_dofs)
    ref = np.asarray(jax_assembly.stiffness_apply(jQ, jax_assembly.geometry(jQ.mesh), J(x)))
    got = op.apply(Tt(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=3e-5, atol=3e-5 * np.abs(ref).max())
