# FastStepper's patch mode (patches=PatchInfo: fem/patch.PatchLayout,
# PatchSpace and PatchBoundaryTab, navier_stokes/patchctx.PatchNSContext,
# solvers/patch_mg.PatchP1Hierarchy) against the JAX package in float64 on
# the CPU, on KarmanProblem(lcar=0.2, n_refine=2):
# - the layout tables equal JAX's; PatchSpace's window gather, overlap-add
#   dof sum (with the seam sum), weighted dot and layout conversions, and
#   PatchBoundaryTab's values, gradients and facet integrals, against JAX's
#   on the same numpy inputs to 1e-12 relative, and against the port's own
#   global layout;
# - PatchP1Hierarchy.v_cycle against JAX's with its lambda_max carried
#   across (Dirichlet and pure Neumann), to 1e-12;
# - the stepper, 3 steps with the CFL controller from dt0 = 1e-3: bench.py's
#   BENCH_PATCH=1 configuration (lagged, GMRES(32) by sqrt-weight
#   conjugation, PatchP1Hierarchy) and Newton with BiCGStab (the weighted
#   inner product), each against the JAX patch stepper, lambda_max carried
#   across: equal per-step counts, U and P within 1e-8, the state taken and
#   returned in the global layout or kept in the patch layout.
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flow_tpu.fem.patch import PatchBoundaryTab as JaxBoundaryTab
from flow_tpu.fem.patch import PatchSpace as JaxSpace
from flow_tpu.fem.patch import build_patch_info as jax_patch_info
from flow_tpu.fem.assembly import BoundaryTab as JaxBTab, geometry as jax_geometry
from flow_tpu.models.karman import KarmanProblem as JaxProblem
from flow_tpu.navier_stokes.fast import FastStepper as JaxStepper
from flow_tpu.solvers.patch_mg import PatchP1Hierarchy as JaxPatchMG
from flow_tpu_torch import interop
from flow_tpu_torch.fem import assembly
from flow_tpu_torch.fem.assembly import BoundaryTab
from flow_tpu_torch.fem.patch import PatchBoundaryTab, PatchSpace, build_patch_info
from flow_tpu_torch.models.karman import KarmanProblem
from flow_tpu_torch.navier_stokes.fast import FastStepper
from flow_tpu_torch.solvers.patch_mg import PatchP1Hierarchy

torch.set_num_threads(1)

ITERS = ("newton_iters", "linear_iters", "pressure_iters", "correction_iters")
TOL = 1e-8
BENCH = dict(rotational_form=True, convection="lagged", momentum_solver="gmres",
             newton_tol=0.0, newton_rtol=1e-2, newton_maxiter=4, linear_rtol=1e-1,
             pressure_rtol=3e-4, pressure_maxiter=600, correction_rtol=1e-4)
NEWTON = dict(rotational_form=True, newton_tol=0.0,
              newton_rtol=1e-3, newton_maxiter=3, linear_rtol=1e-4, pressure_rtol=1e-4,
              correction_rtol=1e-5)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.fixture(scope="module")
def setup():
    jp = JaxProblem(lcar=0.2, n_refine=2)
    tp = KarmanProblem(lcar=0.2, n_refine=2, dtype=torch.float64, device="cpu")
    ji, ti = jax_patch_info(jp.mesh_hierarchy), build_patch_info(tp.mesh_hierarchy)
    return jp, tp, ji, ti


def _spaces(setup):
    jp, tp, ji, ti = setup
    jV = JaxSpace(ji.layout(2), jp.mesh, 2, n_components=2)
    jQ = JaxSpace(ji.layout(1), jp.mesh, 1)
    tV = PatchSpace(ti.layout(2), tp.mesh, 2, n_components=2, device="cpu")
    tQ = PatchSpace(ti.layout(1), tp.mesh, 1, device="cpu")
    return jV, jQ, tV, tQ


def test_patch_layouts_equal_jax(setup):
    _, _, ji, ti = setup
    for key in ((2, None), (1, None), (1, 1), (1, 0)):
        a, b = ji.layout(*key), ti.layout(*key)
        assert a.planes == b.planes and a.win == b.win, key
        for name in ("L", "weight", "slot_of_dof", "rep_slots", "rep_group", "offsets"):
            np.testing.assert_array_equal(getattr(b, name), getattr(a, name), err_msg=name)


@pytest.mark.parametrize("space", ["V", "Q"])
@pytest.mark.parametrize("op", ["gather", "dof_sum", "seam_sum", "dot", "to_from_patch"])
def test_patch_space_matches_jax(setup, space, op):
    jV, jQ, tV, tQ = _spaces(setup)
    js, ts = (jV, tV) if space == "V" else (jQ, tQ)
    m = (2,) if space == "V" else ()
    rng = np.random.default_rng(5)
    g = rng.standard_normal((ts.n_true_dofs,) + m)
    x = np.asarray(js.to_patch(jnp.asarray(g)))  # replica-consistent
    if op == "gather":
        want, got = js.gather(jnp.asarray(x)), ts.gather(torch.as_tensor(x))
    elif op == "dof_sum":
        ncp = 2 * ts.layout.C * ts.layout.nct ** 2
        loc = rng.standard_normal((ncp, ts.n_local) + m)
        want, got = js.dof_sum(jnp.asarray(loc)), ts.dof_sum(torch.as_tensor(loc))
    elif op == "seam_sum":
        y = rng.standard_normal(x.shape)
        want, got = js.seam_sum(jnp.asarray(y)), ts.seam_sum(torch.as_tensor(y))
    elif op == "dot":
        want = js.dot(jnp.asarray(x), jnp.asarray(x))
        got = ts.dot(torch.as_tensor(x), torch.as_tensor(x))
        assert float(got) == pytest.approx(float((g * g).sum()), rel=1e-13)
    else:
        want, got = js.to_patch(jnp.asarray(g)), ts.to_patch(torch.as_tensor(g))
        np.testing.assert_array_equal(ts.from_patch(got).numpy(), g)
    assert tuple(got.shape) == np.asarray(want).shape
    assert _rel(got, want) <= 1e-12


@pytest.mark.parametrize("op", ["values", "grads", "integrate_rhs"])
def test_patch_boundary_tab_matches_jax(setup, op):
    jp, tp, _, _ = setup
    jV, _, tV, _ = _spaces(setup)
    jb = JaxBoundaryTab(JaxBTab(jp.V, rule_degree=6), jV, jax_geometry(jp.mesh))
    tb = PatchBoundaryTab(BoundaryTab(tp.V, 6, torch.float64, "cpu"), tV)
    rng = np.random.default_rng(6)
    if op == "integrate_rhs":
        val = rng.standard_normal((tb.phi.shape[0], tb.nq1, 2))
        want, got = jb.integrate_rhs(jnp.asarray(val)), tb.integrate_rhs(torch.as_tensor(val))
        # the seam-consistent global facet integral
        gl = BoundaryTab(tp.V, 6, torch.float64, "cpu").integrate_rhs(torch.as_tensor(val))
        assert _rel(tV.from_patch(got), gl) <= 1e-12
    else:
        x = np.asarray(jV.to_patch(jnp.asarray(rng.standard_normal((tp.V.n_dofs, 2)))))
        want = getattr(jb, op)(jnp.asarray(x))
        got = getattr(tb, op)(torch.as_tensor(x))
    assert _rel(got, want) <= 1e-12


def test_patch_operators_match_global_layout(setup):
    """The patch context's stiffness, mass and residual against the global
    layout's (overlap-add and seam sum == the global dof sum)."""
    _, tp, _, ti = setup
    st = FastStepper(tp.V, tp.Q, tp.u_bcs, tp.p_bcs, tp.rho, tp.mu, patches=ti,
                     device="cpu", **BENCH)
    ref = FastStepper(tp.V, tp.Q, tp.u_bcs, tp.p_bcs, tp.rho, tp.mu, device="cpu", **BENCH)
    ctx, V, Q = st.ctx, st.V, st.Q
    rng = np.random.default_rng(7)
    U = torch.as_tensor(rng.standard_normal((tp.V.n_dofs, 2)))
    P = torch.as_tensor(rng.standard_normal(tp.Q.n_dofs))
    T = torch.as_tensor(rng.standard_normal((tp.V.n_dofs, 2)))
    geom = assembly.geometry_on(tp.mesh, torch.float64, "cpu")
    want = assembly.stiffness_apply(tp.Q, geom, P)
    assert _rel(Q.from_patch(assembly.stiffness_apply(Q, ctx.geom, Q.to_patch(P))), want) <= 1e-12
    want = assembly.mass_apply(tp.V, geom, U)
    assert _rel(V.from_patch(assembly.mass_apply(V, ctx.geom, V.to_patch(U))), want) <= 1e-12
    want = ref.ctx.residual(U, T, P, 1.0, 1e-3, 0.02, (0.0, 1.0), transport=T)
    got = ctx.residual(V.to_patch(U), V.to_patch(T), Q.to_patch(P), 1.0, 1e-3, 0.02,
                       (0.0, 1.0), transport=V.to_patch(T))
    assert _rel(V.from_patch(got), want) <= 1e-12
    for name in ("mass_diag_V", "stiff_diag_V"):
        assert _rel(V.from_patch(getattr(ctx, name)), getattr(ref.ctx, name)) <= 1e-12
    assert _rel(Q.from_patch(ctx.stiff_diag_Q), ref.ctx.stiff_diag_Q) <= 1e-12


@pytest.fixture(scope="module")
def jax_bench(setup):
    """The JAX patch stepper of bench.py's BENCH_PATCH=1 configuration and
    its PatchP1Hierarchy, built once."""
    jp, _, ji, _ = setup
    js = JaxStepper(jp.V, jp.Q, jp.u_bcs, jp.p_bcs, jp.rho, jp.mu, patches=ji, **BENCH)
    js.pressure_precond = JaxPatchMG(ji, bc_mask=js.mask_p, smoother_degree=3).v_cycle
    return js


@pytest.mark.parametrize("neumann", [False, True], ids=["dirichlet", "neumann"])
def test_patch_mg_v_cycle_matches_jax(setup, jax_bench, neumann):
    jp, tp, ji, ti = setup
    mask = None if neumann else jax_bench.mask_p
    jh = (JaxPatchMG(ji, bc_mask=None, smoother_degree=3) if neumann
          else jax_bench.pressure_precond.__self__)
    th = PatchP1Hierarchy(ti, bc_mask=None if neumann else torch.as_tensor(np.asarray(mask)),
                          smoother_degree=3, device="cpu", dtype=torch.float64)
    lmax = [float(L.lmax) for L in jh.levels]
    # the power iterations start from other random vectors: their estimates
    # agree to a few percent, and the cycle's bits need JAX's
    assert np.allclose([L.lmax for L in th.levels], lmax, rtol=0.1)
    interop.load_hierarchy_lmax(th, lmax)
    rng = np.random.default_rng(8)
    Qs = th.levels[-1].space
    b = np.asarray(Qs.to_patch(torch.as_tensor(rng.standard_normal(tp.Q.n_dofs))))
    want = jax.jit(jh.v_cycle)(jnp.asarray(b))  # eager JAX takes ~12 s here
    got = th.v_cycle(torch.as_tensor(b))
    assert _rel(got, want) <= 1e-12
    assert float(torch.abs(got * (1.0 - Qs._validf)).max()) == 0.0


CASES = {"bench-patch1": BENCH, "newton-bicgstab": NEWTON}


@pytest.fixture(scope="module")
def jax_runs(setup, jax_bench):
    """The JAX patch stepper's 3-step run of each case, jitted once, both
    on the bench stepper's PatchP1Hierarchy (one mask, one operator set)."""
    jp, _, ji, _ = setup
    args = (jp.V.zeros(), jp.Q.zeros(), jnp.asarray(1e-3))
    lowered = []
    for case, kw in CASES.items():
        js = jax_bench if case == "bench-patch1" else JaxStepper(
            jp.V, jp.Q, jp.u_bcs, jp.p_bcs, jp.rho, jp.mu, patches=ji, **kw)
        js.pressure_precond = jax_bench.pressure_precond
        lowered.append(js._run_jit.lower(*args, n_steps=3))
    # XLA compiles outside the GIL: both programs at once
    with ThreadPoolExecutor(len(lowered)) as pool:
        compiled = list(pool.map(lambda low: low.compile(), lowered))
    out = {}
    for case, run in zip(CASES, compiled):
        o = run(*args)
        out[case] = (np.asarray(o[0]), np.asarray(o[1]),
                     {k: np.asarray(v) for k, v in o[3].items()})
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_patch_stepper_iterate_exact(setup, jax_bench, jax_runs, case):
    """bench.py's BENCH_PATCH=1 stepper (GMRES by sqrt-weight conjugation)
    and Newton with BiCGStab (the weighted inner product) against the JAX
    patch stepper, the JAX PatchP1Hierarchy's lambda_max carried across."""
    jp, tp, ji, ti = setup
    kw = CASES[case]
    ts = FastStepper(tp.V, tp.Q, tp.u_bcs, tp.p_bcs, tp.rho, tp.mu, patches=ti,
                     device="cpu", **kw)
    assert ts.patch and not ts.packed and ts.K_Q is None
    th = PatchP1Hierarchy(ti, bc_mask=ts.mask_p, smoother_degree=3, device="cpu",
                          dtype=torch.float64)
    Uj, Pj, telj = jax_runs[case]
    interop.load_hierarchy_lmax(th, [float(L.lmax) for L in
                                     jax_bench.pressure_precond.__self__.levels])
    ts.pressure_precond = th.v_cycle
    # the global layout in and out; and the patch layout kept throughout
    outt = ts.run(*ts.zeros(), 1e-3, n_steps=3)
    outp = ts.run(ts.V.zeros(), ts.Q.zeros(), 1e-3, n_steps=3)
    for key in ITERS:
        assert outt[3][key].tolist() == telj[key].tolist(), key
        assert outp[3][key].tolist() == outt[3][key].tolist(), key
    np.testing.assert_allclose(outt[3]["dt"].numpy(), telj["dt"], rtol=1e-12)
    assert outt[0].shape == (tp.V.n_dofs, 2) and outp[0].shape == (ts.V.n_dofs, 2)
    np.testing.assert_allclose(outt[0].numpy(), Uj, rtol=0, atol=TOL)
    np.testing.assert_allclose(outt[1].numpy(), Pj, rtol=0, atol=TOL)
    np.testing.assert_array_equal(ts.V.from_patch(outp[0]).numpy(), outt[0].numpy())
    assert np.abs(outt[0].numpy()).max() > 1e-3
