# The heat layer of flow_tpu_torch against the JAX package on the CPU in
# float64: SUPG's tau (2-D and 3-D, 1e-5 relative a point: the xi
# formula's cancellation), the Heat operator's element matrices,
# load vector and alpha*M + beta*F with and without SUPG (1e-12 of the
# largest entry), its three solve paths (direct, Jacobi-GMRES and the
# shifted-multigrid GMRES with the JAX package's lambda_max carried across:
# equal GMRES iterations, the solution within 1e-10), a V-cycle of the
# shifted hierarchy (1e-12), the parabolic steppers, projection and the
# norms, the message scopes and the adaptive time controller. Inputs are
# made from numpy with a seed.
import importlib
import logging

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import flow_tpu
from flow_tpu import heat as jheat
from flow_tpu import parabolic as jpar
from flow_tpu import stabilization as jstab
from flow_tpu.fem.interpolate import errornorm as jerrornorm
from flow_tpu.fem.interpolate import interpolate as jinterpolate
from flow_tpu.fem.interpolate import norm as jnorm
from flow_tpu.fem.interpolate import project as jproject
from flow_tpu.fem.spaces import Function as JFunction
from flow_tpu.fem.spaces import FunctionSpace as JFS
from flow_tpu.mesh import refine_uniform as jrefine
from flow_tpu.mesh import unit_square_mesh as jsquare
from flow_tpu.mesh3d import box_mesh as jbox

import flow_tpu_torch
from flow_tpu_torch import heat as theat
from flow_tpu_torch import interop, message
from flow_tpu_torch import parabolic as tpar
from flow_tpu_torch import stabilization as tstab
from flow_tpu_torch.fem.bc import DirichletBC as TBC
from flow_tpu_torch.fem.spaces import FunctionSpace as TFS
from flow_tpu_torch.mesh import refine_uniform as trefine
from flow_tpu_torch.mesh import unit_square_mesh as tsquare
from flow_tpu_torch.mesh3d import box_mesh as tbox
from flow_tpu_torch.utils.timestep import AdaptiveTimeController, step_with_retry

# the module: flow_tpu_torch.fem binds the name `interpolate` to the
# function, as flow_tpu.fem does
tinterp = importlib.import_module("flow_tpu_torch.fem.interpolate")

torch.set_num_threads(1)
CPU = torch.device("cpu")
F64 = torch.float64


def _close(a, b, tol, what=""):
    a = np.asarray(a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a)
    b = np.asarray(b)
    scale = max(np.abs(b).max(), 1e-300)
    err = np.abs(a - b).max()
    assert err <= tol * scale, f"{what}: max err {err:.3e} > {tol:g} x {scale:.3e}"


def _pair(n=4, n_refine=1):
    """JAX and port (coarse + refine_uniform^n_refine) unit-square chains."""
    jm, tm = [jsquare(n)], [tsquare(n, dtype=F64, device="cpu")]
    for _ in range(n_refine):
        jm.append(jrefine(jm[-1]))
        tm.append(trefine(tm[-1]))
    return jm, tm


def _hot(x):
    return x[:, 0] < 1e-9


def _cool(x):
    return x[:, 0] > 1.0 - 1e-9


def _heat_pair(supg, kappa=0.01, n=4, n_refine=1, hierarchy=False, seed=0,
               degree=2):
    jm, tm = _pair(n, n_refine)
    jV, tV = JFS(jm[-1], degree), TFS(tm[-1], degree)
    jW, tW = JFS(jm[-1], 2, 2), TFS(tm[-1], 2, 2)
    rng = np.random.default_rng(seed)
    conv = rng.standard_normal((jW.n_dofs, 2))
    src = rng.standard_normal(jV.n_dofs)
    ops = []
    for FS_, W, V, BC, F, fn, meshes, xp in (
        (JFS, jW, jV, flow_tpu.DirichletBC, JFunction, None, jm, "jax"),
        (TFS, tW, tV, TBC, flow_tpu_torch.Function, None, tm, "torch"),
    ):
        if xp == "jax":
            cf, sf = F(W, jnp.asarray(conv)), F(V, jnp.asarray(src))
            mod = jheat
        else:
            cf = interop.function_to_torch(W, conv)
            sf = interop.function_to_torch(V, src)
            mod = theat
        bcs = [BC(V, 1.0, _hot), BC(V, 0.0, _cool)]
        ops.append(mod.Heat(V, cf, kappa, 1.0, 1.0, bcs, sf,
                            supg_stabilization=supg,
                            mesh_hierarchy=meshes if hierarchy else None))
    return ops, rng


@pytest.mark.parametrize("dim", [2, 3])
def test_supg_tau_matches_jax(dim):
    rng = np.random.default_rng(1)
    if dim == 2:
        jm, tm = jsquare(5), tsquare(5, dtype=F64, device="cpu")
    else:
        jm = jbox((0, 0, 0), (1, 1, 1), 2, 2, 2)
        tm = tbox((0, 0, 0), (1, 1, 1), 2, 2, 2, dtype=F64, device="cpu")
    b = rng.standard_normal((jm.n_cells, 7, dim))
    b[0, :3] = 0.0  # the bnorm < 1e-10 branch
    b[1] *= 1e-4  # the Taylor branch
    for eps in (1e-3, 1.0):
        jt = jstab.supg_tau(jm, jnp.asarray(b), eps, 2)
        tt = tstab.supg_tau(tm, torch.as_tensor(b), eps, 2)
        # relative 1e-5 a point: xi = (1/tanh(pe) - 1/pe)/pe subtracts two
        # ~1/pe terms to leave ~pe/3, so one last-bit difference of XLA's
        # and torch's tanh or division is ~3 eps/pe^2 of xi, 3.3e-6 just
        # above the Taylor switch at pe = 1e-5
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-5, atol=0,
                                   err_msg=f"tau dim={dim} eps={eps}")
    assert tstab.supg(tm, None, 1.0, 2)(torch.as_tensor(b)).shape == (jm.n_cells, 7)
    with pytest.raises(RuntimeError):
        tstab.check_tau(torch.full((2, 2), 2e3))


@pytest.mark.parametrize("supg", [False, True])
def test_heat_operators_match_jax(supg):
    (jop, top), rng = _heat_pair(supg)
    _close(top.M_loc, jop.M_loc, 1e-12, "M_loc")
    _close(top.A_loc, jop.A_loc, 1e-12, "A_loc")
    _close(top.b_vec, jop.b_vec, 1e-12, "b")
    u = rng.standard_normal(jop.V.n_dofs)
    for alpha, beta in ((2.0, 0.0), (3.0, -1.0), (0.5, 0.5)):
        je = jop.eval_alpha_M_beta_F(alpha, beta, jnp.asarray(u), 0.0)
        te = top.eval_alpha_M_beta_F(alpha, beta, torch.as_tensor(u), 0.0)
        _close(te, je, 1e-12, f"eval {alpha} {beta}")


def _jax_gmres_counter(monkeypatch):
    """Record the iterations of the JAX Heat's GMRES calls."""
    import flow_tpu.solvers.krylov as jk

    calls = []

    class _K:
        @staticmethod
        def gmres(*a, **k):
            x, info = jk.gmres(*a, **k)
            calls.append(int(info.iters))
            return x, info

    monkeypatch.setattr(jheat, "krylov", _K)
    return calls


@pytest.mark.parametrize("solver,supg", [("direct", False), ("gmres", False),
                                          ("mg", False), ("mg", True)])
def test_heat_solves_match_jax(monkeypatch, solver, supg):
    (jop, top), rng = _heat_pair(supg, n=3, n_refine=2, hierarchy=True)
    calls = _jax_gmres_counter(monkeypatch)
    b = rng.standard_normal(jop.V.n_dofs)
    if solver == "mg":
        jh = jop._mg_hierarchy()
        interop.load_hierarchy_lmax(top._mg_hierarchy(), [L.lmax for L in jh.levels])
    ju = jop.solve_alpha_M_beta_F(20.0, -1.0, jnp.asarray(b), 0.0, solver=solver)
    tu = top.solve_alpha_M_beta_F(20.0, -1.0, torch.as_tensor(b), 0.0, solver=solver)
    _close(tu.vector, ju.vector, 1e-10, solver)
    if solver == "direct":
        assert top.last_solve["solver"] == "dense"
    else:
        assert top.last_solve["solver"] == solver
        assert calls == [top.last_solve["iters"]] and calls[0] > 1, (calls, top.last_solve)


def test_heat_splu_above_the_dense_threshold(monkeypatch):
    (jop, top), rng = _heat_pair(False, n=3, n_refine=1)
    monkeypatch.setattr(jheat, "DENSE_THRESHOLD", 10)
    monkeypatch.setattr(theat, "DENSE_THRESHOLD", 10)
    b = rng.standard_normal(jop.V.n_dofs)
    ju = jop.solve_alpha_M_beta_F(5.0, -1.0, jnp.asarray(b), 0.0)
    tu = top.solve_alpha_M_beta_F(5.0, -1.0, torch.as_tensor(b), 0.0)
    assert top.last_solve["solver"] == "splu"
    _close(tu.vector, ju.vector, 1e-12, "splu")


def test_shifted_vcycle_matches_jax():
    from flow_tpu.solvers.shifted_mg import ShiftedP1Hierarchy as JH
    from flow_tpu_torch.solvers.shifted_mg import ShiftedP1Hierarchy as TH

    jm, tm = _pair(3, 3)
    rng = np.random.default_rng(2)
    n = jm[-1].n_points
    mask = np.zeros(n)
    mask[JFS(jm[-1], 1).boundary_dofs(lambda x: x[:, 1] < 1e-9)] = 1.0
    extras = [rng.uniform(0.0, 0.5, m.n_cells) for m in jm]
    jh = JH(jm, bc_mask=jnp.asarray(mask), kappa=0.1, extra_diff=extras)
    th = TH(tm, bc_mask=mask, kappa=0.1, extra_diff=extras)
    interop.load_hierarchy_lmax(th, [L.lmax for L in jh.levels])
    b = rng.standard_normal(n)
    for shift, c in ((10.0, 1.0), (0.0, 2.0), (3.0, 0.0)):
        jx = jh.v_cycle(jnp.asarray(b), shift, c)
        tx = th.v_cycle(torch.as_tensor(b), shift, c)
        _close(tx, jx, 1e-12, f"v_cycle shift={shift} c={c}")
    # the restriction against the JAX scatter-add
    r = rng.standard_normal(n)
    _close(th.restrict(2, torch.as_tensor(r)), jh.restrict(2, jnp.asarray(r)),
           1e-14, "restrict")


@pytest.mark.parametrize("name", ["ImplicitEuler", "ExplicitEuler", "Trapezoidal"])
def test_parabolic_steppers_match_jax(name):
    # P1: the vertex-rule mass of P2 is singular on the edge dofs, so the
    # explicit step (beta = 0) needs P1, in the JAX package too
    (jop, top), rng = _heat_pair(False, n=3, n_refine=1, degree=1)
    u0 = rng.standard_normal(jop.V.n_dofs)
    ju = getattr(jpar, name)(jop).step(jnp.asarray(u0), 0.0, 0.05)
    tu = getattr(tpar, name)(top).step(torch.as_tensor(u0), 0.0, 0.05)
    _close(tu.vector, ju.vector, 1e-11, name)


def test_project_norms_match_jax():
    jm, tm = jsquare(6), tsquare(6, dtype=F64, device="cpu")

    def f(x):
        return x[..., 0] ** 2 + 0.5 * x[..., 1]

    for deg, val in ((1, f), (2, f), (2, (f, 1.5))):
        ncomp = 2 if isinstance(val, tuple) else 1
        jV = JFS(jm, deg, ncomp)
        tV = TFS(tm, deg, ncomp)
        jp = jproject(val, jV)
        tp = tinterp.project(val, tV)
        _close(tp.vector, jp.vector, 1e-12, f"project P{deg} x{ncomp}")
        assert tinterp.norm(tp) == pytest.approx(jnorm(jp), rel=1e-13)
        assert tinterp.norm(tp.vector, "linf") == pytest.approx(
            jnorm(jp.vector, "linf"), rel=1e-13)
        # a JAX Function's vector into the port and back
        np.testing.assert_array_equal(
            interop.function_to_numpy(interop.function_to_torch(tV, jp.vector)),
            np.asarray(jp.vector))
        ti = tinterp.interpolate(val, tV)
        _close(ti.vector, jinterpolate(val, jV).vector, 1e-15, "interpolate")
        # a Function projected onto another space
        _close(tinterp.project(tp, TFS(tm, 1, ncomp)).vector,
               jproject(jp, JFS(jm, 1, ncomp)).vector, 1e-12, "project(Function)")
        if ncomp == 1:
            assert tinterp.errornorm(f, tp) == pytest.approx(
                jerrornorm(f, jp), rel=1e-9, abs=1e-15)


def test_assembly_and_forms_gaps_match_jax():
    """lumped_mass_diag, mass_local, integral, the coeff= diagonals, and the
    skew convection and body force of the public schemes' residual."""
    from flow_tpu.fem import assembly as ja
    from flow_tpu.fem import forms as jforms
    from flow_tpu_torch.fem import assembly as ta
    from flow_tpu_torch.fem import forms as tforms

    jm, tm = jsquare(4), tsquare(4, dtype=F64, device="cpu")
    jg, tg = ja.geometry(jm), ta.geometry(tm)
    rng = np.random.default_rng(3)
    kc = rng.uniform(0.5, 2.0, jm.n_cells)
    for deg in (1, 2):
        jV, tV = JFS(jm, deg), TFS(tm, deg)
        _close(ta.lumped_mass_diag(tV, tg), ja.lumped_mass_diag(jV, jg), 1e-14, "lumped")
        _close(ta.mass_local(tV, tg, kc), ja.mass_local(jV, jg, jnp.asarray(kc)),
               1e-14, "mass_local")
        _close(ta.mass_diag(tV, tg, kc), ja.mass_diag(jV, jg, jnp.asarray(kc)),
               1e-14, "mass_diag")
        _close(ta.stiffness_diag(tV, tg, kc), ja.stiffness_diag(jV, jg, jnp.asarray(kc)),
               1e-14, "stiffness_diag")
        u = rng.standard_normal(jV.n_dofs)
        tgd = ta.geometry_on(tm, F64, "cpu")
        jint = float(ja.integral(jV, jg, jnp.asarray(u)))
        assert float(ta.integral(tV, tgd, torch.as_tensor(u))) == pytest.approx(jint, rel=1e-13)
        assert ta.integral(tV, tg, u) == pytest.approx(jint, rel=1e-13)
    jW, tW = JFS(jm, 2, 2), TFS(tm, 2, 2)
    W = rng.standard_normal((jW.n_dofs, 2))
    tgd = ta.geometry_on(tm, F64, "cpu")
    _close(tforms.skew_convection_combined_loc(tW, tgd, tW.gather(torch.as_tensor(W))),
           jforms.skew_convection_combined_loc(jW, jg, jW.gather(jnp.asarray(W))),
           1e-13, "skew convection")
    Fq = rng.standard_normal((jm.n_cells, 12, 2))
    _close(tforms.body_force_loc(tW, tgd, torch.as_tensor(Fq)),
           jforms.body_force_loc(jW, jg, jnp.asarray(Fq)), 1e-13, "body force")


def test_function_to_torch_checks_the_shape():
    tV = TFS(tsquare(2, dtype=F64, device="cpu"), 2, 2)
    with pytest.raises(ValueError):
        interop.function_to_torch(tV, np.zeros(tV.n_dofs))


def test_message_scopes_and_time_controller(caplog):
    message.set_log_level(logging.INFO)
    try:
        with caplog.at_level(logging.INFO, logger="flow_tpu_torch"):
            with message.Message("outer"):
                message.info("inside %d", 3)
                with message.Message("inner"):
                    pass
    finally:
        message.set_log_level(logging.WARNING)
    lines = [r.getMessage() for r in caplog.records]
    assert lines[0] == "outer" and lines[1] == "  inside 3" and lines[2] == "  inner"
    assert lines[3].startswith("    inner done [") and lines[-1].startswith("  outer done [")

    from flow_tpu.utils.timestep import AdaptiveTimeController as JC

    for args in ((1e-2,), (1e-2, 0.05, 0.3, 1.5)):
        jc, tc = JC(*args), AdaptiveTimeController(*args)
        for target in (5e-2, 1e-3, 2e-2, 1.0):
            assert tc.propose(target) == jc.propose(target)
        assert tc.backoff(0.25) == jc.backoff(0.25)
    tc = AdaptiveTimeController(1.0, dt_min=0.3)
    with pytest.raises(RuntimeError):
        tc.backoff(0.1)
    tc = AdaptiveTimeController(1.0)
    tries = []

    def step(dt):
        tries.append(dt)
        if dt > 0.3:
            raise RuntimeError("no convergence")
        return "done"

    assert step_with_retry(step, tc) == ("done", 0.25)
    assert tries == [1.0, 0.5, 0.25]
