# The 3-D Boussinesq driver of flow_tpu_torch and what it adds against the
# JAX package, float64 on the CPU:
# - mesh3d.refine_uniform_tet: the JAX package's points, cells, edges and
#   boundary tables bit for bit, twice over; the midpoint of coarse edge e
#   is fine vertex n_old + e, so P2 dof points on a mesh are the P1 points
#   of its refinement, in order;
# - the P2 heat multigrid on tets (Heat._mg_hierarchy with the refined
#   extra level, ShiftedP1Hierarchy along tet edges) on a box chain with a
#   convection field: MG-GMRES with the JAX hierarchy's lambda_max, equal
#   GMRES iterations, the solution within 1e-10 of max|x|;
# - compute_boussinesq_3d(target_time=0.02, n=(4, 4, 8)) on both routes
#   (Rotational on the tets; BoxPackedStepper) against the JAX driver's,
#   u and theta within 1e-8 as tests/test_boussinesq3d_packed.py holds
#   them, with equal counts a sweep; the fluid is still at rest there
#   (every solve takes 0 iterations), so the packed route is also run to
#   t = 0.3 against the JAX route, where the heater ramp moves it (equal
#   Picard, BiCGStab, pressure and correction iterations). One JAX packed
#   run to t = 0.3 serves both packed cases: its first two steps are the
#   run to t = 0.02;
# - n_refine=1 at n = (2, 2, 4) on the Rotational route (the refined tets;
#   the heat solve dense at this size), u and theta within 1e-8.
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from flow_tpu import heat as jheat
from flow_tpu import parabolic as jparabolic
from flow_tpu.mesh3d import box_mesh as jbox
from flow_tpu.mesh3d import refine_uniform_tet as jrefine
from flow_tpu.models import boussinesq3d as jb3d
from flow_tpu.navier_stokes import boxfast as jboxfast

from flow_tpu_torch import heat as theat
from flow_tpu_torch import interop
from flow_tpu_torch.fem.bc import DirichletBC as TBC
from flow_tpu_torch.fem.spaces import FunctionSpace as TFS
from flow_tpu_torch.fem.spaces import VectorFunctionSpace as TVFS
from flow_tpu_torch.mesh3d import box_mesh as tbox
from flow_tpu_torch.mesh3d import refine_uniform_tet as trefine
from flow_tpu_torch.models.boussinesq3d import compute_boussinesq_3d

torch.set_num_threads(1)
CPU = dict(dtype=torch.float64, device="cpu")
KEYS = ("heat_solver", "heat_iters", "newton_iters", "linear_iters", "pressure_iters",
        "correction_iters")


def test_refine_uniform_tet_is_jax_bitwise():
    jm, tm = jbox((0, 0, 0), (0.1, 0.1, 0.2), 2, 2, 3), tbox((0, 0, 0), (0.1, 0.1, 0.2),
                                                              2, 2, 3, **CPU)
    for _ in range(2):
        n_old = tm.n_points
        coarse_p2 = TFS(tm, 2).dof_points_np
        jm, tm = jrefine(jm), trefine(tm)
        assert tm.device.type == "cpu" and tm.dtype == torch.float64
        np.testing.assert_array_equal(tm.points_np, jm.points_np)
        np.testing.assert_array_equal(tm.cells_np, jm.cells_np)
        np.testing.assert_array_equal(tm.edges_np, jm.edges_np)
        np.testing.assert_array_equal(tm.cell_edges_np, jm.cell_edges_np)
        np.testing.assert_array_equal(tm.boundary_faces_np, jm.boundary_faces_np)
        np.testing.assert_array_equal(tm.boundary_edges_np, jm.boundary_edges_np)
        assert tm.hmax == jm.hmax and tm.hmin == jm.hmin
        # P2 on the coarse mesh == P1 on its refinement, in order
        np.testing.assert_array_equal(coarse_p2, tm.points_np)
        assert tm.n_points - n_old == len(coarse_p2) - n_old
    assert tm.n_cells == 64 * 2 * 2 * 3 * 6


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


def test_p2_tet_heat_multigrid_matches_jax(monkeypatch):
    import flow_tpu
    from flow_tpu.fem.bc import DirichletBC as JBC

    jms = [jbox((0, 0, 0), (0.1, 0.1, 0.2), 2, 2, 2)]
    tms = [tbox((0, 0, 0), (0.1, 0.1, 0.2), 2, 2, 2, **CPU)]
    jms.append(jrefine(jms[-1]))
    tms.append(trefine(tms[-1]))
    jQ, tQ = flow_tpu.FunctionSpace(jms[-1], 2), TFS(tms[-1], 2)
    jW = flow_tpu.VectorFunctionSpace(jms[-1], 2, n_components=3)
    tW = TVFS(tms[-1], 2, n_components=3)
    rng = np.random.default_rng(0)
    conv = rng.standard_normal((tW.n_dofs, 3))
    # kappa 0.01 against |b| ~ 1 (cell Peclet ~ 2), as tests/test_torch_heat.py
    hot, cool = (lambda x: x[:, 2] < 1e-9), (lambda x: x[:, 2] > 0.2 - 1e-9)  # noqa: E731
    jop = jheat.Heat(jQ, flow_tpu.Function(jW, jnp.asarray(conv)), 0.01, 1.0, 1.0,
                     [JBC(jQ, 1.0, hot), JBC(jQ, 0.0, cool)], 0.0, mesh_hierarchy=jms)
    top = theat.Heat(tQ, interop.function_to_torch(tW, conv), 0.01, 1.0, 1.0,
                     [TBC(tQ, 1.0, hot), TBC(tQ, 0.0, cool)], 0.0, mesh_hierarchy=tms)
    calls = _jax_gmres_counter(monkeypatch)
    jh, th = jop._mg_hierarchy(), top._mg_hierarchy()
    # the extra level: P2 on the fine mesh is P1 on its refinement
    assert [L.n for L in th.levels] == [L.n for L in jh.levels] == [27, 125, 729]
    assert th.levels[-1].n == tQ.n_dofs
    interop.load_hierarchy_lmax(th, [L.lmax for L in jh.levels])
    b = rng.standard_normal(tQ.n_dofs)
    ju = jop.solve_alpha_M_beta_F(20.0, -1.0, jnp.asarray(b), 0.0, solver="mg")
    tu = top.solve_alpha_M_beta_F(20.0, -1.0, torch.as_tensor(b), 0.0, solver="mg")
    assert top.last_solve["solver"] == "mg"
    assert calls == [top.last_solve["iters"]] and calls[0] > 1, (calls, top.last_solve)
    ref = np.asarray(ju.vector)
    np.testing.assert_allclose(tu.vector.numpy(), ref, rtol=0, atol=1e-10 * np.abs(ref).max())
    # the V-cycle itself on a random residual
    r = rng.standard_normal(tQ.n_dofs)
    ref = np.asarray(jh.v_cycle(jnp.asarray(r), 20.0, 1.0))
    got = th.v_cycle(torch.as_tensor(r), 20.0, 1.0).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12 * np.abs(ref).max())


def _ns_counts(tel):
    return [tuple(r[k] for k in KEYS[2:] if k in r) for r in tel if "failed" not in r]


MOVE = dict(target_time=0.3, n=(4, 4, 8), supg=False, dt0=1e-2, backend="packed")


@pytest.fixture(scope="module")
def jax_packed():
    """One JAX packed run at n = (4, 4, 8) to t = 0.3 (five steps; the
    heater ramp moves the fluid in the last), shared by the packed cases:
    the counts of each BoxPackedStepper step and each sweep's (u, p, theta).
    Its first two steps are the run to t = 0.02 (the same dt, the same
    sweeps), so the state after them is that run's result."""
    mp = pytest.MonkeyPatch()
    rows, states, thetas = [], [], []
    orig_api = jboxfast.BoxPackedStepper.step_api
    orig_ns, orig_heat = jb3d._packed_ns_step, jparabolic.ImplicitEuler.step

    def step_api(self, *a, **k):
        out = orig_api(self, *a, **k)
        rows.append(tuple(int(getattr(out[2], key)) for key in KEYS[2:]))
        return out

    def ns_step(*a, **k):
        u1, p1 = orig_ns(*a, **k)
        states.append((np.asarray(u1.vector), np.asarray(p1.vector)))
        return u1, p1

    def heat_step(self, *a, **k):
        th = orig_heat(self, *a, **k)
        thetas.append(np.asarray(th.vector))
        return th

    mp.setattr(jboxfast.BoxPackedStepper, "step_api", step_api)
    mp.setattr(jb3d, "_packed_ns_step", ns_step)
    mp.setattr(jparabolic.ImplicitEuler, "step", heat_step)
    try:
        ju, jp, jt = jb3d.compute_boussinesq_3d(**MOVE)
    finally:
        mp.undo()
    assert len(rows) == len(states) == len(thetas)
    return dict(rows=rows, states=states, thetas=thetas,
                final=(np.asarray(ju.vector), np.asarray(jp.vector), np.asarray(jt.vector)))


@pytest.mark.parametrize("backend", [None, "packed"], ids=["rotational", "packed"])
def test_driver_matches_jax_at_rest(backend, request):
    kw = dict(target_time=0.02, n=(4, 4, 8), supg=False, dt0=1e-2)
    if backend is None:
        ju, jp, jt = jb3d.compute_boussinesq_3d(backend=backend, **kw)
        Uj, Pj, Tj = (np.asarray(f.vector) for f in (ju, jp, jt))
    else:
        # the state after the shared run's first two steps, one sweep each
        ref = request.getfixturevalue("jax_packed")
        assert ref["rows"][:2] == [(0, 0, 0, 0)] * 2
        (Uj, Pj), Tj = ref["states"][1], ref["thetas"][1]
    tel = []
    tu, tp, tt = compute_boussinesq_3d(backend=backend, device="cpu", telemetry=tel, **kw)
    assert tu.vector.shape == (tu.space.n_dofs, 3)
    assert [(r["step"], r["sweep"]) for r in tel] == [(0, 1), (1, 1)]
    assert all(r["heat_solver"] == "dense" for r in tel)
    du = float(np.abs(tu.vector.numpy() - Uj).max())
    dth = float(np.abs(tt.vector.numpy() - Tj).max())
    assert du < 1e-8 and dth < 1e-8, (du, dth)
    assert float(np.abs(tp.vector.numpy() - Pj).max()) < 1e-10 * np.abs(Pj).max()


def test_packed_driver_moves_with_jax(jax_packed):
    # to t = 0.3 (five steps): the heater ramp moves the fluid in the last
    rows = jax_packed["rows"]
    Uj, _, Tj = jax_packed["final"]
    tel = []
    tu, _, tt = compute_boussinesq_3d(device="cpu", telemetry=tel, **MOVE)
    assert _ns_counts(tel) == rows
    assert sum(r[1] for r in rows) > 0 and len({r["step"] for r in tel}) == 5
    assert np.abs(Uj).max() > 1e-12
    du = float(np.abs(tu.vector.numpy() - Uj).max())
    dth = float(np.abs(tt.vector.numpy() - Tj).max())
    assert du < 1e-8 * max(np.abs(Uj).max(), 1.0) and dth < 1e-8, (du, dth)


def test_refined_driver_matches_jax():
    # n_refine=1: the tets of a refined box (the heat solve on the dense
    # path at this size, 1,377 P2 dofs; the multigrid is held above)
    kw = dict(target_time=0.02, n=(2, 2, 4), n_refine=1, supg=False, dt0=1e-2)
    ju, _, jt = jb3d.compute_boussinesq_3d(**kw)
    tel = []
    tu, _, tt = compute_boussinesq_3d(device="cpu", telemetry=tel, **kw)
    assert tu.space.n_dofs == 1377 and len(tel) == 2
    assert [r["heat_solver"] for r in tel] == ["dense", "dense"]
    du = float(np.abs(tu.vector.numpy() - np.asarray(ju.vector)).max())
    dth = float(np.abs(tt.vector.numpy() - np.asarray(jt.vector)).max())
    assert du < 1e-8 and dth < 1e-8, (du, dth)


def test_packed_route_refuses_a_refined_box():
    with pytest.raises(ValueError, match="n_refine=0"):
        compute_boussinesq_3d(0.0, n=(2, 2, 2), n_refine=1, backend="packed", device="cpu")
