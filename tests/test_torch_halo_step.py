# flow_tpu_torch.parallel.halo_step.HaloProjection (the full projection step
# over dof-partitioned state with ring halo exchanges) on gloo CPU ranks
# against the JAX package's HaloProjection on as many virtual devices,
# float64:
# - Newton, the lid-driven crossed square n=10 (tests/test_halo_step.py:21),
#   one step on 2 ranks (JAX on 2 devices) and on 4, at that test's
#   tolerances (U 1e-11, P 1e-10);
# - Newton on the 3-D box (4, 1, 1) of 8 x 2 x 2 cubes
#   (tests/test_halo_mg.py:116), 4 ranks, at its tolerances (1e-10, 1e-9);
# - the einsum route with lagged convection, 2 steps, iterate-exact (1e-10);
# - the window route (winkernel=True: K3's plain version on the CPU, float32
#   inside) with lagged and Newton convection, 2 steps, held against JAX's
#   einsum halo route at tests/test_halo_step.py:176's tolerances (U 3e-6,
#   P 2e-4): JAX's window route runs its kernel in interpret mode, ~2 min a
#   case; then one rank's halo_window_momentum against JAX's (interpret
#   mode) on that device's table shard, lagged and Newton;
# - the distributed multigrid with BDF2 and the CFL controller
#   (tests/test_halo_mg.py's bdf2 run: crossed n0=5 refined once, 3 steps),
#   the JAX lambda_max carried across: equal pressure and correction counts,
#   U and the mean-removed P within 1e-8, dt within 1e-12.
# One 4-rank job runs every port case while JAX compiles in threads.
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from flow_tpu import (
    DirichletBC as JaxBC,
    FunctionSpace as JaxFS,
    VectorFunctionSpace as JaxVFS,
    unit_square_mesh as jax_square,
)
from flow_tpu.attic import halo_win as jax_hw
from flow_tpu.mesh import refine_uniform as jax_refine
from flow_tpu.mesh3d import box_mesh as jax_box
from flow_tpu.parallel.halo_step import HaloProjection as JaxHalo
from flow_tpu_torch.attic import halo_win
from flow_tpu_torch.fem.assembly import geometry
from flow_tpu_torch.parallel import comm
from flow_tpu_torch.parallel.cases import build_problem
from flow_tpu_torch.parallel.halo_step import HaloSpace, _strips

torch.set_num_threads(1)

RUN = "flow_tpu_torch.parallel.cases:run_cases"
LID = dict(problem="lid", n0=10, diagonal="crossed")
BOX = dict(problem="box", n=(8, 2, 2))
MG = dict(problem="lid", n0=5, n_refine=1, diagonal="crossed")
WIN_KW = dict(linear_rtol=1e-12, newton_tol=1e-10)


def _jax_problem(spec):
    if spec["problem"] == "box":
        mesh = jax_box((0, 0, 0), (4, 1, 1), *spec["n"])
        V, Q = JaxVFS(mesh, 2, n_components=3), JaxFS(mesh, 1)

        def lid3(x):
            return np.where(x[:, 2] > 1 - 1e-12, 1.0, 0.0)

        bcs = [JaxBC(V.sub(0), lid3), JaxBC(V.sub(1), 0.0), JaxBC(V.sub(2), 0.0)]
        return V, Q, bcs, [mesh]
    ms = [jax_square(spec["n0"], diagonal="crossed")]
    for _ in range(spec.get("n_refine", 0)):
        ms.append(jax_refine(ms[-1]))
    V, Q = JaxVFS(ms[-1], 2), JaxFS(ms[-1], 1)

    def lid(x):
        return np.where(x[:, 1] > 1 - 1e-12, 1.0, 0.0)

    return V, Q, [JaxBC(V.sub(0), lid), JaxBC(V.sub(1), 0.0)], ms


def _jax_steps(spec, ndev, n_steps, **kw):
    V, Q, bcs, _ = _jax_problem(spec)
    hp = JaxHalo(V, Q, bcs, [], rho=1.0, mu=0.1, devices=jax.devices()[:ndev],
                 rotational_form=True, **kw)
    Up, Pp = hp.Vh.to_partitioned(np.asarray(V.zeros())), hp.Qh.to_partitioned(
        np.asarray(Q.zeros()))
    out = []
    for _ in range(n_steps):
        Up, Pp = hp.step(Up, Pp, 1e-2)
        out.append((np.asarray(hp.Vh.from_partitioned(Up)),
                    np.asarray(hp.Qh.from_partitioned(Pp))))
    return out


def _jax_mg():
    V, Q, bcs, ms = _jax_problem(MG)
    hp = JaxHalo(V, Q, bcs, [], rho=1.0, mu=0.1, devices=jax.devices()[:4],
                 rotational_form=True, mesh_hierarchy=ms, time_step_method="bdf2")
    lmax = (hp._mg["theta"] / 0.675, [float(L.lmax) for L in hp._mg["coarse"].levels])
    return hp, V, Q, lmax


def _jax_mg_run(hp, V, Q):
    Up = hp.Vh.to_partitioned(np.asarray(V.zeros()))
    Pp = hp.Qh.to_partitioned(np.asarray(Q.zeros()))
    U, P, dt, tel, _ = hp.run(Up, Pp, jnp.asarray(1e-3), n_steps=3)
    return (np.asarray(hp.Vh.from_partitioned(U)), np.asarray(hp.Qh.from_partitioned(P)),
            float(dt), {k: np.asarray(v) for k, v in tel.items()})


def _port_cases(mg_lmax):
    def step(spec, n_steps=1, ranks=4, **kw):
        return dict(kind="halo_step", spec=spec, ranks=ranks, n_steps=n_steps,
                    kw=dict(rotational_form=True, **kw))

    return {
        "lid2": step(LID, ranks=2),
        "lid4": step(LID),
        "box": step(BOX),
        "lagged": step(LID, 2, convection="lagged", **WIN_KW),
        "win_lagged": step(LID, 2, convection="lagged", winkernel=True, **WIN_KW),
        "win_newton": step(LID, 2, convection="newton", winkernel=True, **WIN_KW),
        "mg_bdf2": dict(kind="halo_step", spec=MG, mg=True, lmax=mg_lmax, n_run=3,
                        n_steps=0, dt=1e-3, kw=dict(time_step_method="bdf2")),
    }


@pytest.fixture(scope="module")
def results():
    with ThreadPoolExecutor(6) as ex:
        hp_mg, V, Q, lmax = _jax_mg()
        cases = _port_cases(lmax)
        port = ex.submit(comm.launch, RUN, 4, args=(list(cases.values()),))
        ref = {
            "lid2": ex.submit(_jax_steps, LID, 2, 1),
            "box": ex.submit(_jax_steps, BOX, 4, 1),
            "lagged": ex.submit(_jax_steps, LID, 4, 2, convection="lagged", **WIN_KW),
            "newton": ex.submit(_jax_steps, LID, 4, 2, convection="newton", **WIN_KW),
            "mg_bdf2": ex.submit(_jax_mg_run, hp_mg, V, Q),
        }
        ref = {k: v.result() for k, v in ref.items()}
        ranks = port.result()
    return ref, dict(zip(cases, ranks[0])), ranks


def _mf(p):
    return p - p.mean()


@pytest.mark.parametrize("name,tu,tp", [("lid2", 1e-11, 1e-10), ("lid4", 1e-11, 1e-10),
                                        ("box", 1e-10, 1e-9)])
def test_newton_step_matches_jax(results, name, tu, tp):
    ref, out, _ = results
    U, P = out[name]["steps"][0]
    Ur, Pr = ref["box" if name == "box" else "lid2"][0]
    np.testing.assert_allclose(U, Ur, atol=tu)
    np.testing.assert_allclose(_mf(P), _mf(Pr), atol=tp)


def test_lagged_einsum_route_matches_jax(results):
    ref, out, _ = results
    for (U, P), (Ur, Pr) in zip(out["lagged"]["steps"], ref["lagged"]):
        np.testing.assert_allclose(U, Ur, atol=1e-10)
        np.testing.assert_allclose(_mf(P), _mf(Pr), atol=1e-10)


@pytest.mark.parametrize("conv", ["lagged", "newton"])
def test_window_route_matches_jax_einsum_route(results, conv):
    ref, out, _ = results
    for (U, P), (Ur, Pr) in zip(out["win_" + conv]["steps"], ref[conv]):
        np.testing.assert_allclose(U, Ur, atol=3e-6)
        np.testing.assert_allclose(_mf(P), _mf(Pr), atol=2e-4)


def test_mg_bdf2_run_matches_jax(results):
    ref, out, _ = results
    U, P, dt, tel = out["mg_bdf2"]["run"]
    Ur, Pr, dtr, telr = ref["mg_bdf2"]
    for key in ("pressure_iters", "correction_iters"):
        np.testing.assert_array_equal(tel[key], telr[key])
    np.testing.assert_allclose(tel["t"], telr["t"], rtol=1e-12)
    np.testing.assert_allclose(U, Ur, atol=1e-8)
    np.testing.assert_allclose(_mf(P), _mf(Pr), atol=1e-8)
    assert abs(dt - dtr) < 1e-12


def test_every_rank_gathers_the_same_state(results):
    _, _, ranks = results
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[1]["steps"][0][0], ranks[0][1]["steps"][0][0])


def _jax_window_apply(jax_side, x, v, newton):
    meta, td, sm, wtab, cd_d, G_d = jax_side
    if newton:
        Tq, Uq, Gu = jax_hw.halo_state_q(meta, wtab, td["cells"], cd_d, G_d,
                                         jnp.asarray(x))
    else:
        Tq = jax_hw.halo_transport_q(meta, wtab, td["cells"], cd_d, jnp.asarray(x))
        Uq = Gu = None
    return np.asarray(jax_hw.halo_window_momentum(
        meta, sm, td, jnp.asarray(v), Tq, 1.0, *S_RHO_MU, Uq=Uq, Gu=Gu, interpret=True))


S_RHO_MU = (0.02, 0.002)


@pytest.fixture(scope="module")
def window_case():
    """One rank (1 of 4) on the lid square: JAX's window apply on its table
    shard (FLOW_WINKERNEL=1, interpret mode; lagged and Newton compiled at
    once), the port's tables for that rank, and the seeded inputs."""
    ndev, d = 4, 1
    V, Q, bcs, _ = _jax_problem(LID)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FLOW_WINKERNEL", "1")
        jhp = JaxHalo(V, Q, bcs, [], rho=1.0, mu=0.1, devices=jax.devices()[:ndev],
                      convection="lagged")
    c_per = jhp.Vh.c_loc
    td = {k: v.reshape((ndev, -1) + v.shape[1:])[d] for k, v in jhp._win_tabs.items()}
    jax_side = (jhp._win_meta, td, jhp._win_sm, jhp._win_tab,
                jhp.cd_V.reshape(ndev, c_per, -1)[d], jhp.G.reshape(ndev, c_per, 2, 2)[d])

    prob = build_problem(LID)
    mesh = prob.V.mesh
    Vh = HaloSpace(prob.V, *_strips(mesh, ndev), ndev, rank=d)
    assert Vh.n_ext == jhp._win_meta["n_ext"]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((Vh.n_ext, 2))
    v = rng.standard_normal((Vh.n_ext, 2))
    x[Vh.dummy] = v[Vh.dummy] = 0.0
    with ThreadPoolExecutor(2) as ex:
        ref = list(ex.map(lambda nt: _jax_window_apply(jax_side, x, v, nt),
                          (False, True)))
    g = geometry(mesh)
    cells = Vh.cells
    port = halo_win.build_halo_window_tables(Vh, g.detJ[cells], g.G[cells], g.C[cells], 2)
    return ref, port, Vh, torch.as_tensor(g.G[cells]), x, v


@pytest.mark.parametrize("newton", [False, True], ids=["lagged", "newton"])
def test_one_rank_window_momentum_matches_jax(window_case, newton):
    ref, (pm, pt, psm, ptab), Vh, G, x, v = window_case
    x, v = torch.as_tensor(x), torch.as_tensor(v)
    if newton:
        Tq, Uq, Gu = halo_win.halo_state_q(pm, ptab, pt["cells"], Vh.cell_dofs_ext, G, x)
    else:
        Tq = halo_win.halo_transport_q(pm, ptab, pt["cells"], Vh.cell_dofs_ext, x)
        Uq = Gu = None
    y = halo_win.halo_window_momentum(pm, psm, pt, v, Tq, 1.0, *S_RHO_MU, Uq=Uq, Gu=Gu)
    jy = ref[int(newton)]
    np.testing.assert_allclose(y.numpy(), jy, atol=2e-5 * np.abs(jy).max())
