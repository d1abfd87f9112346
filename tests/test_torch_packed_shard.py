# flow_tpu_torch.parallel.packed_shard.ShardedPackedStepper on gloo CPU ranks
# against the JAX package's ShardedPackedStepper on as many virtual devices
# and against the port's own single-card stepper (sh.base), float64, the
# problems of tests/test_packed_shard.py at its tight tolerances:
# - Kármán lcar=0.1 n_refine=2 (Dirichlet pressure, ds-terms), GMRES, 4
#   ranks: one step against JAX's, a 3-step run against base's;
# - the left-diagonal lid cavity (pure-Neumann pressure), GMRES, 2 ranks:
#   one step against JAX's;
# - the same cavity, BDF2 with BiCGStab (the bench's solver; the JAX tests
#   have no sharded BiCGStab case), 4 ranks: a 3-step run against JAX's;
# iterate-exact: equal Krylov counts, U within 1e-8, the mean-removed P
# within 1e-8, dt within 1e-12. The JAX hierarchy's lambda_max is carried
# across (interop.load_hierarchy_lmax on the port stepper's hierarchy).
# One rank job (comm.launch, 4 gloo ranks) runs every port case while the
# JAX programs compile in threads.
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import jax

from flow_tpu.fem.bc import DirichletBC as JaxBC
from flow_tpu.fem.patch import build_patch_info as jax_patch_info
from flow_tpu.fem.spaces import FunctionSpace as JaxFS, VectorFunctionSpace as JaxVFS
from flow_tpu.mesh import refine_uniform as jax_refine, unit_square_mesh as jax_square
from flow_tpu.models.karman import KarmanProblem as JaxKarman
from flow_tpu.parallel.packed_shard import (
    PackedShardPlan as JaxPlan,
    ShardedPackedStepper as JaxSharded,
)
from flow_tpu_torch.fem.patch import build_patch_info
from flow_tpu_torch.parallel import comm
from flow_tpu_torch.parallel.cases import build_problem
from flow_tpu_torch.parallel.packed_shard import PackedShardPlan

torch.set_num_threads(1)

TIGHT = dict(newton_tol=1e-12, newton_rtol=0.0, pressure_rtol=1e-11,
             correction_rtol=1e-11, mg_smoother_degree=3)
KARMAN = dict(problem="karman", lcar=0.1, n_refine=2)
LID = dict(problem="lid", n0=4, n_refine=2, diagonal="left", mu=0.05)
RUN = "flow_tpu_torch.parallel.cases:run_cases"

# name -> (spec, ranks, stepper keywords, dt, what JAX runs)
CASES = {
    "karman_gmres": (KARMAN, 4, dict(TIGHT, momentum_solver="gmres"), 1e-3, "step"),
    "lid_neumann": (LID, 2, dict(TIGHT, momentum_solver="gmres"), 1e-2, "step"),
    "lid_bdf2_bicgstab": (LID, 4, dict(TIGHT, momentum_solver="bicgstab",
                                       time_step_method="bdf2"), 1e-3, "run"),
}


def _jax_problem(spec):
    if spec["problem"] == "karman":
        p = JaxKarman(lcar=spec["lcar"], n_refine=spec["n_refine"])
        return p.V, p.Q, p.u_bcs, p.p_bcs, p.rho, p.mu, p.mesh_hierarchy
    ms = [jax_square(spec["n0"], diagonal=spec["diagonal"])]
    for _ in range(spec["n_refine"]):
        ms.append(jax_refine(ms[-1]))
    V, Q = JaxVFS(ms[-1], 2), JaxFS(ms[-1], 1)

    def lid(x):
        return np.where(x[:, 1] > 1 - 1e-12, 1.0, 0.0)

    return V, Q, [JaxBC(V.sub(0), lid), JaxBC(V.sub(1), 0.0)], [], 1.0, spec["mu"], ms


def _jax_build(name):
    spec, ranks, kw, _, _ = CASES[name]
    V, Q, ub, pb, rho, mu, ms = _jax_problem(spec)
    sh = JaxSharded(V, Q, ub, pb, rho, mu, jax_patch_info(ms),
                    devices=jax.devices()[:ranks], **kw)
    return sh, (V, Q), [float(L.lmax) for L in sh._ghier.levels]


def _jax_run(name, built):
    sh, (V, Q), _ = built
    dt, what = CASES[name][3], CASES[name][4]
    Us, Ps = sh.to_sharded(V.zeros(), Q.zeros())
    if what == "step":
        U1s, P1s, st = sh.step(Us, Ps, dt)
        U1, P1 = sh.from_sharded(U1s, P1s)
        return {"U": np.asarray(U1), "P": np.asarray(P1),
                "counts": {k: int(getattr(st, k)) for k in
                           ("linear_iters", "pressure_iters", "correction_iters")}}
    U3s, P3s, dts, tel = sh.run(Us, Ps, dt, n_steps=3)
    U3, P3 = sh.from_sharded(U3s, P3s)
    return {"U": np.asarray(U3), "P": np.asarray(P3), "dt": float(dts),
            "tel": {k: np.asarray(v) for k, v in tel.items()}}


def _port_cases(lmax):
    cases = []
    for name, (spec, ranks, kw, dt, what) in CASES.items():
        cases.append(dict(kind="packed", spec=spec, ranks=ranks, kw=kw, dt=dt,
                          lmax=lmax[name], step=what == "step",
                          n_run=3 if (what == "run" or name == "karman_gmres") else 0))
    return cases


@pytest.fixture(scope="module")
def results():
    with ThreadPoolExecutor(len(CASES)) as ex:
        built = dict(zip(CASES, ex.map(_jax_build, CASES)))
        lmax = {k: v[2] for k, v in built.items()}
        port = ex.submit(comm.launch, RUN, 4, args=(_port_cases(lmax),))
        ref = dict(zip(CASES, ex.map(lambda k: _jax_run(k, built[k]), CASES)))
        ranks = port.result()
    out = {name: r for name, r in zip(CASES, ranks[0])}
    return ref, out, ranks


def _mean_free(p):
    return p - p.mean()


@pytest.mark.parametrize("name", ["karman_gmres", "lid_neumann"])
def test_step_matches_jax_sharded(results, name):
    ref, out, _ = results
    U, P, counts = out[name]["step"]
    assert counts == ref[name]["counts"]
    np.testing.assert_allclose(U, ref[name]["U"], atol=1e-8)
    np.testing.assert_allclose(_mean_free(P), _mean_free(ref[name]["P"]), atol=1e-8)


@pytest.mark.parametrize("name", ["karman_gmres", "lid_neumann"])
def test_step_matches_port_base(results, name):
    _, out, _ = results
    U, P, counts = out[name]["step"]
    Ub, Pb, cb = out[name]["base_step"]
    assert counts == cb
    np.testing.assert_allclose(U, Ub, atol=1e-8)
    np.testing.assert_allclose(_mean_free(P), _mean_free(Pb), atol=1e-8)


@pytest.mark.parametrize("name", ["karman_gmres", "lid_bdf2_bicgstab"])
def test_run_matches_port_base(results, name):
    _, out, _ = results
    U, P, dt, tel = out[name]["run"]
    Ub, Pb, dtb, telb = out[name]["base_run"]
    for key in ("linear_iters", "pressure_iters", "correction_iters"):
        np.testing.assert_array_equal(tel[key], telb[key])
    np.testing.assert_allclose(U, Ub, atol=1e-8)
    np.testing.assert_allclose(_mean_free(P), _mean_free(Pb), atol=1e-8)
    assert abs(dt - dtb) < 1e-12


def test_bdf2_bicgstab_run_matches_jax_sharded(results):
    ref, out, _ = results
    U, P, dt, tel = out["lid_bdf2_bicgstab"]["run"]
    r = ref["lid_bdf2_bicgstab"]
    for key in ("linear_iters", "pressure_iters", "correction_iters"):
        np.testing.assert_array_equal(tel[key], r["tel"][key])
    np.testing.assert_allclose(tel["t"], r["tel"]["t"], rtol=1e-12)
    np.testing.assert_allclose(U, r["U"], atol=1e-8)
    np.testing.assert_allclose(_mean_free(P), _mean_free(r["P"]), atol=1e-8)
    assert abs(dt - r["dt"]) < 1e-12


def test_ranks_agree_and_seams_cross_ranks(results):
    _, _, ranks = results
    for mine, other in zip(ranks[0], ranks[1]):
        key = "step" if "step" in mine else "run"
        # from_sharded hands every rank the same global state
        np.testing.assert_array_equal(other[key][0], mine[key][0])
        assert mine["seam_stats"]["remote_row_pairs"] > 0
    assert ranks[2][1] is None and ranks[3][1] is None  # outside the 2-rank group


@pytest.mark.parametrize("ndev", [2, 3, 4])
def test_partition_plan_is_jax(ndev):
    jinfo = jax_patch_info(JaxKarman(lcar=0.1, n_refine=1).mesh_hierarchy)
    prob = build_problem(dict(KARMAN, n_refine=1))
    info = build_patch_info(prob.meshes)
    jp, tp = JaxPlan(jinfo, ndev), PackedShardPlan(info, ndev)
    np.testing.assert_array_equal(tp.old_of_new, jp.old_of_new)
    assert (tp.C, tp.Cl, tp.Cpad) == (jp.C, jp.Cl, jp.Cpad)


def test_one_rank_runs_in_process_and_matches_base():
    case = dict(kind="packed", spec=dict(LID, n_refine=1), kw=dict(TIGHT),
                dt=1e-2, n_run=2)
    (res,) = comm.launch(RUN, 1, args=([case],))[0]
    U, P, counts = res["step"]
    Ub, Pb, cb = res["base_step"]
    assert counts == cb
    np.testing.assert_allclose(U, Ub, atol=1e-12)
    np.testing.assert_array_equal(res["run"][3]["pressure_iters"],
                                  res["base_run"][3]["pressure_iters"])
    assert not torch.distributed.is_initialized()
