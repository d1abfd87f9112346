# flow_tpu_torch.parallel.domain.ShardedProjection (replicated vectors, one
# all_reduce per operator apply) on gloo CPU ranks against the JAX package's
# ShardedProjection on as many virtual devices, float64, the problems of
# tests/test_parallel.py at its tolerances (U 5e-13, P 5e-12): the
# lid-driven crossed square (n=10, rotational form) on 2 and 4 ranks, and
# the hydrostatic body-force step on 4 ranks, whose velocity stays at
# machine zero. One rank job runs every port case while JAX computes its
# references.
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import jax

from flow_tpu import (
    DirichletBC as JaxBC,
    FunctionSpace as JaxFS,
    VectorFunctionSpace as JaxVFS,
    project as jax_project,
    unit_square_mesh as jax_square,
)
from flow_tpu.fem.assembly import geometry as jax_geometry, tabulation as jax_tab
from flow_tpu.parallel import ShardedProjection as JaxSharded
from flow_tpu.parallel import partition_cells as jax_partition
from flow_tpu_torch import unit_square_mesh
from flow_tpu_torch.parallel import comm, partition_cells

torch.set_num_threads(1)

RUN = "flow_tpu_torch.parallel.cases:run_cases"
G = -9.81


def _lid_problem(n):
    mesh = jax_square(n, diagonal="crossed")
    V, Q = JaxVFS(mesh, 2), JaxFS(mesh, 1)

    def lid(x):
        return np.where(x[:, 1] > 1 - 1e-12, 1.0, 0.0)

    return V, Q, [JaxBC(V.sub(0), lid), JaxBC(V.sub(1), 0.0)]


def _jax_lid(ndev):
    V, Q, u_bcs = _lid_problem(10)
    sp = JaxSharded(V, Q, u_bcs, [], rho=1.0, mu=0.1, devices=jax.devices()[:ndev],
                    rotational_form=True)
    U1, P1, Ui = sp(jax_project((0.0, 0.0), V).vector, jax_project(0.0, Q).vector, 1e-2)
    return np.asarray(U1), np.asarray(P1), np.asarray(Ui)


def _jax_force():
    mesh = jax_square(8, diagonal="crossed")
    V, Q = JaxVFS(mesh, 2), JaxFS(mesh, 1)
    u_bcs = [JaxBC(V, (0.0, 0.0), "on_boundary")]
    sp = JaxSharded(V, Q, u_bcs, [], rho=1.0, mu=1e-3, devices=jax.devices()[:4],
                    rotational_form=False, with_force=True)
    xq = jax_geometry(mesh).physical_points(jax_tab(V, sp.force_rule).ref_pts)
    F = np.zeros(xq.shape[:2] + (2,))
    F[:, :, 1] = G
    U1, P1, Ui = sp(jax_project((0.0, 0.0), V).vector,
                    jax_project(lambda x: G * x[..., 1], Q).vector, 1e-2,
                    Fq=sp.pack_force(F))
    return np.asarray(U1), np.asarray(P1), np.asarray(Ui)


LID = dict(problem="lid", n0=10, diagonal="crossed")
PORT_CASES = [
    dict(kind="projection", spec=LID, ranks=2),
    dict(kind="projection", spec=LID),
    dict(kind="projection", spec=dict(problem="lid", n0=8, diagonal="crossed", mu=1e-3,
                                      noslip=True),
         kw=dict(rotational_form=False, with_force=True), p0_gy=G),
]


@pytest.fixture(scope="module")
def results():
    with ThreadPoolExecutor(4) as ex:
        port = ex.submit(comm.launch, RUN, 4, args=(PORT_CASES,))
        refs = [ex.submit(_jax_lid, 2), ex.submit(_jax_lid, 4), ex.submit(_jax_force)]
        ref = [f.result() for f in refs]
        ranks = port.result()
    return ref, ranks


@pytest.mark.parametrize("i", [0, 1], ids=["2ranks", "4ranks"])
def test_lid_step_matches_jax_sharded(results, i):
    ref, ranks = results
    out = ranks[0][i]
    for key, r, tol in (("U1", ref[i][0], 5e-13), ("P1", ref[i][1], 5e-12),
                        ("Ui", ref[i][2], 5e-13)):
        np.testing.assert_allclose(out[key], r, atol=tol)


def test_every_rank_holds_the_replicated_result(results):
    _, ranks = results
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[1]["U1"], ranks[0][1]["U1"])
    assert ranks[2][0] is None and ranks[3][0] is None


def test_hydrostatic_body_force_matches_jax(results):
    ref, ranks = results
    out = ranks[0][2]
    assert np.abs(out["U1"]).max() < 1e-12
    np.testing.assert_allclose(out["U1"], ref[2][0], atol=5e-13)
    np.testing.assert_allclose(out["P1"], ref[2][1], atol=5e-12)


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_partition_cells_is_jax(ndev):
    order, n_local = partition_cells(unit_square_mesh(7, device="cpu"), ndev)
    jorder, jn = jax_partition(jax_square(7), ndev)
    np.testing.assert_array_equal(order, jorder)
    assert n_local == jn and n_local * ndev >= len(order)
