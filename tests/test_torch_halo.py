# flow_tpu_torch.parallel.halo.HaloPoisson (the P1 Poisson solve over
# dof-partitioned vectors with a ring halo exchange) on gloo CPU ranks
# against the JAX package's HaloPoisson on 2 virtual devices, float64, the
# problem of tests/test_halo.py (crossed square n=24, a seeded right-hand
# side, pure Neumann and Dirichlet) at its tolerance (2e-10): on 2 ranks
# with JAX's CG count, and on 4 ranks. Then the launcher of the distributed
# layer (parallel/comm.py): a failed rank raises, a CUDA device without an
# NCCL group raises, and the rank collectives against plain sums.
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from flow_tpu import unit_square_mesh as jax_square, FunctionSpace as JaxFS
from flow_tpu.parallel.halo import HaloPoisson as JaxHalo
from flow_tpu_torch.parallel import comm

torch.set_num_threads(1)

RUN = "flow_tpu_torch.parallel.cases:run_cases"
SPEC = dict(problem="lid", n0=24, diagonal="crossed")


def _jax(neumann):
    mesh = jax_square(24, diagonal="crossed")
    S = JaxFS(mesh, 1)
    b = np.random.default_rng(0).standard_normal(S.n_dofs)
    bc = None
    if neumann:
        b = b - b.mean()
    else:
        m = np.zeros(S.n_dofs)
        m[S.boundary_dofs()] = 1.0
        bc = jnp.asarray(m)
        b = (1.0 - m) * b
    hp = JaxHalo(mesh, bc_mask=bc, devices=jax.devices()[:2])
    x, iters = hp.solve(jnp.asarray(b), rtol=1e-12, maxiter=5000)
    return np.asarray(x), iters, b


PORT = [dict(kind="halo_poisson", spec=SPEC, neumann=nm, ranks=r)
        for r in (2, 4) for nm in (True, False)]


@pytest.fixture(scope="module")
def results():
    with ThreadPoolExecutor(3) as ex:
        port = ex.submit(comm.launch, RUN, 4, args=(PORT,))
        ref = {nm: ex.submit(_jax, nm) for nm in (True, False)}
        ref = {k: v.result() for k, v in ref.items()}
        ranks = port.result()
    return ref, ranks[0]


@pytest.mark.parametrize("i", range(4), ids=["2-neumann", "2-dirichlet",
                                              "4-neumann", "4-dirichlet"])
def test_halo_poisson_matches_jax(results, i):
    ref, out = results
    case = PORT[i]
    x_ref, iters_ref, b = ref[case["neumann"]]
    res = out[i]
    np.testing.assert_array_equal(res["b"], b)
    x = res["x"]
    if case["neumann"]:
        x, x_ref = x - x.mean(), x_ref - x_ref.mean()
    np.testing.assert_allclose(x, x_ref, atol=2e-10)
    assert res["iters"] > 0
    if case["ranks"] == 2:
        assert res["iters"] == iters_ref


def test_failed_rank_raises():
    bad = [dict(kind="no such kind", spec=dict(problem="lid", n0=2))]
    with pytest.raises(RuntimeError, match="failed"):
        comm.launch(RUN, 2, args=(bad,), timeout=120)


def test_cuda_without_nccl_raises():
    # a gloo group cannot carry CUDA tensors, and without a card the default
    # device raises too: nothing falls back to the CPU
    with pytest.raises(RuntimeError, match="NCCL|CUDA"):
        comm.launch("flow_tpu_torch.parallel.comm:resolve_device", 1, args=("cuda",))
    with pytest.raises(RuntimeError, match="NCCL|CUDA|card"):
        comm.launch("flow_tpu_torch.parallel.comm:resolve_device", 1, args=(None,))
    with pytest.raises(RuntimeError, match="NCCL|CUDA|cards"):
        comm.launch(RUN, 2, args=([],), backend="nccl")


def test_collectives_in_process():
    (out,) = comm.launch("flow_tpu_torch.parallel.cases:collectives_probe", 1)
    assert out == {"sum": 6.0, "max": 3.0, "gather": [[1.0, 2.0, 3.0]],
                   "from_left": [0.0], "from_right": [0.0]}
