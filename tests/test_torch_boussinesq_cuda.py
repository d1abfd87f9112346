# The coupled Boussinesq driver of flow_tpu_torch on the card against the
# CPU, in float64: compute_boussinesq(backend="packed") to t = 0.3 at
# lcar = 0.03 with one refinement (dense heat solve) and with three (456
# and 6,624 temperature dofs: the second takes the multigrid-GMRES heat
# solve), equal Picard, GMRES, pressure, correction and heat-GMRES
# iterations a Banach sweep, u within 1e-8 and theta within 1e-10 of their
# largest entries. The heat operator's apply and load vector and the shifted
# multigrid's restriction and V-cycle repeat bitwise on the card (their
# sums read member tables in a fixed order). Skips without a CUDA device.
# Imports no JAX, so it runs on the machine with the card:
#   python -m pytest --noconftest -q tests/test_torch_boussinesq_cuda.py
import numpy as np
import pytest
import torch

import flow_tpu_torch
from flow_tpu_torch import heat, interop
from flow_tpu_torch.models.boussinesq import compute_boussinesq

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)
KEYS = ("heat_solver", "heat_iters", "newton_iters", "linear_iters",
        "pressure_iters", "correction_iters")


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the card runs of the Boussinesq driver)")


def _run(device, n_refine):
    tel = []
    u, _, th = compute_boussinesq(target_time=0.3, lcar=0.03, n_refine=n_refine,
                                  backend="packed", device=device, telemetry=tel)
    return u.vector.cpu(), th.vector.cpu(), [tuple(r[k] for k in KEYS) for r in tel]


@pytest.mark.parametrize("n_refine,solver", [(1, "dense"), (3, "mg")])
def test_packed_driver_card_matches_cpu(card, n_refine, solver):
    uc, thc, cc = _run("cpu", n_refine)
    ug, thg, cg = _run("cuda", n_refine)
    assert cg == cc
    assert {c[0] for c in cc} == {solver}
    # u is the small residue of buoyancy against the hydrostatic pressure:
    # the sums' last bits of those large terms show at ~1e-9 of max|u|
    assert float((ug - uc).abs().max()) <= 1e-8 * float(uc.abs().max())
    assert float((thg - thc).abs().max()) <= 1e-10 * float(thc.abs().max())


def test_heat_sums_repeat_bitwise(card):
    mesh = flow_tpu_torch.rectangle_with_hole_mesh(
        0.0, 0.1, 0.0, 0.2, cx=0.05, cy=0.05, r=0.02, lcar=0.03,
        dtype=torch.float64, device="cuda")
    meshes = [mesh]
    for _ in range(3):
        meshes.append(flow_tpu_torch.refine_uniform(meshes[-1]))
    Q = flow_tpu_torch.FunctionSpace(meshes[-1], 2)
    W = flow_tpu_torch.VectorFunctionSpace(meshes[-1], 2)
    rng = np.random.default_rng(0)
    conv = interop.function_to_torch(W, 1e-3 * rng.standard_normal((W.n_dofs, 2)))
    bcs = [flow_tpu_torch.DirichletBC(Q, 1.0)]
    op = heat.Heat(Q, conv, 0.6, 1000.0, 4000.0, bcs, 1.0, supg_stabilization=True,
                   mesh_hierarchy=meshes)
    u = torch.as_tensor(rng.standard_normal(Q.n_dofs), device="cuda")
    hier = op._mg_hierarchy()
    r = torch.as_tensor(rng.standard_normal(hier.levels[-1].n), device="cuda")
    for fn in (lambda: op.A_apply(u), lambda: op.M_apply(u),
               lambda: heat.Heat(Q, conv, 0.6, 1000.0, 4000.0, bcs, 1.0).b_vec,
               lambda: hier.restrict(hier.nlevels - 2, r),
               lambda: hier.v_cycle(r, 50.0, 1.0)):
        a, b = fn(), fn()
        assert torch.equal(a, b)
