# The packed-patch route of flow_tpu_torch on the card against the CPU:
# PackedPatchStepper (navier_stokes/patchfast.py) at
# KarmanProblem(lcar=0.1, n_refine=2) in float64 at tests/test_patchfast.py's
# tight tolerances, the CPU hierarchy's lambda_max carried to the card:
# BiCGStab with backward Euler and BDF2 (3 steps) and GMRES (one step).
# Equal per-step iteration counts, U within 1e-10, the mean-removed P within
# 1e-8 and dt within 1e-12, as the CPU parity with the JAX package holds
# them (tests/test_torch_patchfast.py). The route runs PyTorch's kernels
# only; a step on the card must launch none of the repository's hand
# kernels. Skips without a CUDA device. Imports no JAX, so it runs on the
# machine with the card:
#   python -m pytest --noconftest -q tests/test_torch_patchfast_cuda.py
import numpy as np
import pytest
import torch

from flow_tpu_torch import _build, interop
from flow_tpu_torch.attic import winform, winkernel, winmom
from flow_tpu_torch.fem import ell
from flow_tpu_torch.fem.patch import build_patch_info
from flow_tpu_torch.models.karman import KarmanProblem
from flow_tpu_torch.navier_stokes.patchfast import PackedPatchStepper
from flow_tpu_torch.ops import stencil

torch.set_num_threads(1)

TIGHT = dict(newton_tol=1e-12, newton_rtol=0.0, pressure_rtol=1e-11,
             correction_rtol=1e-11, mg_smoother_degree=3)
ITERS = ("newton_iters", "linear_iters", "pressure_iters", "correction_iters")
HAND = [k for mod in (stencil, ell, winmom, winkernel, winform)
        for k in vars(mod).values() if isinstance(k, _build.Kernel)]


def _stepper(device, lmax=None, **kw):
    p = KarmanProblem(lcar=0.1, n_refine=2, dtype=torch.float64, device=device)
    st = PackedPatchStepper(p.V, p.Q, p.u_bcs, p.p_bcs, p.rho, p.mu,
                            build_patch_info(p.mesh_hierarchy), **dict(TIGHT, **kw))
    if lmax is not None:
        interop.load_hierarchy_lmax(st.hierarchy, lmax)
    return st


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the card runs of the packed route)")


@pytest.mark.cuda
@pytest.mark.parametrize("solver, method, n_steps", [
    ("bicgstab", "backward euler", 3),
    ("bicgstab", "bdf2", 3),
    ("gmres", "backward euler", 1),
], ids=["bicgstab-be", "bicgstab-bdf2", "gmres-be"])
def test_card_matches_cpu(card, solver, method, n_steps):
    kw = dict(momentum_solver=solver, time_step_method=method)
    cpu = _stepper("cpu", **kw)
    gpu = _stepper("cuda", lmax=[L.lmax for L in cpu.hierarchy.levels], **kw)
    for k in HAND:
        k.launches = 0
    out_c = cpu.run(*cpu.zeros(), 1e-3, n_steps)
    out_g = gpu.run(*gpu.zeros(), 1e-3, n_steps)
    torch.cuda.synchronize()
    assert sum(k.launches for k in HAND) == 0
    tel_c, tel_g = out_c[3], out_g[3]
    for key in ITERS:
        assert tel_g[key].tolist() == tel_c[key].tolist(), key
    for key in ("pressure_converged", "correction_converged"):
        assert bool(tel_g[key].all()), key
    np.testing.assert_allclose(tel_g["dt"].cpu().numpy(), tel_c["dt"].numpy(), rtol=0,
                               atol=1e-12)
    Uc, Pc = (a.numpy() for a in cpu.from_packed_state(out_c[0], out_c[1]))
    Ug, Pg = (a.cpu().numpy() for a in gpu.from_packed_state(out_g[0], out_g[1]))
    np.testing.assert_allclose(Ug, Uc, rtol=0, atol=1e-10)
    dp = Pg - Pc
    np.testing.assert_allclose(dp - dp.mean(), 0.0, rtol=0, atol=1e-8)
