# The window kernels of flow_tpu_torch on the card: K3 (csrc/winmom.cu,
# lagged and Newton) and K4b (csrc/winstiff.cu) against their plain PyTorch
# versions on small Karman layouts, bitwise repeatable, the Newton kernel
# equal to the lagged one where its reaction term vanishes, and refusing a
# block whose cells do not fit in shared memory. Skips without a CUDA device. Imports
# no JAX, so it runs on the machine with the card:
#   python -m pytest --noconftest -q tests/test_torch_window_cuda.py
# (tests/conftest.py imports JAX). Tolerance: float32 in both, another
# summation order: 1e-5 relative to the largest entry.
import numpy as np
import pytest
import torch

from flow_tpu_torch.attic import winkernel, winmom
from flow_tpu_torch.models.karman import KarmanProblem

torch.set_num_threads(1)

TOL = 1e-5


@pytest.fixture(scope="module")
def problem():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (CUDA kernel has no CPU mode)")
    return KarmanProblem(lcar=0.1, n_refine=1, dtype=torch.float32, device="cuda")


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("S", [128, None])
def test_stiffness_kernel_matches_plain(problem, S):
    op = winkernel.WindowStiffnessOperator(problem.Q, S=S)
    g = torch.Generator().manual_seed(1)
    x_pad = torch.zeros(op.wl.n_pad)
    x_pad[:op.wl.n] = torch.randn(op.wl.n, generator=g)
    x_pad = x_pad.cuda()
    before = winkernel.WINSTIFF.launches
    y = op.windows(x_pad)
    y2 = op.windows(x_pad)
    torch.cuda.synchronize()
    assert winkernel.WINSTIFF.launches == before + 2
    assert torch.equal(y, y2)
    y_plain = winkernel.stiffness_windows_plain(x_pad, op.lidx, op.valid, op.Cg,
                                                op.kref, op.wl.S, op.wl.W)
    assert _rel(y, y_plain) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("S", [128, None])
def test_momentum_kernel_matches_plain(problem, S):
    op = winmom.WindowLaggedMomentum(problem.V, S=S)
    rng = np.random.default_rng(2)
    T = torch.as_tensor(rng.standard_normal((problem.V.n_dofs, 2)), dtype=torch.float32,
                        device="cuda")
    Tq = op.transport_qp(T)
    x_pad = torch.zeros((2, op.wl.n_pad), device="cuda")
    x_pad[:, :op.wl.n] = torch.as_tensor(rng.standard_normal((2, op.wl.n)),
                                         dtype=torch.float32)
    for weights in ((1.0, 0.37, 0.021), (1.0, 0.0, 0.0)):
        before = winmom.WINMOM.launches
        y = op.windows(x_pad, Tq, *weights)
        y2 = op.windows(x_pad, Tq, *weights)
        torch.cuda.synchronize()
        assert winmom.WINMOM.launches == before + 2
        assert torch.equal(y, y2)
        y_plain = winmom.momentum_windows_plain(
            x_pad, op.lidx, op.valid, op.detj, op.G4, op.Cg4, Tq, op.tabs,
            op._scal(*weights), op.wl.S, op.wl.W)
        assert _rel(y, y_plain) <= TOL


def _momentum_inputs(problem, op, seed):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal((problem.V.n_dofs, 2)), dtype=torch.float32,
                        device="cuda")
    x_pad = torch.zeros((2, op.wl.n_pad), device="cuda")
    x_pad[:, :op.wl.n] = torch.as_tensor(rng.standard_normal((2, op.wl.n)),
                                         dtype=torch.float32)
    return x, x_pad


@pytest.mark.cuda
@pytest.mark.parametrize("S", [128, None])
def test_newton_kernel_matches_plain(problem, S):
    op = winmom.WindowLaggedMomentum(problem.V, S=S)
    x, x_pad = _momentum_inputs(problem, op, 3)
    Tq, Uq, Gu = op.state_qp(x)
    weights = (1.0, 0.37, 0.021)
    before = (winmom.WINMOM.launches, winmom.WINMOM_NEWTON.launches)
    y = op.windows(x_pad, Tq, *weights, Uq, Gu)
    y2 = op.windows(x_pad, Tq, *weights, Uq, Gu)
    torch.cuda.synchronize()
    assert (winmom.WINMOM.launches, winmom.WINMOM_NEWTON.launches) == (
        before[0], before[1] + 2)
    assert torch.equal(y, y2)
    y_plain = winmom.momentum_windows_plain(
        x_pad, op.lidx, op.valid, op.detj, op.G4, op.Cg4, Tq, op.tabs,
        op._scal(*weights), op.wl.S, op.wl.W, Uq, Gu)
    assert _rel(y, y_plain) <= TOL
    # the wrapper takes only the state that is the transport (state_qp's)
    with pytest.raises(ValueError, match="Uq that is"):
        op.windows(x_pad, Tq, *weights, Tq.clone(), Gu)


@pytest.mark.cuda
def test_newton_kernel_without_reaction_is_the_lagged_kernel(problem):
    op = winmom.WindowLaggedMomentum(problem.V, S=128)
    _, x_pad = _momentum_inputs(problem, op, 4)
    Tq = op.zero_transport()
    Gu = torch.zeros((op.wl.nb, 4 * op.nq, op.wl.C), device="cuda")
    weights = (1.0, 0.37, 0.021)
    y = op.windows(x_pad, Tq, *weights, Tq, Gu)
    y_lagged = op.windows(x_pad, Tq, *weights)
    torch.cuda.synchronize()
    assert _rel(y, y_lagged) <= 1e-7


@pytest.mark.cuda
def test_kernels_refuse_cells_beyond_shared_memory(problem):
    # one block of C cells: 12 B (K4b) and 48 B (K3) of shared memory each,
    # beyond the 227 KB a Hopper block can opt in to (313 floats: the small
    # tables of P2 with the 7-point rule)
    S = W = 128
    z = dict(device="cuda")
    C = 20000
    scatter = (torch.zeros((1, W + 1), dtype=torch.int32, **z),
               torch.zeros((1, 3 * C), dtype=torch.int32, **z))
    before = winkernel.WINSTIFF.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        winkernel.stiffness_windows(
            torch.zeros(S + W, **z), torch.zeros((1, 3, C), dtype=torch.int32, **z),
            torch.zeros((1, C), **z), torch.zeros((1, 4, C), **z),
            torch.zeros((12, 3), **z), S, W, scatter)
    assert winkernel.WINSTIFF.launches == before
    C = 5000
    scatter = (torch.zeros((1, W + 1), dtype=torch.int32, **z),
               torch.zeros((1, 6 * C), dtype=torch.int32, **z))
    before = winmom.WINMOM.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        winmom.momentum_windows(
            torch.zeros((2, S + W), **z), torch.zeros((1, 6, C), dtype=torch.int32, **z),
            torch.zeros((1, C), **z), torch.zeros((1, C), **z),
            torch.zeros((1, 4, C), **z), torch.zeros((1, 4, C), **z),
            torch.zeros((1, 14, C), **z), torch.zeros(313, **z), torch.zeros(3, **z),
            S, W, scatter)
    assert winmom.WINMOM.launches == before
