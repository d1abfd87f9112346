# The ELL kernels of flow_tpu_torch on the card (csrc/ell.cu): the direct
# kernel (P1) and the windowed kernel (P2) against their plain PyTorch
# versions (fem/ell.py ell_apply_plain, ell_apply_window_plain) at the TPU
# probes' shapes (131,072 x 8 and 1,048,576 x 8, banded within +-64), at
# the P1 stiffness of the Karman hierarchy's 53,392-row level (window in
# float32, direct in float64), at a band too wide for any window and at a
# row count that is no multiple of 128; bitwise repeatable; and a CUDA
# matrix never running the plain apply. Tolerance: another summation order,
# 1e-6 relative to the largest entry in float32 and 1e-14 in float64.
# Skips without a CUDA device. Imports no JAX, so it runs on the machine
# with the card:
#   python -m pytest --noconftest -q tests/test_torch_ell_cuda.py
import numpy as np
import pytest
import torch

from flow_tpu_torch.fem import assembly, ell
from flow_tpu_torch.fem.ell import ELLMatrix, ell_stiffness
from flow_tpu_torch.fem.spaces import FunctionSpace
from flow_tpu_torch.mesh import rectangle_with_hole_mesh, refine_uniform

torch.set_num_threads(1)

TOL = {torch.float32: 1e-6, torch.float64: 1e-14}
DTYPES = [torch.float32, torch.float64]


def _banded(n, band, K, seed=0):
    rng = np.random.default_rng(seed)
    cols = np.clip(np.arange(n)[:, None] + rng.integers(-band, band, (n, K)), 0, n - 1)
    return cols, rng.standard_normal((n, K))


@pytest.fixture(scope="module")
def karman_level():
    """The P1 stiffness of the Karman hierarchy's 53,392-row level
    (lcar=0.02 refined 4 times)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (CUDA kernel has no CPU mode)")
    from flow_tpu_torch.models.karman import X0, X1, Y0, Y1, OBSTACLE_CENTER

    mesh = rectangle_with_hole_mesh(X0, X1, Y0, Y1, cx=OBSTACLE_CENTER[0],
                                    cy=OBSTACLE_CENTER[1], r=0.02, lcar=0.02,
                                    device="cpu")
    for _ in range(4):
        mesh = refine_uniform(mesh)
    space = FunctionSpace(mesh, 1)
    return space, assembly.geometry(mesh)


def _matrix(case, dtype, karman_level):
    if case == "karman 53k":
        space, geom = karman_level
        assert space.n_dofs == 53392
        return ell_stiffness(space, geom, dtype=dtype, device="cuda")
    n, band, K = {"probe P1": (131072, 64, 8), "probe P2": (1048576, 64, 8),
                  "ragged": (1000, 300, 9), "wide": (131072, 40000, 8)}[case]
    cols, vals = _banded(n, band, K)
    return ELLMatrix(cols, vals, dtype, "cuda")


def _x(A, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(A.n, generator=g, dtype=A.dtype).cuda()


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["probe P1", "karman 53k", "ragged", "wide"])
def test_direct_kernel_matches_plain(karman_level, case, dtype):
    A = _matrix(case, dtype, karman_level)
    x = _x(A)
    before = ell.ELL_DIRECT.launches
    y, y2 = A.apply_direct(x), A.apply_direct(x)
    torch.cuda.synchronize()
    assert ell.ELL_DIRECT.launches == before + 2
    assert torch.equal(y, y2)
    assert _rel(y, ell.ell_apply_plain(A.vals, A.cols, x)) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["probe P2", "karman 53k", "ragged"])
def test_window_kernel_matches_plain(karman_level, case, dtype):
    A = _matrix(case, dtype, karman_level)
    if case == "karman 53k" and dtype == torch.float64:
        # 53,392 doubles exceed a block's shared memory: the direct kernel's
        assert A.kernel == "direct"
        with pytest.raises(ValueError, match="does not fit"):
            A.apply_window(_x(A))
        return
    assert A.kernel == "window"
    x = _x(A)
    before = ell.ELL_WINDOW.launches
    y, y2 = A.apply(x), A.apply_window(x)
    torch.cuda.synchronize()
    assert ell.ELL_WINDOW.launches == before + 2
    assert torch.equal(y, y2)
    plain = ell.ell_apply_window_plain(A.vals, A.lidx, A.w0, x, A.W)
    assert _rel(y, plain) <= TOL[dtype]
    assert _rel(y, ell.ell_apply_plain(A.vals, A.cols, x)) <= TOL[dtype]


@pytest.mark.cuda
def test_cuda_matrix_never_runs_the_plain_apply(karman_level, monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("plain apply on the card")

    monkeypatch.setattr(ell, "ell_apply_plain", refuse)
    monkeypatch.setattr(ell, "ell_apply_window_plain", refuse)
    for case, kernel in (("probe P1", "window"), ("wide", "direct")):
        A = _matrix(case, torch.float32, karman_level)
        assert A.kernel == kernel
        counter = ell.ELL_WINDOW if kernel == "window" else ell.ELL_DIRECT
        before = counter.launches
        A.apply(_x(A))
        torch.cuda.synchronize()
        assert counter.launches == before + 1
        with pytest.raises(ValueError):
            A.apply(_x(A).cpu())  # a CPU vector on a card matrix
        with pytest.raises(ValueError):
            A.apply(_x(A).double())  # another dtype
