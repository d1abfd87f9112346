# The ELL kernels of flow_tpu_torch on the card (csrc/ell.cu): the direct
# kernel (P1) and the windowed kernel (P2) against their plain PyTorch
# versions (fem/ell.py ell_apply_plain, ell_apply_window_plain) at the TPU
# probes' shapes (131,072 x 8 and 1,048,576 x 8, banded within +-64), at
# the P1 stiffness of the Karman hierarchy's 53,392-row level and of a 3-D
# box (N=32), at a band too wide for any window and at a row count that is
# no multiple of 128; the windowed kernel bitwise equal to the direct one,
# also at a window of 57,344 values (16-bit indices past 32,767); bitwise
# repeatable; and a CUDA matrix never running the plain apply. Tolerance: another summation order,
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
from flow_tpu_torch.mesh3d import box_mesh

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
    if case == "box 3-D":
        mesh = box_mesh((0, 0, 0), (1, 1, 1), 32, 32, 32, device="cpu")
        return ell_stiffness(FunctionSpace(mesh, 1), assembly.geometry(mesh),
                             dtype=dtype, device="cuda")
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
@pytest.mark.parametrize("case", ["probe P2", "karman 53k", "ragged", "box 3-D"])
def test_window_kernel_matches_plain(karman_level, case, dtype):
    # the segmented windows exist at every case in both dtypes, whichever
    # kernel the rule picks; the windowed kernel sums the direct kernel's
    # products in its order, so the two agree bitwise
    A = _matrix(case, dtype, karman_level)
    assert A.tables is not None
    x = _x(A)
    before = ell.ELL_WINDOW.launches
    y, y2 = A.apply_window(x), A.apply_window(x)
    torch.cuda.synchronize()
    assert ell.ELL_WINDOW.launches == before + 2 and A.launches["window"] == 2
    assert torch.equal(y, y2)
    assert torch.equal(y, A.apply_direct(x))
    # an x that starts off the 16-byte alignment the bulk copies need
    assert torch.equal(A.apply_window(torch.cat([x.new_zeros(1), x])[1:]), y)
    plain = ell.ell_apply_window_plain(A.vals, A.lidx, A.seg_start, A.seg_len,
                                       A.seg_off, x, A.tables.rows)
    assert _rel(y, plain) <= TOL[dtype]
    assert _rel(y, ell.ell_apply_plain(A.vals, A.cols, x)) <= TOL[dtype]
    # apply launches the rule's kernel
    A.apply(x)
    assert A.launches[A.kernel] == (4 if A.kernel == "window" else 2)


@pytest.mark.cuda
def test_window_kernel_at_the_shared_memory_edge(monkeypatch):
    # a tile whose window spans 57,344 float32 values (224 KB, nearly all a
    # block may opt in to): local indices above 32,767 are read unsigned;
    # at the module's budget (two blocks an SM) the same matrix has no
    # window and takes the direct kernel
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (CUDA kernel has no CPU mode)")
    n, span = 60000, 57344
    j = (np.arange(n)[:, None] % 128) * 4 + np.arange(4)  # 512 columns a tile,
    cols = j * (span - 1) // 511  # ~112 apart: one segment [0, span)
    vals = np.random.default_rng(3).standard_normal((n, 4))
    A = ELLMatrix(cols, vals, torch.float32, "cuda")
    assert A.tables is None and A.kernel == "direct"
    with pytest.raises(ValueError, match="no segmented window"):
        A.apply_window(_x(A))
    monkeypatch.setattr(ell, "WINDOW_SMEM_BYTES", 4 * span)
    A = ELLMatrix(cols, vals, torch.float32, "cuda")
    assert A.staged_max == span and int(A.tables.lidx.max()) > 32767
    x = _x(A)
    y = A.apply_window(x)
    torch.cuda.synchronize()
    assert torch.equal(y, A.apply_direct(x))
    plain = ell.ell_apply_window_plain(A.vals, A.lidx, A.seg_start, A.seg_len,
                                       A.seg_off, x, A.tables.rows)
    assert _rel(y, plain) <= TOL[torch.float32]


@pytest.mark.cuda
def test_cuda_matrix_never_runs_the_plain_apply(karman_level, monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("plain apply on the card")

    monkeypatch.setattr(ell, "ell_apply_plain", refuse)
    monkeypatch.setattr(ell, "ell_apply_window_plain", refuse)
    for case, kernel in (("box 3-D", "window"), ("karman 53k", "direct"),
                         ("wide", "direct")):
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
