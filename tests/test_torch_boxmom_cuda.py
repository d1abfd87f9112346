# flow_tpu_torch.ops.boxmom on the card: the box stepper's momentum operator
# as the CUDA kernel (csrc/boxmom.cu) against its plain PyTorch version,
# BoxPack.momentum_apply on the tables of BoxPack.conv_tables, on the
# anisotropic box of tests/test_torch_boxpack.py, a 16^3 cube and a ragged
# box (partial tiles on every axis). Skips without a CUDA device. Imports no
# JAX, so it runs on the machine with the card:
#   python -m pytest --noconftest -q tests/test_torch_boxmom_cuda.py
# (tests/conftest.py imports JAX).
import numpy as np
import pytest
import torch

from flow_tpu_torch.fem.boxpack import BoxPack
from flow_tpu_torch.mesh3d import box_mesh
from flow_tpu_torch.ops import boxmom

torch.set_num_threads(1)

BOXES = {
    "aniso-4x5x6": ((0, 0, 0), (1.0, 1.1, 0.9), 4, 5, 6),
    "cube-16": ((0, 0, 0), (1.0, 1.0, 1.0), 16, 16, 16),
    "ragged-7x9x11": ((0, 0, 0), (0.7, 0.9, 1.1), 7, 9, 11),
}
# float64: the two versions differ by rounding alone (~1e-15 of max |y|).
# float32: each rounds every tet's ~6,100 products (eps 1.2e-7) in its own
# order, the kernel on the quadrature rules, the plain version on exact
# reference matrices; a copy of the kernel run on the CPU differs from the
# plain version by 1.8e-7 of max |y| at 16^3, so 2e-6 leaves ten times that.
TOL = {torch.float64: 1e-12, torch.float32: 2e-6}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _case(name, dtype, device, seed=7):
    bp = BoxPack(box_mesh(*BOXES[name], dtype=dtype, device=device))
    rng = np.random.default_rng(seed)
    X, T = (torch.as_tensor(rng.standard_normal(3 * bp.n2), dtype=dtype, device=device)
            for _ in range(2))
    return bp, X, T


def _scales(kind, dtype, device):
    if kind == "float":
        return 0.017, 0.6
    return (torch.tensor(0.017, dtype=dtype, device=device),
            torch.tensor(0.6, dtype=dtype, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(BOXES))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("scales", ["float", "tensor"])
def test_kernel_matches_plain_and_repeats(cuda_device, name, dtype, scales):
    bp, X, T = _case(name, dtype, cuda_device)
    s_mu, s_rho = _scales(scales, dtype, cuda_device)
    before = boxmom.BOX_MOMENTUM.launches
    y = boxmom.box_momentum_apply(bp, T, X, s_mu, s_rho)
    torch.cuda.synchronize()
    assert boxmom.BOX_MOMENTUM.launches == before + 1
    y_plain = bp.momentum_apply(bp.conv_tables(T), X, s_mu, s_rho)
    err = float((y - y_plain).abs().max() / y_plain.abs().max())
    assert err <= TOL[dtype], err
    assert torch.equal(boxmom.box_momentum_apply(bp, T, X, s_mu, s_rho), y)
    assert boxmom.BOX_MOMENTUM.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_operator_is_the_kernel(cuda_device, dtype):
    bp, X, T = _case("aniso-4x5x6", dtype, cuda_device)
    s_mu, s_rho = _scales("tensor", dtype, cuda_device)
    op = bp.momentum_operator(T, s_mu, s_rho)
    before = boxmom.BOX_MOMENTUM.launches
    y = op(X)
    assert boxmom.BOX_MOMENTUM.launches == before + 1
    assert torch.equal(y, boxmom.box_momentum_apply(bp, T, X, s_mu, s_rho))
    # float scales give the same operator as 0-d tensors of their value
    assert torch.equal(y, bp.momentum_operator(T, 0.017, 0.6)(X))


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    bp, X, T = _case("aniso-4x5x6", torch.float64, cuda_device)
    with pytest.raises(TypeError, match="float64"):
        boxmom.box_momentum_apply(bp, T, X.float(), 0.017, 0.6)
    wide = torch.zeros(2 * X.numel(), dtype=X.dtype, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        boxmom.box_momentum_apply(bp, T, wide[::2], 0.017, 0.6)
    with pytest.raises(ValueError, match="shape"):
        boxmom.box_momentum_apply(bp, T, X[1:], 0.017, 0.6)
    with pytest.raises(ValueError, match="one value"):
        boxmom.box_momentum_apply(bp, T, X, torch.ones(2, device=cuda_device), 0.6)


@pytest.mark.cuda
def test_box_stepper_on_the_card_matches_the_cpu(cuda_device):
    # the stepper's momentum solves go through the kernel on the card and
    # through the plain tables on the CPU: same iteration counts, the same
    # state to rounding (float64, three steps of the cavity at n = 6)
    from flow_tpu_torch import interop
    from flow_tpu_torch.models.cavity3d import Cavity3DProblem
    from flow_tpu_torch.navier_stokes.boxfast import BoxPackedStepper

    runs = {}
    lmax = None
    for device in ("cpu", "cuda"):
        prob = Cavity3DProblem(n=6, mu=0.01, dtype=torch.float64, device=device)
        st = BoxPackedStepper(prob.V, prob.Q, prob.u_bcs, prob.p_bcs, prob.rho, prob.mu,
                              newton_rtol=1e-2, pressure_rtol=1e-6, correction_rtol=1e-8)
        if lmax is None:
            lmax = [L.lmax for L in st.hierarchy.levels]
        else:
            interop.load_hierarchy_lmax(st.hierarchy, lmax)
        before = boxmom.BOX_MOMENTUM.launches
        Uf, Pf = st.zeros()
        Uf, Pf, _, tel = st.run(Uf, Pf, 2e-2, n_steps=3)
        runs[device] = (Uf.cpu(), tel, boxmom.BOX_MOMENTUM.launches - before)
    (U_c, tel_c, n_c), (U_g, tel_g, n_g) = runs["cpu"], runs["cuda"]
    assert n_c == 0 and n_g > 0
    for key in ("linear_iters", "pressure_iters", "correction_iters"):
        assert tel_g[key].tolist() == tel_c[key].tolist(), key
    assert float((U_g - U_c).abs().max()) <= 1e-10
