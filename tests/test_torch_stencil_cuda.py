# flow_tpu_torch.ops.stencil on the card: the CUDA kernels (K1 27-point,
# K2 9-point) against their plain PyTorch versions on the main paths' grids
# and ragged ones. Skips without a CUDA device. Imports no JAX, so it runs on the machine with the card:
#   python -m pytest --noconftest -q tests/test_torch_stencil_cuda.py
# (tests/conftest.py imports JAX).
import numpy as np
import pytest
import torch

from flow_tpu_torch.ops import stencil

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape", [(65, 65, 65), (33, 33, 33), (17, 17, 17), (5, 6, 7), (2, 7, 9)]
)
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-13), (torch.float32, 1e-5)])
def test_cuda_kernel_matches_plain(cuda_device, shape, dtype, tol):
    rng = np.random.default_rng(3)
    x, k = rng.standard_normal(shape), rng.standard_normal((3, 3, 3))
    x = torch.as_tensor(x, dtype=dtype, device=cuda_device)
    k = torch.as_tensor(k, dtype=dtype, device=cuda_device)
    before = stencil.STENCIL_3D.launches
    y = stencil.stencil_apply_3d(x, k)
    torch.cuda.synchronize()
    assert stencil.STENCIL_3D.launches == before + 1
    y_plain = stencil.stencil_apply_3d_plain(x, k)
    err = float((y - y_plain).abs().max() / y_plain.abs().max())
    assert err <= tol


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape", [(2049, 2049), (65, 65), (1, 257), (257, 1), (1, 1), (7, 13), (2, 3)]
)
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-13), (torch.float32, 1e-5)])
def test_cuda_kernel_2d_matches_plain(cuda_device, shape, dtype, tol):
    rng = np.random.default_rng(4)
    x, k = rng.standard_normal(shape), rng.standard_normal((3, 3))
    x = torch.as_tensor(x, dtype=dtype, device=cuda_device)
    k = torch.as_tensor(k, dtype=dtype, device=cuda_device)
    before = stencil.STENCIL_2D.launches
    y = stencil.stencil_apply_2d(x, k)
    torch.cuda.synchronize()
    assert stencil.STENCIL_2D.launches == before + 1
    y_plain = stencil.stencil_apply_2d_plain(x, k)
    err = float((y - y_plain).abs().max() / y_plain.abs().max())
    assert err <= tol


@pytest.mark.cuda
def test_cuda_kernel_2d_refuses_what_it_does_not_take(cuda_device):
    x = torch.zeros((4, 5), device=cuda_device)
    with pytest.raises(TypeError, match="float32 or float64"):
        stencil.stencil_apply_2d(x, torch.zeros((3, 3), dtype=torch.float64,
                                                device=cuda_device))
    with pytest.raises(ValueError, match="contiguous"):
        stencil.stencil_apply_2d(x.t(), torch.zeros((3, 3), device=cuda_device))
    with pytest.raises(ValueError, match="2-D xgrid"):
        stencil.stencil_apply_2d(x[None], torch.zeros((3, 3), device=cuda_device))
