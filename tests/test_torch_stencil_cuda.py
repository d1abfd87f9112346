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


# The tiled kernels: every level grid of the main paths and ragged grids
# (partial tiles, strips and chunks; sides of 1, 2 and 3) against the plain
# versions, two calls bitwise equal, other tile plans bitwise equal to the
# rule's, and the operator's launch (StencilLaunch, fixed at construction)
# bitwise equal to the checked wrapper's.
_LEVELS = [(65, 65, 65), (33, 33, 33), (2049, 2049), (1025, 1025), (513, 513),
           (257, 257), (129, 129)]
_RAGGED = [(17, 17, 17), (5, 6, 7), (2, 7, 9), (1, 4, 3), (3, 1, 70), (1, 1, 1),
           (2, 2, 2), (3, 3, 3), (40, 30, 300), (65, 65), (1, 257), (257, 1), (7, 13),
           (2, 3), (3, 2), (1, 1), (1000, 777)]


def _apply(shape):
    return stencil.stencil_apply_3d if len(shape) == 3 else stencil.stencil_apply_2d


def _plain(shape):
    return (stencil.stencil_apply_3d_plain if len(shape) == 3
            else stencil.stencil_apply_2d_plain)


def _inputs(shape, dtype, device, seed=5):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal(shape), dtype=dtype, device=device)
    k = torch.as_tensor(rng.standard_normal((3,) * len(shape)), dtype=dtype, device=device)
    return x, k


@pytest.mark.cuda
@pytest.mark.parametrize("shape", _LEVELS + _RAGGED)
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-13), (torch.float32, 1e-5)])
def test_tiled_kernels_match_plain_and_repeat(cuda_device, shape, dtype, tol):
    x, k = _inputs(shape, dtype, cuda_device)
    y = _apply(shape)(x, k)
    y_plain = _plain(shape)(x, k)
    err = float((y - y_plain).abs().max() / y_plain.abs().max())
    assert err <= tol
    assert torch.equal(_apply(shape)(x, k), y)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,tile,rows", [
    ((65, 65, 65), (1, 65), 65), ((65, 65, 65), (3, 65), 2), ((65, 65, 65), (7, 33), 4),
    ((33, 33, 33), (3, 17), 3), ((17, 17, 17), (8, 8), 1), ((5, 6, 7), (1, 1), 1),
    ((2049, 2049), 256, 64), ((2049, 2049), 128, 5), ((1025, 1025), 32, 1),
    ((129, 129), 64, 3), ((1000, 777), 96, 7)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tile_plans_are_bitwise_equal(cuda_device, monkeypatch, shape, tile, rows, dtype):
    x, k = _inputs(shape, dtype, cuda_device)
    y = _apply(shape)(x, k)
    name = "plan_3d" if len(shape) == 3 else "plan_2d"
    rule = getattr(stencil, name)
    monkeypatch.setattr(stencil, name,
                        lambda *a, **kw: rule(*a, tile=tile, rows=rows))
    assert torch.equal(_apply(shape)(x, k), y)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", _LEVELS + [(5, 6, 7), (1, 1, 1), (257, 1), (7, 13)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_operator_launch_is_bitwise_the_wrapper(cuda_device, shape, dtype):
    x, k = _inputs(shape, dtype, cuda_device)
    launch = stencil.StencilLaunch(k, shape)
    kernel = stencil.STENCIL_3D if len(shape) == 3 else stencil.STENCIL_2D
    before, grid_before = kernel.launches, stencil.GRID_LAUNCHES[shape]
    y = launch(x.reshape(-1))
    assert kernel.launches == before + 1 and stencil.GRID_LAUNCHES[shape] == grid_before + 1
    assert y.shape == (x.numel(),)
    assert torch.equal(y.reshape(shape), _apply(shape)(x, k))
    with pytest.raises(ValueError, match="StencilLaunch"):
        launch(x.reshape(-1)[1:])
    with pytest.raises(ValueError, match="StencilLaunch"):
        launch(x.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [(16, 16), (8, 6, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_structured_laplacian_lean_call_is_bitwise_the_wrapper(cuda_device, n, dtype):
    from flow_tpu_torch.mesh import rectangle_mesh
    from flow_tpu_torch.mesh3d import box_mesh
    from flow_tpu_torch.ops.structured import StructuredLaplacian

    if len(n) == 2:
        mesh = rectangle_mesh((0, 0), (1.0, 0.7), *n, diagonal="right", dtype=dtype,
                              device=cuda_device)
    else:
        mesh = box_mesh((0, 0, 0), (1.0, 1.2, 0.8), *n, dtype=dtype, device=cuda_device)
    op = StructuredLaplacian(mesh)
    assert op.launch is not None
    x = torch.as_tensor(np.random.default_rng(6).standard_normal(op.n), dtype=dtype,
                        device=cuda_device)
    y = op(x)
    # the checked wrapper plus the boundary correction
    ref = _apply(op.grid)(x.reshape(op.grid), op.kernel).reshape(op.n)
    ref = ref.index_add_(0, op.bverts, torch.sum(op.tbl_val * x[op.tbl_idx], dim=1))
    assert torch.equal(y, ref)
    cpu = StructuredLaplacian(mesh, device="cpu")
    y_cpu = cpu(x.cpu())
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    assert float((y.cpu() - y_cpu).abs().max() / y_cpu.abs().max()) <= tol
