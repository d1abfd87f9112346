# flow_tpu_torch.ops.stencil: the plain 27-point (K1) and 9-point (K2)
# stencils against the JAX package's Pallas kernels (interpret mode) and
# lax.conv, in float64 (1e-13: only the summation order differs), and the
# CPU wrappers' dispatch. The CUDA kernels' own tests are in
# tests/test_torch_stencil_cuda.py.
import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax import lax

from flow_tpu.ops.pallas_stencil import stencil_apply_2d as jax_stencil_apply_2d
from flow_tpu.ops.pallas_stencil import stencil_apply_3d as jax_stencil_apply_3d
from flow_tpu_torch import _build
from flow_tpu_torch.ops import stencil

torch.set_num_threads(1)


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape), rng.standard_normal((3,) * len(shape))


def _conv_ref(x, k):
    xg = jnp.asarray(x)[None, None]
    kk = jnp.asarray(k)[None, None]
    layout = ("NCHW", "OIHW", "NCHW") if x.ndim == 2 else ("NCDHW", "OIDHW", "NCDHW")
    dn = lax.conv_dimension_numbers(xg.shape, kk.shape, layout)
    return np.asarray(
        lax.conv_general_dilated(
            xg, kk, window_strides=(1,) * x.ndim, padding="SAME",
            dimension_numbers=dn, precision=lax.Precision.HIGHEST,
        )[0, 0]
    )


@pytest.mark.parametrize("shape", [(6, 8, 128), (3, 4, 5)])
def test_plain_matches_pallas_interpret(shape):
    x, k = _inputs(shape, 0)
    y = stencil.stencil_apply_3d_plain(torch.as_tensor(x), torch.as_tensor(k))
    y_ref = jax_stencil_apply_3d(jnp.asarray(x), jnp.asarray(k), interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=0, atol=1e-12)


# ragged and X < 3 grids too: the port does not depend on the Pallas
# kernel's clamp to a 3-plane window
@pytest.mark.parametrize(
    "shape", [(6, 8, 128), (3, 4, 5), (2, 7, 9), (1, 4, 3), (1, 1, 1)]
)
def test_plain_matches_conv(shape):
    x, k = _inputs(shape, 1)
    y = stencil.stencil_apply_3d_plain(torch.as_tensor(x), torch.as_tensor(k))
    np.testing.assert_allclose(y.numpy(), _conv_ref(x, k), rtol=0, atol=1e-12)


# K2: the 2-D kernel's parity with the Pallas kernel, including the
# 1-row and 1-column grids that its 3-row DMA window clamps
@pytest.mark.parametrize("shape", [(6, 128), (9, 9), (3, 5), (1, 7), (7, 1)])
def test_plain_2d_matches_pallas_interpret(shape):
    x, k = _inputs(shape, 3)
    y = stencil.stencil_apply_2d_plain(torch.as_tensor(x), torch.as_tensor(k))
    if shape[0] >= 3:
        y_ref = jax_stencil_apply_2d(jnp.asarray(x), jnp.asarray(k), interpret=True)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=0, atol=1e-13)
    np.testing.assert_allclose(y.numpy(), _conv_ref(x, k), rtol=0, atol=1e-13)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_wrapper_is_plain_and_launches_nothing(dtype):
    x, k = _inputs((5, 6, 7), 2)
    x = torch.as_tensor(x, dtype=dtype)
    k = torch.as_tensor(k, dtype=dtype)
    before = stencil.STENCIL_3D.launches
    y = stencil.stencil_apply_3d(x, k)
    assert torch.equal(y, stencil.stencil_apply_3d_plain(x, k))
    assert stencil.STENCIL_3D.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_wrapper_2d_is_plain_and_launches_nothing(dtype):
    x, k = _inputs((5, 6), 2)
    x = torch.as_tensor(x, dtype=dtype)
    k = torch.as_tensor(k, dtype=dtype)
    before = stencil.STENCIL_2D.launches
    y = stencil.stencil_apply_2d(x, k)
    assert torch.equal(y, stencil.stencil_apply_2d_plain(x, k))
    assert stencil.STENCIL_2D.launches == before


def test_wrapper_refuses_devices_without_a_kernel():
    x = torch.zeros((3, 3, 3), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        stencil.stencil_apply_3d(x, torch.zeros((3, 3, 3), device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        stencil.stencil_apply_2d(x[0], torch.zeros((3, 3), device="meta"))


def test_build_targets_hopper_from_package_sources():
    cmd = _build.nvcc_command("nvcc", "src.cu", "out.so")
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    assert "-shared" in cmd and "-fPIC" in cmd
    assert (_build.CSRC_DIR / "stencil3d.cu").is_file()
    assert (_build.CSRC_DIR / "stencil2d.cu").is_file()
    assert _build.BUILD_DIR.parent == _build.CSRC_DIR.parent
