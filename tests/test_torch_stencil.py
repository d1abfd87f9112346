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


# The launch plans of the tiled kernels (plan_2d, plan_3d): every point of
# the grid is owned by exactly one block and thread, as the kernels index
# them (2-D: a block's `tile` columns, a thread each, down a strip of `rows`
# rows; 3-D: a block's (y, z) tile, a thread a point, along a chunk of
# `rows` planes), within the kernels' limits, on the main paths' level
# grids and on ragged ones (partial tiles, strips and chunks; sides 1-3).
_SMS = 132
_GRIDS_2D = [(2049, 2049), (1025, 1025), (513, 513), (257, 257), (129, 129), (65, 65),
             (1, 257), (257, 1), (7, 13), (1, 1), (2, 3), (3, 2), (1000, 777),
             (300000, 2)]
_GRIDS_3D = [(65, 65, 65), (33, 33, 33), (17, 17, 17), (5, 6, 7), (2, 7, 9), (1, 4, 3),
             (3, 1, 70), (1, 1, 1), (2, 2, 2), (3, 3, 3), (40, 30, 300), (6, 1, 1)]


def _owners_2d(shape, plan):
    # as stencil2d.cu indexes them: lanes 1-30 of each warp own a column
    X, Y = shape
    owned = np.zeros(shape, dtype=np.int64)
    tile, rows = plan.tile[1], plan.rows
    assert tile == plan.threads // 32 * 30
    lane = np.arange(plan.threads) % 32
    for bx in range(plan.grid[0]):
        j = bx * tile + np.arange(plan.threads) // 32 * 30 + lane - 1
        cols = j[(lane >= 1) & (lane <= 30) & (j < Y)]
        for by in range(plan.grid[1]):
            owned[by * rows:min((by + 1) * rows, X), cols] += 1
    return owned


def _owners_3d(shape, plan):
    X, Y, Z = shape
    owned = np.zeros(shape, dtype=np.int64)
    ty, tz = plan.tile
    assert ty * tz <= plan.threads
    for bz in range(plan.grid[2]):
        for by in range(plan.grid[1]):
            for bx in range(plan.grid[0]):
                owned[bz * plan.rows:min((bz + 1) * plan.rows, X),
                      by * ty:min((by + 1) * ty, Y), bx * tz:min((bx + 1) * tz, Z)] += 1
    return owned


@pytest.mark.parametrize("shape", _GRIDS_2D)
@pytest.mark.parametrize("sweep", [None, (32, 1), (128, 5), (256, 64)])
def test_plan_2d_covers_every_point_once(shape, sweep):
    tile, rows = sweep or (None, None)
    plan = stencil.plan_2d(*shape, _SMS, tile=tile, rows=rows)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 512
    assert plan.grid[1] <= 65535 and plan.grid[2] == 1 and plan.smem_items == 0
    if sweep is None and shape[1] > 30:
        # balanced tiles waste less than a warp's columns a tile
        assert plan.grid[0] * plan.tile[1] - shape[1] < 30 * plan.grid[0]
    np.testing.assert_array_equal(_owners_2d(shape, plan), 1)


@pytest.mark.parametrize("shape", _GRIDS_3D)
@pytest.mark.parametrize("sweep", [None, ((1, 65), 2), ((7, 33), 1), ((3, 5), 4)])
def test_plan_3d_covers_every_point_once(shape, sweep):
    tile, rows = sweep or (None, None)
    plan = stencil.plan_3d(*shape, _SMS, tile=tile, rows=rows)
    ty, tz = plan.tile
    cells = (ty + 2) * (tz + 2)
    assert plan.threads % 32 == 0 and plan.threads <= 256
    assert cells <= 4 * plan.threads and plan.smem_items == 3 * cells
    assert 8 * plan.smem_items <= 48 * 1024
    assert max(plan.grid[1:]) <= 65535
    np.testing.assert_array_equal(_owners_3d(shape, plan), 1)


def test_plans_fill_the_card_at_the_level_grids():
    # 2-D: STENCIL_BLOCKS_PER_SM blocks an SM, or strips as short as the rule
    # takes them; 3-D: one wave of STENCIL_BLOCKS_PER_SM blocks an SM at most
    want = stencil.STENCIL_BLOCKS_PER_SM * _SMS
    for shape in _GRIDS_3D[:2] + _GRIDS_2D[:5]:
        plan = stencil.plan(shape, _SMS)
        blocks = plan.grid[0] * plan.grid[1] * plan.grid[2]
        if len(shape) == 3:
            assert blocks <= want and plan.rows >= stencil.STENCIL3D_MIN_ROWS, (shape, plan)
        else:
            assert blocks >= want or plan.rows == stencil.STENCIL2D_MIN_ROWS, (shape, plan)


def test_plans_refuse_launches_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="plan_2d"):
        stencil.plan_2d(9, 9, _SMS, tile=48)
    with pytest.raises(ValueError, match="plan_2d"):
        stencil.plan_2d(9, 9, _SMS, tile=1024)
    with pytest.raises(ValueError, match="plan_3d"):
        stencil.plan_3d(9, 9, 300, _SMS, tile=(1, 300))


def test_launch_struct_mirrors_the_c_struct():
    # csrc/stencil.cuh's StencilArgs and ops/stencil.py's _StencilArgs: the
    # same fields in the same order and types
    import ctypes
    import re

    text = (_build.CSRC_DIR / "stencil.cuh").read_text()
    body = text[text.index("struct StencilArgs {"):text.index("};")]
    fields = []
    for decl in re.findall(r"^\s*(double|const void\*|int)\s+([^;]+);", body, re.M):
        ctype, names = decl
        for name in names.split(","):
            fields.append((ctype, name.strip()))
    want = [("const void*", "kdev")] + [
        ("int", n) for n in ("X", "Y", "Z", "rows", "tile_y", "tile_z", "grid_x", "grid_y",
                             "grid_z", "threads", "smem")]
    assert fields == want
    got = stencil._StencilArgs._fields_
    assert [n for n, _ in got] == [n for _, n in want]
    assert got[0][1] is ctypes.c_void_p
    assert all(t is ctypes.c_int for _, t in got[1:])


def test_launch_refuses_a_cpu_device():
    with pytest.raises(ValueError, match="CUDA device"):
        stencil.StencilLaunch(torch.ones(3, 3, dtype=torch.float64), (4, 5))
