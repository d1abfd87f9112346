# flow_tpu_torch.fem.ell and the assembly operators it rests on, against
# the JAX package on the CPU:
# - the plain version of the direct ELL kernel (P1) against the TPU probe's
#   reference formula jnp.einsum("nk,nk->n", vals, x[idx])
#   (scripts/pallas_gather_probe.py:57-59) on the probe's inputs cut to
#   4,096 rows (8 entries a row, banded within +-64 of the row, numpy seed
#   0), in float32 (1e-6 relative: another summation order) and float64
#   (1e-13);
# - the plain windowed apply (P2) with w0/lidx built as
#   scripts/onehot_window_probe.py:67-72 builds them (128-aligned windows)
#   and with the port's own 32-aligned tables, against the same formula (the
#   probes keep their kernels inside main(), so the formula is restated);
# - ELLMatrix of ell_stiffness on a Karman level and a 3-D box against the
#   JAX package's ELLMatrix in its "row" and "lane" layouts, float64 at
#   1e-13 relative, through apply and the windowed plain apply;
# - ell_stiffness(coeff=), stiffness_apply(coeff=) (torch and numpy) and
#   mass_apply (scalar, vector, coeff) against JAX at 1e-12 relative;
# - the shape rule that picks the kernel: which levels of the Karman
#   1.9M-DoF hierarchy (247 to 212,256 rows) and which banded matrices
#   ELLMatrix marks "window" in float32 and in float64.
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from flow_tpu.fem import assembly as jax_assembly
from flow_tpu.fem import ell as jax_ell
from flow_tpu.fem.spaces import FunctionSpace as JaxFunctionSpace
from flow_tpu.mesh3d import box_mesh as jax_box_mesh
from flow_tpu.models.karman import KarmanProblem as JaxKarman
from flow_tpu_torch.fem import assembly
from flow_tpu_torch.fem.ell import (SMEM_BYTES, ELLMatrix, ell_apply_plain,
                                    ell_apply_window_plain, ell_from_local,
                                    ell_stiffness, ell_window_tables)
from flow_tpu_torch.fem.spaces import FunctionSpace
from flow_tpu_torch.mesh3d import box_mesh
from flow_tpu_torch.models.karman import KarmanProblem

torch.set_num_threads(1)

RTOL = {torch.float32: 1e-6, torch.float64: 1e-13}


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _probe_inputs(n=4096, J=8, band=64):
    """The probes' inputs (seeded as they are) at n rows."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(n)
    base = np.arange(n)[:, None]
    idx = np.clip(base + rng.integers(-band, band, size=(n, J)), 0, n - 1)
    vals = rng.standard_normal((n, J))
    return x, idx, vals


def _formula(vals, x, idx):
    return np.asarray(jnp.einsum("nk,nk->n", jnp.asarray(vals), jnp.asarray(x)[idx]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_direct_plain_matches_probe_formula(dtype):
    x, idx, vals = _probe_inputs()
    ref = _formula(vals, x, idx)
    t = lambda a: torch.as_tensor(a, dtype=dtype)
    got = ell_apply_plain(t(vals), torch.as_tensor(idx), t(x))
    assert _rel(got, ref) <= RTOL[dtype]
    A = ELLMatrix(idx, vals, dtype, "cpu")
    assert A.kernel == "window"  # a +-64 band fits any block's window
    assert _rel(A.apply(t(x)), ref) <= RTOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_window_plain_matches_probe_formula(dtype):
    n, J, R, band = 4096, 8, 128, 64
    x, idx, vals = _probe_inputs(n, J, band)
    ref = _formula(vals, x, idx)
    t = lambda a: torch.as_tensor(a, dtype=dtype)
    # the probe's tables (onehot_window_probe.py:60-72)
    W = ((R + 2 * band + 127 + 127) // 128) * 128
    nb = n // R
    idx_blk = idx.reshape(nb, R * J)
    w0 = (idx_blk.min(axis=1) // 128) * 128
    assert int((idx_blk.max(axis=1) - w0).max()) < W
    lidx = (idx_blk - w0[:, None]).reshape(n, J)
    got = ell_apply_window_plain(t(vals), torch.as_tensor(lidx), torch.as_tensor(w0),
                                 t(x), W)
    assert _rel(got, ref) <= RTOL[dtype]
    # the port's 32-aligned tables: a narrower window, the same apply
    w0p, lidxp, Wp = ell_window_tables(idx)
    assert Wp <= W and (w0p % 32 == 0).all() and (lidxp < Wp).all()
    got = ell_apply_window_plain(t(vals), torch.as_tensor(lidxp), torch.as_tensor(w0p),
                                 t(x), Wp)
    assert _rel(got, ref) <= RTOL[dtype]
    A = ELLMatrix(idx, vals, dtype, "cpu")
    assert A.W == Wp and _rel(A.apply_window(t(x)), ref) <= RTOL[dtype]


@pytest.fixture(scope="module")
def spaces():
    """(JAX space, port space) pairs: the P1 and P2 spaces of a Karman
    level and the P1 space of a 3-D box."""
    jk = JaxKarman(lcar=0.1, n_refine=1)
    tk = KarmanProblem(lcar=0.1, n_refine=1, dtype=torch.float64, device="cpu")
    jb = jax_box_mesh((0, 0, 0), (1, 1, 1), 3, 3, 3)
    tb = box_mesh((0, 0, 0), (1, 1, 1), 3, 3, 3, dtype=torch.float64, device="cpu")
    return {
        "karman P1": (JaxFunctionSpace(jk.mesh, 1), tk.Q),
        "karman P2": (jk.V, tk.V),
        "box P1": (JaxFunctionSpace(jb, 1), FunctionSpace(tb, 1)),
    }


@pytest.mark.parametrize("layout", ["row", "lane"])
@pytest.mark.parametrize("name", ["karman P1", "box P1"])
def test_ell_stiffness_matches_jax_layouts(spaces, name, layout, monkeypatch):
    js, ts = spaces[name]
    monkeypatch.setenv("FLOW_ELL_LAYOUT", layout)
    jK = jax_ell.ell_stiffness(js, jax_assembly.geometry(js.mesh))
    assert jK.layout == layout
    K = ell_stiffness(ts, assembly.geometry(ts.mesh), dtype=torch.float64, device="cpu")
    assert (K.n, K.width) == (jK.n, jK.width)
    x = np.random.default_rng(2).standard_normal(K.n)
    ref = np.asarray(jK.apply(jnp.asarray(x)))
    assert _rel(K.apply(torch.as_tensor(x)), ref) <= 1e-13
    assert K.kernel == "window"
    assert _rel(K.apply_window(torch.as_tensor(x)), ref) <= 1e-13


@pytest.mark.parametrize("name", ["karman P1", "box P1", "karman P2"])
def test_coefficient_operators_match_jax(spaces, name):
    js, ts = spaces[name]
    rng = np.random.default_rng(4)
    nc = ts.mesh.n_cells
    c = 0.5 + rng.random(nc)
    hg, jg = assembly.geometry(ts.mesh), jax_assembly.geometry(js.mesh)
    dg = assembly.geometry_on(ts.mesh, torch.float64, "cpu")
    n = ts.n_dofs
    x = rng.standard_normal(n)
    jK = jax_ell.ell_stiffness(js, jg, coeff=jnp.asarray(c))
    K = ell_stiffness(ts, hg, coeff=c, dtype=torch.float64, device="cpu")
    assert _rel(K.apply(torch.as_tensor(x)), jK.apply(jnp.asarray(x))) <= 1e-12
    # the JAX stiffness takes a per-cell coefficient, its mass a constant too
    for coeff in (None, c, 2.5):
        jc = None if coeff is None else jnp.asarray(coeff)
        tc = None if coeff is None else torch.as_tensor(coeff)
        if not np.isscalar(coeff):
            ref = jax_assembly.stiffness_apply(js, jg, jnp.asarray(x), coeff=jc)
            got = assembly.stiffness_apply(ts, dg, torch.as_tensor(x), coeff=tc)
            assert _rel(got, ref) <= 1e-12
            assert _rel(assembly.stiffness_apply(ts, hg, x, coeff=coeff), ref) <= 1e-12
        for X in (x, rng.standard_normal((n, 3))):
            ref = jax_assembly.mass_apply(js, jg, jnp.asarray(X), coeff=jc)
            got = assembly.mass_apply(ts, dg, torch.as_tensor(X), coeff=tc)
            assert _rel(got, ref) <= 1e-12


def _banded(n, band, K=3, seed=5):
    rng = np.random.default_rng(seed)
    cols = np.clip(np.arange(n)[:, None] + rng.integers(-band, band + 1, (n, K)),
                   0, n - 1)
    cols[:, 0] = np.arange(n)
    return cols, rng.standard_normal((n, K))


def test_kernel_rule_on_the_karman_levels():
    # refine_uniform appends edge midpoints after the coarse vertices, so a
    # refined level's 128-row block spans all of it: in f32 every level up
    # to 53,392 rows fits a window, in f64 up to 13,512; the 212,256-row
    # level (the 1.9M-DoF pressure operator) takes the direct kernel
    from flow_tpu_torch.mesh import rectangle_with_hole_mesh, refine_uniform
    from flow_tpu_torch.models.karman import OBSTACLE_CENTER, X0, X1, Y0, Y1

    mesh = rectangle_with_hole_mesh(X0, X1, Y0, Y1, cx=OBSTACLE_CENTER[0],
                                    cy=OBSTACLE_CENTER[1], r=0.02, lcar=0.02,
                                    device="cpu")
    got = {}
    for _ in range(6):
        loc = assembly.stiffness_local(FunctionSpace(mesh, 1), assembly.geometry(mesh))
        got[mesh.n_points] = tuple(
            ell_from_local(FunctionSpace(mesh, 1), loc, dtype=dt, device="cpu").kernel
            for dt in (torch.float32, torch.float64))
        mesh = refine_uniform(mesh)
    w, d = "window", "direct"
    assert got == {247: (w, w), 906: (w, w), 3460: (w, w), 13512: (w, w),
                   53392: (w, d), 212256: (d, d)}


def test_kernel_rule_by_window_span(spaces):
    # f32 takes windows of up to 58,112 values, f64 of up to 29,056
    assert SMEM_BYTES // 4 == 58112 and SMEM_BYTES // 8 == 29056
    expect = {  # (n, band) -> (f32 kernel, f64 kernel)
        (2048, 64): ("window", "window"),
        (60000, 20000): ("window", "direct"),
        (60000, 40000): ("direct", "direct"),
    }
    for (n, band), kernels in expect.items():
        cols, vals = _banded(n, band)
        got = tuple(ELLMatrix(cols, vals, dt, "cpu").kernel
                    for dt in (torch.float32, torch.float64))
        assert got == kernels, (n, band)
    # padding entries (col 0) do not widen a block's window
    cols, vals = _banded(60000, 20000)
    valid = np.ones(cols.shape, dtype=bool)
    cols, vals, valid = (np.concatenate([a, b], axis=1) for a, b in
                         ((cols, np.zeros((60000, 1), np.int64)),
                          (vals, np.zeros((60000, 1))),
                          (valid, np.zeros((60000, 1), bool))))
    A = ELLMatrix(cols, vals, torch.float32, "cpu", valid=valid)
    assert A.kernel == "window"
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(60000))
    A64 = ELLMatrix(cols, vals, torch.float64, "cpu", valid=valid)
    assert A64.kernel == "direct"
    ref = _formula(vals, x.numpy(), cols)
    assert _rel(A64.apply(x), ref) <= 1e-13
