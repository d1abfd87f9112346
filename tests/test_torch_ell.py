# flow_tpu_torch.fem.ell and the assembly operators it rests on, against
# the JAX package on the CPU:
# - the plain version of the direct ELL kernel (P1) against the TPU probe's
#   reference formula jnp.einsum("nk,nk->n", vals, x[idx])
#   (scripts/pallas_gather_probe.py:57-59) on the probe's inputs cut to
#   4,096 rows (8 entries a row, banded within +-64 of the row, numpy seed
#   0), in float32 (1e-6 relative: another summation order) and float64
#   (1e-13);
# - the plain windowed apply (P2) with the probe's tables
#   (scripts/onehot_window_probe.py:67-72: one 128-aligned window a tile, a
#   window of one segment) and with the port's segmented tables, against
#   the same formula (the probes keep their kernels inside main(), so the
#   formula is restated);
# - the segmented tables on Karman levels (906 to 13,512 rows), a 3-D box
#   (N=16) and the probe's band: they cover every valid column with 32-
#   aligned segments and 16-bit indices, padding does not widen them, and
#   the windowed plain apply equals the direct one and the formula within
#   1e-13 in float64; a tile of 65,536 values is the last one they take;
# - ELLMatrix of ell_stiffness on a Karman level and a 3-D box against the
#   JAX package's ELLMatrix in its "row" and "lane" layouts, float64 at
#   1e-13 relative, through apply and the windowed plain apply;
# - ell_stiffness(coeff=), stiffness_apply(coeff=) (torch and numpy) and
#   mass_apply (scalar, vector, coeff) against JAX at 1e-12 relative;
# - the byte rule that picks the kernel: which levels of the Karman
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
from flow_tpu_torch.fem.ell import (WINDOW_FACTOR, WINDOW_SMEM_BYTES, ELLMatrix,
                                    ell_apply_plain,
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
    # a +-64 band: 256 values staged a tile for 1,024 entries
    assert A.kernel == "window" and A.staged_max == 256
    assert _rel(A.apply(t(x)), ref) <= RTOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_window_plain_matches_probe_formula(dtype):
    n, J, R, band = 4096, 8, 128, 64
    x, idx, vals = _probe_inputs(n, J, band)
    ref = _formula(vals, x, idx)
    t = lambda a: torch.as_tensor(a, dtype=dtype)
    # the probe's tables (onehot_window_probe.py:60-72): one window of W
    # values a tile, a segmented window of one segment
    W = ((R + 2 * band + 127 + 127) // 128) * 128
    nb = n // R
    idx_blk = idx.reshape(nb, R * J)
    w0 = (idx_blk.min(axis=1) // 128) * 128
    assert int((idx_blk.max(axis=1) - w0).max()) < W
    lidx = (idx_blk - w0[:, None]).reshape(n, J)
    one = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64)[:, None])
    got = ell_apply_window_plain(t(vals), torch.as_tensor(lidx), one(w0),
                                 one(np.minimum(W, n - w0)), one(np.zeros(nb)), t(x), R)
    assert _rel(got, ref) <= RTOL[dtype]
    # the port's segmented tables: a narrower window, the same apply
    tabs = ell_window_tables(idx)
    assert tabs.staged.max() <= W
    got = ell_apply_window_plain(t(vals), torch.as_tensor(tabs.lidx.view(np.int16)),
                                 *(torch.as_tensor(a) for a in
                                   (tabs.start, tabs.length, tabs.offset)), t(x))
    assert _rel(got, ref) <= RTOL[dtype]
    A = ELLMatrix(idx, vals, dtype, "cpu")
    assert A.staged_max == tabs.staged.max() and _rel(A.apply_window(t(x)), ref) <= RTOL[dtype]


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


@pytest.fixture(scope="module")
def karman_levels():
    """The P1 stiffness (local matrices) of the six levels of the Karman
    1.9M-DoF hierarchy (lcar=0.02 refined 0-5 times), by row count."""
    from flow_tpu_torch.mesh import rectangle_with_hole_mesh, refine_uniform
    from flow_tpu_torch.models.karman import OBSTACLE_CENTER, X0, X1, Y0, Y1

    mesh = rectangle_with_hole_mesh(X0, X1, Y0, Y1, cx=OBSTACLE_CENTER[0],
                                    cy=OBSTACLE_CENTER[1], r=0.02, lcar=0.02,
                                    device="cpu")
    levels = {}
    for _ in range(6):
        space = FunctionSpace(mesh, 1)
        levels[mesh.n_points] = (space, assembly.stiffness_local(
            space, assembly.geometry(mesh)))
        mesh = refine_uniform(mesh)
    return levels


def _operator(case, karman_levels):
    """(cols, vals, valid) of a test operator: a Karman level's P1
    stiffness, the P1 stiffness of a 3-D box at N=16, or the probes' banded
    rows (4,096 x 8 within +-64)."""
    if case.startswith("karman"):
        space, loc = karman_levels[int(case.split()[1])]
        A = ell_from_local(space, loc, dtype=torch.float64, device="cpu")
        return A.cols.numpy(), A.vals.numpy(), A.valid
    if case == "box 16":
        mesh = box_mesh((0, 0, 0), (1, 1, 1), 16, 16, 16, dtype=torch.float64,
                        device="cpu")
        A = ell_stiffness(FunctionSpace(mesh, 1), assembly.geometry(mesh),
                          dtype=torch.float64, device="cpu")
        return A.cols.numpy(), A.vals.numpy(), A.valid
    x, idx, vals = _probe_inputs()
    return idx, vals, None


OPERATORS = ["karman 906", "karman 3460", "karman 13512", "box 16", "probe"]


@pytest.mark.parametrize("case", OPERATORS)
def test_window_tables_cover_every_valid_column(karman_levels, case):
    cols, vals, valid = _operator(case, karman_levels)
    n, K = cols.shape
    valid = np.ones((n, K), bool) if valid is None else valid
    tabs = ell_window_tables(cols, valid)
    R = tabs.rows
    # 32-aligned segments (lengths clamped only at the end of x), in
    # ascending offsets that concatenate to each tile's window
    used = tabs.length > 0
    assert (tabs.start % 32 == 0).all() and (tabs.offset % 32 == 0).all()
    assert ((tabs.length % 32 == 0) | (tabs.start + tabs.length == n))[used].all()
    assert (np.diff(tabs.offset, axis=1) >= 0).all() and (tabs.offset[:, 0] == 0).all()
    assert (tabs.staged <= 65536).all()
    # every valid entry's 16-bit index points at its column in its tile
    r, k = np.nonzero(valid)
    t = r // R
    loc = tabs.lidx[r, k].astype(np.int64)
    g = (tabs.offset[t] <= loc[:, None]).sum(axis=1) - 1
    within = loc - tabs.offset[t, g]
    assert (within < tabs.length[t, g]).all()
    np.testing.assert_array_equal(tabs.start[t, g] + within, cols[r, k])
    assert (loc < tabs.staged[t]).all() and (tabs.lidx[~valid] == 0).all()
    # padding entries (col 0) do not widen a window
    padded = ell_window_tables(np.concatenate([cols, np.zeros((n, 2), np.int64)], 1),
                               np.concatenate([valid, np.zeros((n, 2), bool)], 1))
    for a, b in zip(padded[1:4], tabs[1:4]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(padded.staged, tabs.staged)


@pytest.mark.parametrize("case", OPERATORS)
def test_window_plain_matches_direct_plain(karman_levels, case):
    # float64, 1e-13: the windowed plain apply gathers the same values
    cols, vals, valid = _operator(case, karman_levels)
    x = np.random.default_rng(8).standard_normal(cols.shape[0])
    A = ELLMatrix(cols, vals, torch.float64, "cpu", valid=valid)
    got = A.apply_window(torch.as_tensor(x))
    assert _rel(got, A.apply(torch.as_tensor(x))) <= 1e-13
    assert _rel(got, _formula(vals, x, cols)) <= 1e-13


def test_window_tables_end_at_16_bits(monkeypatch):
    # a tile that stages exactly 65,536 values has indices up to 65,535,
    # which the plain windowed apply reads unsigned; one more chunk and the
    # tables do not exist
    n, R = 70000, 16384  # five tiles of R rows, 512 columns ~128 apart each
    j = (np.arange(n)[:, None] % 128) * 4 + np.arange(4)
    cols = j * 65535 // 511
    vals = np.random.default_rng(4).standard_normal((n, 4))
    monkeypatch.setattr("flow_tpu_torch.fem.ell.WINDOW_ROWS", R)
    tabs = ell_window_tables(cols)
    assert tabs.staged.max() == 65536 and int(tabs.lidx.max()) == 65535
    x = np.random.default_rng(5).standard_normal(n)
    got = ell_apply_window_plain(torch.as_tensor(vals),
                                 torch.as_tensor(tabs.lidx.view(np.int16)),
                                 *(torch.as_tensor(a) for a in
                                   (tabs.start, tabs.length, tabs.offset)),
                                 torch.as_tensor(x), rows=R)
    assert _rel(got, _formula(vals, x, cols)) <= 1e-13
    assert ell_window_tables(cols * 65567 // 65535) is None


def test_kernel_rule_on_the_karman_levels(karman_levels):
    # refine_uniform appends edge midpoints after the coarse vertices, so
    # a refined level's tile reads from all of it: its staged values serve
    # about one entry each, and the window's 2 bytes an entry do not pay
    # (0.98 bytes saved a byte staged at 3,460 rows in float32, 0.38 at
    # 212,256); only the two coarsest levels take the window
    got = {}
    for n, (space, loc) in karman_levels.items():
        got[n] = tuple(ell_from_local(space, loc, dtype=dt, device="cpu").kernel
                       for dt in (torch.float32, torch.float64))
    w, d = "window", "direct"
    assert got == {247: (w, w), 906: (w, d), 3460: (d, d), 13512: (d, d),
                   53392: (d, d), 212256: (d, d)}


def test_kernel_rule_by_window_span(spaces):
    # the byte model: the window pays where the 2 bytes an entry it saves
    # exceed the bytes it stages (WINDOW_FACTOR 1), so with many entries a
    # row over a narrow band, and in float32 before float64; the tiles of a
    # wide band stage more than a block's budget and have no window at all
    assert WINDOW_FACTOR == 1.0 and WINDOW_SMEM_BYTES == 112 * 1024
    expect = {  # (n, band, K) -> (f32 kernel, f64 kernel)
        (2048, 64, 3): ("direct", "direct"),  # 0.77 and 0.39 bytes saved a byte staged
        (2048, 64, 15): ("window", "window"),  # 3.87, 1.94
        (60000, 200, 9): ("window", "direct"),  # 1.06, 0.53
        (60000, 2000, 15): ("direct", "direct"),  # 0.24, 0.12
    }
    for (n, band, K), kernels in expect.items():
        cols, vals = _banded(n, band, K)
        mats = [ELLMatrix(cols, vals, dt, "cpu") for dt in (torch.float32, torch.float64)]
        assert tuple(A.kernel for A in mats) == kernels, (n, band, K)
        assert all(A.tables is not None for A in mats)
    cols, vals = _banded(60000, 20000, 15)
    A = ELLMatrix(cols, vals, torch.float32, "cpu")
    assert A.tables is None and A.kernel == "direct"
    with pytest.raises(ValueError, match="no segmented window"):
        A.apply_window(torch.zeros(60000))
    # padding entries (col 0) do not widen a window
    cols, vals = _banded(60000, 200, 9)
    valid = np.ones(cols.shape, dtype=bool)
    A = ELLMatrix(cols, vals, torch.float32, "cpu")
    cols, vals, valid = (np.concatenate([a, b], axis=1) for a, b in
                         ((cols, np.zeros((60000, 1), np.int64)),
                          (vals, np.zeros((60000, 1))),
                          (valid, np.zeros((60000, 1), bool))))
    P = ELLMatrix(cols, vals, torch.float32, "cpu", valid=valid)
    assert P.kernel == "window" and P.staged_bytes == A.staged_bytes
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(60000))
    P64 = ELLMatrix(cols, vals, torch.float64, "cpu", valid=valid)
    assert P64.kernel == "direct"
    ref = _formula(vals, x.numpy(), cols)
    assert _rel(P64.apply(x), ref) <= 1e-13 and _rel(P64.apply_window(x), ref) <= 1e-13
