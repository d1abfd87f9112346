# flow_tpu_torch.attic.window and attic.winkernel against the JAX package:
# the window layouts must equal the JAX package's exactly (same RCM
# permutation, buckets and tables), the scatter lists of the CUDA kernels
# must reproduce the plain scatter, and the plain version of the window
# stiffness kernel (K4b) must match the JAX Pallas kernel run in interpret
# mode at the JAX package's own tolerance (rtol 3e-5: both compute in
# float32, in another summation order). The cluster kernels' walk (K4b 3-D
# P1 and P2, K4b 2-D P2, K4a, K5 and K3 3-D lagged and Newton: their launch
# plans, the inverse lists of scatter_positions, K3 3-D's three components a
# position and compressed rows, the passes) is replayed in numpy on tiny
# layouts and must sum every row in list order; the compressed rows must
# give back the scatter lists, and K3 3-D's plan must stage a window block
# of the cavity's layouts in one pass.
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from flow_tpu.attic.window import build_window_layout as jax_layout
from flow_tpu.attic.winkernel import WindowStiffnessOperator as JaxStiffness
from flow_tpu.fem.spaces import FunctionSpace as JaxFunctionSpace
from flow_tpu.models.karman import KarmanProblem as JaxKarman
from flow_tpu_torch.attic.window import (build_scatter_lists,
                                         build_window_layout, compact_lists,
                                         overlap_add_fn, position_lists,
                                         scatter_positions)
from flow_tpu_torch.attic import winform, winkernel, winmom
from flow_tpu_torch.attic.winkernel import (WindowStiffnessOperator, cluster_plan,
                                            stiffness_windows_plain)
from flow_tpu_torch.fem import assembly
from flow_tpu_torch.fem.ell import ell_stiffness
from flow_tpu_torch.fem.spaces import FunctionSpace, VectorFunctionSpace
from flow_tpu_torch.mesh import unit_square_mesh
from flow_tpu_torch.mesh3d import box_mesh
from flow_tpu_torch.models.karman import KarmanProblem

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def problems():
    return (JaxKarman(lcar=0.1, n_refine=1),
            KarmanProblem(lcar=0.1, n_refine=1, dtype=torch.float64, device="cpu"))


def _spaces(problems, name):
    jp, tp = problems
    return (jp.V, tp.V) if name == "V" else (jp.Q, tp.Q)


@pytest.mark.parametrize("space", ["V", "Q"])
@pytest.mark.parametrize("S", [None, 128])
def test_window_layout_equals_jax(problems, space, S):
    js, ts = _spaces(problems, space)
    jw, tw = jax_layout(js, S=S), build_window_layout(ts, S=S)
    assert (tw.S, tw.W, tw.nb, tw.C) == (jw.S, jw.W, jw.nb, jw.C)
    for name in ("perm", "inv", "cells", "valid", "lidx"):
        np.testing.assert_array_equal(getattr(tw, name), np.asarray(getattr(jw, name)),
                                      err_msg=name)
    assert tw.n_pad == jw.n_pad


@pytest.mark.parametrize("chunk", [0, 7])
def test_scatter_lists_reproduce_plain_scatter(problems, chunk):
    # the kernels sum each window dof along its list, in chunks of cells;
    # replayed here in numpy, the result must be the plain scatter's
    _, ts = problems
    wl = build_window_layout(ts.V, S=128)
    rowptr, ent = build_scatter_lists(wl)
    nb, C, nl = wl.lidx.shape
    rng = np.random.default_rng(6)
    loc = rng.standard_normal((nb, C * nl)).astype(np.float32)
    ch = C if chunk == 0 else chunk
    out = np.zeros((nb, wl.W), dtype=np.float32)
    for b in range(nb):
        for c0 in range(0, C, ch):
            e0, e1 = c0 * nl, min(C, c0 + ch) * nl
            for w in range(wl.W):
                row = ent[b, rowptr[b, w]:rowptr[b, w + 1]]
                part = np.float32(0.0)
                for e in row[(row >= e0) & (row < e1)]:
                    part += loc[b, e]
                out[b, w] = part if c0 == 0 else out[b, w] + part
    # every real (cell, local dof) appears once, in ascending order per row
    assert rowptr[:, -1].tolist() == (wl.valid.sum(axis=1) * nl).astype(int).tolist()
    ref = np.zeros((nb, wl.W))
    lidx = wl.lidx.reshape(nb, C * nl)
    masked = loc * np.repeat(wl.valid, nl, axis=1)
    for b in range(nb):
        np.add.at(ref[b], lidx[b], masked[b])
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_overlap_add_matches_jax(problems):
    js, ts = _spaces(problems, "V")
    jw, tw = jax_layout(js, S=128), build_window_layout(ts, S=128)
    wins = np.random.default_rng(7).standard_normal((tw.nb, tw.W))
    y = overlap_add_fn(torch.as_tensor(wins), tw.S, tw.W, tw.n)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jw.overlap_add(jnp.asarray(wins), jnp)))


def test_window_stiffness_plain_matches_jax_interpret(problems):
    jp, tp = problems
    jQ = JaxFunctionSpace(jp.mesh, 1)
    jop = JaxStiffness(jQ, S=128, interpret=True)
    op = WindowStiffnessOperator(tp.Q, S=128)
    x = np.random.default_rng(3).standard_normal(tp.Q.n_dofs)
    got = op.apply(torch.as_tensor(x)).numpy()
    ref = np.asarray(jop.apply(jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, rtol=3e-5, atol=1e-5)
    # and the port's own float64 assembled stiffness, at float32 level
    K = ell_stiffness(tp.Q, assembly.geometry(tp.mesh), dtype=torch.float64,
                      device="cpu")
    np.testing.assert_allclose(got, K.apply(torch.as_tensor(x)).numpy(),
                               rtol=3e-5, atol=1e-5)


def test_stiffness_windows_plain_masks_padding(problems):
    # a masked cell (padding repeats a real cell) adds exactly nothing
    _, tp = problems
    op = WindowStiffnessOperator(tp.Q, S=128)
    x_pad = torch.zeros(op.wl.n_pad, dtype=torch.float32)
    x_pad[:op.wl.n] = torch.randn(op.wl.n, generator=torch.Generator().manual_seed(0))
    valid0 = torch.zeros_like(op.valid)
    wins = stiffness_windows_plain(x_pad, op.lidx, valid0, op.Cg, op.kref,
                                   op.wl.S, op.wl.W)
    assert float(wins.abs().max()) == 0.0


def test_wrapper_refuses_devices_without_a_kernel(problems):
    _, tp = problems
    op = WindowStiffnessOperator(tp.Q, S=128)
    with pytest.raises(ValueError, match="no kernel for device"):
        op.windows(torch.zeros(op.wl.n_pad, device="meta"))


def _row_sums(vals, rp):
    """Each row's values vals[rp[w]:rp[w+1]] summed in order in float32."""
    start, length = rp[:-1], np.diff(rp)
    acc = np.zeros(len(length), dtype=np.float32)
    for k in range(int(length.max(initial=0))):
        m = length > k
        acc[m] += vals[start[m] + k]
    return acc


_WALK_SPACES = {  # NL -> a tiny mesh and degree
    3: (lambda: unit_square_mesh(8, "crossed", dtype=torch.float32, device="cpu"), 1),
    6: (lambda: unit_square_mesh(6, "crossed", dtype=torch.float32, device="cpu"), 2),
    4: (lambda: box_mesh((0, 0, 0), (1, 1, 1), 3, 3, 3, dtype=torch.float32,
                         device="cpu"), 1),
    10: (lambda: box_mesh((0, 0, 0), (1, 1, 1), 2, 2, 2, dtype=torch.float32,
                          device="cpu"), 2),
}
_WALK_CASES = (
    [pytest.param("stiffness", 4, cl, loc_bytes, id=f"{cl}-{loc_bytes}")
     for cl, loc_bytes in ((8, None), (2, 4 * 300), (3, 4 * 40))]
    + [pytest.param(kind, NL, None, loc_bytes,
                    id=f"{kind}-NL{NL}-{'rule' if loc_bytes is None else 'passes'}")
       for kind, nls in (("mass", (3, 4, 6, 10)), ("element", (3, 4, 6, 10)),
                         ("stiffness", (6, 10)), ("momentum", (10,)),
                         ("momentum_newton", (10,)))
       for NL in nls for loc_bytes in (None, 4 * 40)])


def _replay_walk(loc, pos, rp, rows, cl, cap, W):
    """csrc/wincluster.cuh's walk over one window block in numpy: local
    results loc [NC, NL, C] (NC values a position), their list positions
    pos [NL, C], and rp [R + 1] the positions of the rows summed: every row
    (rows None) or the compressed rows `rows` [R] (padded with W), after the
    window's zeros. Passes over whole rows of at most cl * cap positions;
    position q of a pass of n is staged at [q // Q, :, q % Q] (Q = n / cl:
    block, component plane, offset) and the rows read their positions in
    list order across the blocks' arrays. Returns the windows [NC, W] and
    the passes."""
    NC = loc.shape[0]
    R = len(rp) - 1
    ids = np.arange(R) if rows is None else rows
    out = np.zeros((NC, W), dtype=np.float32)
    r0, passes = 0, 0
    while r0 < R:
        e0 = int(rp[r0])
        r1 = (R if rp[-1] - e0 <= cl * cap
              else int(np.searchsorted(rp, e0 + cl * cap, side="right")) - 1)
        assert r1 > r0
        n = int(rp[r1]) - e0
        Q = -(-n // cl)
        staged = np.full((cl, NC, Q), np.nan, dtype=np.float32)
        q = pos - e0
        m = (q >= 0) & (q < n)
        staged[q[m] // Q, :, q[m] % Q] = loc[:, m].T
        real = ids[r0:r1] < W
        for c in range(NC):
            sums = _row_sums(staged[:, c, :].reshape(-1), rp[r0:r1 + 1] - e0)
            out[c, ids[r0:r1][real]] = sums[real]
        r0, passes = r1, passes + 1
    return out, passes


def _momentum_walk_case(newton, rng):
    """K3 3-D on the box_mesh 2x2x2 P2 layout: (operator, x_pad, its local
    results [DIM, nb, NL, C] and the plain windows [DIM, nb, W])."""
    V = VectorFunctionSpace(box_mesh((0, 0, 0), (1, 1, 1), 2, 2, 2, dtype=torch.float32,
                                     device="cpu"), 2, n_components=3)
    op = winmom.WindowLaggedMomentum(V, S=128, device="cpu")
    wl = op.wl
    nb = op.lidx.shape[0]
    x = torch.as_tensor(rng.standard_normal((V.n_dofs, 3)), dtype=torch.float32)
    Tq, Uq, Gu = op.state_qp(x)
    extra = (Uq, Gu) if newton else ()
    x_pad = torch.zeros((3, wl.n_pad))
    x_pad[:, :wl.n] = torch.as_tensor(rng.standard_normal((3, wl.n)), dtype=torch.float32)
    scal = op._scal(1.0, 0.37, 0.021)
    U = x_pad[:, (torch.arange(nb)[:, None, None] * wl.S + op.lidx).long()]
    loc = winmom.momentum_local_plain(U, op.valid, op.detj, op.G4, op.Cg4, Tq, op.tabs,
                                      scal, *extra)
    plain = winmom.momentum_windows_plain(x_pad, op.lidx, op.valid, op.detj, op.G4,
                                          op.Cg4, Tq, op.tabs, scal, wl.S, wl.W, *extra)
    return op, loc.numpy(), plain


@pytest.mark.parametrize("kind, NL, cl, loc_bytes", _WALK_CASES)
def test_cluster_walk_reproduces_plain(kind, NL, cl, loc_bytes, monkeypatch):
    # the cluster kernels' walk (csrc/wincluster.cuh) replayed in numpy:
    # K4b 3-D P1 on a box layout (N=4) at the given cluster sizes and staging
    # budgets, K4a and K5 on tiny layouts of every NL and K4b P2 at NL = 6
    # and 10 at their wrapper's rule (window_plan, on a card of 132 SMs) and
    # at a budget that forces passes. Passes over whole rows of at most cl * cap staged values,
    # each cell's local results stored at their list positions
    # (scatter_positions) in the array of the block that stages them, each
    # row summed along its positions in order; the windows equal a
    # one-pass walk of the lists bitwise and the plain version within
    # float32 rounding
    # K3 3-D lagged and Newton on the box_mesh 2x2x2 P2 layout at
    # momentum_plan's rule and at a budget that forces passes, with three
    # components a position and the compressed rows of compact_lists
    rng = np.random.default_rng(9)
    if kind.startswith("momentum"):
        op, loc, plain = _momentum_walk_case(kind == "momentum_newton", rng)
        nb, NL, C = op.lidx.shape
        W = op.wl.W
        if loc_bytes is not None:
            monkeypatch.setattr(winkernel, "MOMENTUM_LOC_BYTES", 3 * loc_bytes)
        cl, threads, cap = winkernel.momentum_plan(nb, C, NL, 132)
        assert cl <= winkernel.MAX_CLUSTER and threads == winkernel.MOMENTUM_THREADS
        rowptr, ent = build_scatter_lists(op.wl)
        rptr, rows, pos = compact_lists(op.wl)
        out = np.zeros((3, nb, W), dtype=np.float32)
        one = np.zeros((3, nb, W), dtype=np.float32)
        most = 0
        for b in range(nb):
            out[:, b], passes = _replay_walk(loc[:, b], pos[b].reshape(NL, C), rptr[b],
                                             rows[b], cl, cap, W)
            most = max(most, passes)
            flat = loc[:, b].transpose(0, 2, 1).reshape(3, -1)  # entry c*NL + i
            for m in range(3):
                one[m, b] = _row_sums(flat[m, ent[b, :rowptr[b, -1]]], rowptr[b])
        assert (most > 1) == (loc_bytes is not None)
        np.testing.assert_array_equal(out, one)
        np.testing.assert_allclose(out, plain.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(plain.abs().max()))
        return
    p1_3d = kind == "stiffness" and NL == 4
    if p1_3d:
        mesh = box_mesh((0, 0, 0), (1, 1, 1), 4, 4, 4, dtype=torch.float32, device="cpu")
        op = WindowStiffnessOperator(FunctionSpace(mesh, 1), S=128)
    else:
        mesh_fn, degree = _WALK_SPACES[NL]
        operator = (WindowStiffnessOperator if kind == "stiffness"
                    else winkernel.WindowMassOperator)
        op = operator(FunctionSpace(mesh_fn(), degree), S=128)
    wl = op.wl
    nb, NL, C = op.lidx.shape
    rowptr, ent = build_scatter_lists(wl)
    pos = scatter_positions(rowptr, ent, NL).reshape(nb, NL, C)
    x_pad = torch.zeros(wl.n_pad)
    x_pad[:wl.n] = torch.as_tensor(rng.standard_normal(wl.n), dtype=torch.float32)
    u = x_pad[(torch.arange(nb)[:, None, None] * wl.S + op.lidx).long()]
    if kind == "stiffness":
        plain = stiffness_windows_plain(x_pad, op.lidx, op.valid, op.Cg, op.kref, wl.S, wl.W)
        K = op.kref.view(op.Cg.shape[1], NL, NL)
        loc = torch.einsum("bkc,kij,bjc->bic", op.Cg, K, u) * op.valid[:, None, :]
    if p1_3d:
        monkeypatch.setattr(winkernel, "CLUSTER_3D", cl)
        if loc_bytes is not None:
            monkeypatch.setattr(winkernel, "LOC_BYTES_3D", loc_bytes)
        cap = cluster_plan(C, NL)
    else:
        if kind == "mass":
            plain = winkernel.mass_windows_plain(x_pad, op.lidx, op.valid, op.detj, op.mref,
                                                 wl.S, wl.W)
            loc = torch.einsum("ij,bjc->bic", op.mref, u) * (op.detj * op.valid)[:, None, :]
        elif kind == "element":
            aloc = torch.as_tensor(rng.standard_normal((nb, NL * NL, C)), dtype=torch.float32)
            plain = winform.element_windows_plain(x_pad, op.lidx, op.valid, aloc, wl.S, wl.W)
            loc = (torch.einsum("bijc,bjc->bic", aloc.view(nb, NL, NL, C), u)
                   * op.valid[:, None, :])
        if loc_bytes is not None:
            monkeypatch.setattr(winkernel, "WINDOW_LOC_BYTES", loc_bytes)
        cl, _, cap = winkernel.window_plan(nb, C, NL, 132)
    loc = loc.numpy()
    room = cl * cap
    out = np.zeros((nb, wl.W), dtype=np.float32)
    one = np.zeros((nb, wl.W), dtype=np.float32)
    most = 0
    for b in range(nb):
        rp = rowptr[b]
        one[b] = _row_sums(loc[b].T.reshape(-1)[ent[b, :rp[-1]]], rp)
        r0, passes = 0, 0
        while r0 < wl.W:
            e0 = int(rp[r0])
            r1 = (wl.W if rp[-1] - e0 <= room
                  else int(np.searchsorted(rp, e0 + room, side="right")) - 1)
            assert r1 > r0
            n = int(rp[r1]) - e0
            Q = -(-n // cl)
            staged = np.full((cl, Q), np.nan, dtype=np.float32)
            q = pos[b] - e0
            m = (q >= 0) & (q < n)
            staged[q[m] // Q, q[m] % Q] = loc[b][m]
            # position q is staged at [q // Q, q % Q]: the rows read their
            # positions in list order across the blocks' arrays
            out[b, r0:r1] = _row_sums(staged.reshape(-1), rp[r0:r1 + 1] - e0)
            r0, passes = r1, passes + 1
        most = max(most, passes)
    assert (most > 1) == (loc_bytes is not None)
    np.testing.assert_array_equal(out, one)
    np.testing.assert_allclose(out, plain.numpy(), rtol=1e-5,
                               atol=1e-5 * float(plain.abs().max()))


@pytest.mark.parametrize("degree, S", [(2, 128), (2, None), (1, 128)])
def test_compact_lists_reproduce_scatter_lists(degree, S):
    # the compressed rows of a window block and the zeros of every other row
    # give back the scatter lists' row pointers exactly; the positions are
    # those of position_lists
    mesh = box_mesh((0, 0, 0), (1, 1, 1), 4, 4, 4, dtype=torch.float32, device="cpu")
    wl = build_window_layout(FunctionSpace(mesh, degree), S=S)
    rowptr, ent = build_scatter_lists(wl)
    rptr, rows, pos = compact_lists(wl)
    nb, W = wl.nb, wl.W
    R = rows.shape[1]
    assert rptr.shape == (nb, R + 1) and rows.dtype == rptr.dtype == np.int32
    np.testing.assert_array_equal(pos, position_lists(wl)[1])
    counts = np.zeros((nb, W), dtype=np.int64)
    for b in range(nb):
        listed = rows[b] < W
        k = int(listed.sum())
        assert listed[:k].all() and not listed[k:].any()  # padding at the end
        assert (np.diff(rows[b, :k]) > 0).all()
        lengths = np.diff(rptr[b])
        assert (lengths[:k] > 0).all() and (lengths[k:] == 0).all()
        assert rptr[b, 0] == 0 and rptr[b, -1] == rowptr[b, -1]
        counts[b, rows[b, :k]] = lengths[:k]
    rebuilt = np.concatenate([np.zeros((nb, 1), np.int64), np.cumsum(counts, axis=1)], axis=1)
    np.testing.assert_array_equal(rebuilt, rowptr)
    assert R == int((np.diff(rowptr, axis=1) > 0).sum(axis=1).max())


@pytest.mark.parametrize("nb, C", [(525, 3063), (68, 3038)], ids=["N=64", "N=32"])
def test_momentum_plan_stages_a_cavity_window_block_in_one_pass(nb, C):
    # K3 3-D at the cavity's velocity layouts (N=64: nb = 525, C = 3,063;
    # N=32: nb = 68, C = 3,038): one pass, at most MAX_CLUSTER blocks, three
    # floats a position within a block's 227 KB of shared memory
    cl, threads, cap = winkernel.momentum_plan(nb, C, 10, 132)
    assert winkernel.MOMENTUM_CLUSTER <= cl <= winkernel.MAX_CLUSTER
    assert cl * cap >= C * 10
    assert 12 * cap <= min(winkernel.MOMENTUM_LOC_BYTES, 227 * 1024)
    assert threads == winkernel.MOMENTUM_THREADS <= 512
