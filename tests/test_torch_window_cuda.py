# The window kernels of flow_tpu_torch on the card: K3 (csrc/winmom.cu,
# lagged and Newton) and K4b (csrc/winstiff.cu) against their plain PyTorch
# versions on small Karman layouts, bitwise repeatable, the Newton kernel
# equal to the lagged one where its reaction term vanishes, and taking a
# block of more cells than shared memory would hold; their 3-D variants
# (csrc/winmom3d.cu, winstiff.cu's winstiff_p1_3d) the same on box_mesh
# tet layouts, taking a block of any size (cluster launches: they stage the
# local results at their list positions in the cluster's shared memory,
# K3 two (2-D) or three (3-D) components a position over its compressed
# rows, and run in passes where they exceed it, summing in one order at
# every cluster and block size) and refusing inputs they do not take; the
# window mass kernel (K4a, csrc/winmass.cu), the element-matrix kernel (K5,
# csrc/winform.cu) and K4b's P2 variants on P1/P2 triangle and tet layouts
# (NL = 3, 6, 4, 10), the same; K4a, K5 and K4b P2, cluster launches like
# K4b 3-D (csrc/wincluster.cuh), also in passes and at every cluster and
# block size in one summation order, taking blocks past a cluster's shared
# memory and refusing inputs they do not take, K4b's operator also on the
# lean path that checks only its input. Skips without a CUDA device. Imports
# no JAX, so it runs on the machine with the card:
#   python -m pytest --noconftest -q tests/test_torch_window_cuda.py
# (tests/conftest.py imports JAX). Tolerance: float32 in both, another
# summation order: 1e-5 relative to the largest entry.
import numpy as np
import pytest
import torch

from flow_tpu_torch.attic import winform, winkernel, winmom
from flow_tpu_torch.attic.window import WindowLayout, compact_lists, scatter_positions
from flow_tpu_torch.fem import assembly, formlang
from flow_tpu_torch.fem.spaces import FunctionSpace, VectorFunctionSpace
from flow_tpu_torch.mesh import unit_square_mesh
from flow_tpu_torch.mesh3d import box_mesh
from flow_tpu_torch.models.karman import KarmanProblem

torch.set_num_threads(1)

TOL = 1e-5


@pytest.fixture(scope="module")
def problem():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (CUDA kernel has no CPU mode)")
    return KarmanProblem(lcar=0.1, n_refine=1, dtype=torch.float32, device="cuda")


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("S", [128, None])
def test_stiffness_kernel_matches_plain(problem, S):
    op = winkernel.WindowStiffnessOperator(problem.Q, S=S)
    g = torch.Generator().manual_seed(1)
    x_pad = torch.zeros(op.wl.n_pad)
    x_pad[:op.wl.n] = torch.randn(op.wl.n, generator=g)
    x_pad = x_pad.cuda()
    before = winkernel.WINSTIFF.launches
    y = op.windows(x_pad)
    y2 = op.windows(x_pad)
    torch.cuda.synchronize()
    assert winkernel.WINSTIFF.launches == before + 2
    assert torch.equal(y, y2)
    y_plain = winkernel.stiffness_windows_plain(x_pad, op.lidx, op.valid, op.Cg,
                                                op.kref, op.wl.S, op.wl.W)
    assert _rel(y, y_plain) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("S", [128, None])
def test_momentum_kernel_matches_plain(problem, S):
    op = winmom.WindowLaggedMomentum(problem.V, S=S)
    rng = np.random.default_rng(2)
    T = torch.as_tensor(rng.standard_normal((problem.V.n_dofs, 2)), dtype=torch.float32,
                        device="cuda")
    Tq = op.transport_qp(T)
    x_pad = torch.zeros((2, op.wl.n_pad), device="cuda")
    x_pad[:, :op.wl.n] = torch.as_tensor(rng.standard_normal((2, op.wl.n)),
                                         dtype=torch.float32)
    for weights in ((1.0, 0.37, 0.021), (1.0, 0.0, 0.0)):
        before = winmom.WINMOM.launches
        y = op.windows(x_pad, Tq, *weights)
        y2 = op.windows(x_pad, Tq, *weights)
        torch.cuda.synchronize()
        assert winmom.WINMOM.launches == before + 2
        assert torch.equal(y, y2)
        y_plain = winmom.momentum_windows_plain(
            x_pad, op.lidx, op.valid, op.detj, op.G4, op.Cg4, Tq, op.tabs,
            op._scal(*weights), op.wl.S, op.wl.W)
        assert _rel(y, y_plain) <= TOL


def _momentum_inputs(problem, op, seed):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal((problem.V.n_dofs, 2)), dtype=torch.float32,
                        device="cuda")
    x_pad = torch.zeros((2, op.wl.n_pad), device="cuda")
    x_pad[:, :op.wl.n] = torch.as_tensor(rng.standard_normal((2, op.wl.n)),
                                         dtype=torch.float32)
    return x, x_pad


@pytest.mark.cuda
@pytest.mark.parametrize("S", [128, None])
def test_newton_kernel_matches_plain(problem, S):
    op = winmom.WindowLaggedMomentum(problem.V, S=S)
    x, x_pad = _momentum_inputs(problem, op, 3)
    Tq, Uq, Gu = op.state_qp(x)
    weights = (1.0, 0.37, 0.021)
    before = (winmom.WINMOM.launches, winmom.WINMOM_NEWTON.launches)
    y = op.windows(x_pad, Tq, *weights, Uq, Gu)
    y2 = op.windows(x_pad, Tq, *weights, Uq, Gu)
    torch.cuda.synchronize()
    assert (winmom.WINMOM.launches, winmom.WINMOM_NEWTON.launches) == (
        before[0], before[1] + 2)
    assert torch.equal(y, y2)
    y_plain = winmom.momentum_windows_plain(
        x_pad, op.lidx, op.valid, op.detj, op.G4, op.Cg4, Tq, op.tabs,
        op._scal(*weights), op.wl.S, op.wl.W, Uq, Gu)
    assert _rel(y, y_plain) <= TOL
    # the wrapper takes only the state that is the transport (state_qp's)
    with pytest.raises(ValueError, match="Uq that is"):
        op.windows(x_pad, Tq, *weights, Tq.clone(), Gu)


@pytest.mark.cuda
def test_newton_kernel_without_reaction_is_the_lagged_kernel(problem):
    op = winmom.WindowLaggedMomentum(problem.V, S=128)
    _, x_pad = _momentum_inputs(problem, op, 4)
    Tq = op.zero_transport()
    Gu = torch.zeros((op.wl.nb, 4 * op.nq, op.wl.C), device="cuda")
    weights = (1.0, 0.37, 0.021)
    y = op.windows(x_pad, Tq, *weights, Tq, Gu)
    y_lagged = op.windows(x_pad, Tq, *weights)
    torch.cuda.synchronize()
    assert _rel(y, y_lagged) <= 1e-7


@pytest.mark.cuda
def test_kernels_take_cells_beyond_shared_memory(problem):
    # blocks of more cells than 227 KB of shared memory would hold at once
    # (K4b P1: 12 B a cell, K3: 48 B): K4b P1 writes the local results to a
    # device scratch, K3 stages them over a cluster of blocks, so the
    # kernels take them and agree with their plain versions
    mesh = unit_square_mesh(128, "right", dtype=torch.float32, device="cuda")
    S = 16384
    op = winkernel.WindowStiffnessOperator(FunctionSpace(mesh, 1), S=S)
    assert op.wl.C > 19000
    g = torch.Generator().manual_seed(3)
    x_pad = torch.zeros(op.wl.n_pad)
    x_pad[:op.wl.n] = torch.randn(op.wl.n, generator=g)
    x_pad = x_pad.cuda()
    before = winkernel.WINSTIFF.launches
    y = op.windows(x_pad)
    torch.cuda.synchronize()
    assert winkernel.WINSTIFF.launches == before + 1
    assert _rel(y, winkernel.stiffness_windows_plain(
        x_pad, op.lidx, op.valid, op.Cg, op.kref, op.wl.S, op.wl.W)) <= TOL
    mo = winmom.WindowLaggedMomentum(VectorFunctionSpace(mesh, 2), S=S)
    assert mo.wl.C > 4800
    x = torch.randn((mo.wl.n, 2), generator=g).cuda()
    Tq, Uq, Gu = mo.state_qp(x)
    xp = torch.zeros((2, mo.wl.n_pad), device="cuda")
    xp[:, :mo.wl.n] = torch.randn((2, mo.wl.n), generator=g).cuda()
    weights = (1.0, 0.37, 0.021)
    for newton, counter in ((False, winmom.WINMOM), (True, winmom.WINMOM_NEWTON)):
        extra = (Uq, Gu) if newton else ()
        before = counter.launches
        y = mo.windows(xp, Tq, *weights, *extra)
        torch.cuda.synchronize()
        assert counter.launches == before + 1
        plain = winmom.momentum_windows_plain(
            xp, mo.lidx, mo.valid, mo.detj, mo.G4, mo.Cg4, Tq, mo.tabs,
            mo._scal(*weights), mo.wl.S, mo.wl.W, *extra)
        assert _rel(y, plain) <= TOL


@pytest.mark.cuda
def test_momentum_kernels_sum_in_one_order_at_every_cluster_size(problem, monkeypatch):
    # K3 2-D's launch follows momentum_plan: clusters of 1-8 blocks, 32-512
    # threads a block and stages of a few dozen positions (several passes);
    # both variants give the windows of the default launch bitwise
    op = winmom.WindowLaggedMomentum(problem.V, S=128)
    assert len(op.positions) == 3
    x, x_pad = _momentum_inputs(problem, op, 12)
    Tq, Uq, Gu = op.state_qp(x)
    weights = (1.0, 0.37, 0.021)
    nb, NL, C = op.lidx.shape
    entries = int(op.positions[0][:, -1].max())
    for newton in (False, True):
        extra = (Uq, Gu) if newton else ()
        counter = winmom.WINMOM_NEWTON if newton else winmom.WINMOM
        y = op.windows(x_pad, Tq, *weights, *extra)
        passes = []
        with monkeypatch.context() as m:
            for cl, threads, loc_bytes in ((1, 512, 224 * 1024), (2, 128, 8 * 300),
                                           (3, 256, 8 * 20), (8, 32, 8 * 40),
                                           (4, 384, 224 * 1024)):
                m.setattr(winkernel, "MOMENTUM_CLUSTER", cl)
                m.setattr(winkernel, "MOMENTUM_THREADS", threads)
                m.setattr(winkernel, "MOMENTUM_LOC_BYTES", loc_bytes)
                plan = winkernel.cluster_launch(counter, nb, C, NL, "cuda")
                assert plan.threads == threads and 0 < plan.clusters <= plan.resident
                passes.append(entries > plan.cl * plan.cap)
                before = counter.launches
                assert torch.equal(op.windows(x_pad, Tq, *weights, *extra), y)
                assert counter.launches == before + 1
        assert passes == [False, False, True, True, False]


@pytest.mark.cuda
def test_momentum_kernels_take_blocks_beyond_shared_memory_in_passes(problem):
    # K3 2-D on one block of C = 40,000 real cells, two components a
    # position past the stage of a cluster of MAX_CLUSTER blocks (so it runs
    # in passes): cell c puts local dof i on window dof 2 ((c*NL + i) mod
    # 128) of a window of 256 (the odd rows empty, so the compressed rows
    # are half of them), where component m of x is m + 1; with only the
    # mass term (Mref = 1, detJ = 1) every local result of component m is
    # 6 (m + 1), exact in float32, and the Newton kernel with Gu = 0 gives
    # the same windows
    z = dict(device="cuda")
    S = W = 256
    C, NL = 40000, 6
    dof = 2 * ((np.arange(C)[:, None] * NL + np.arange(NL)) % 128)  # [C, NL]
    wl = WindowLayout(None, None, S, W, 1, C, None, np.ones((1, C), np.float32),
                      dof[None].astype(np.int32))
    positions = tuple(torch.as_tensor(a, **z) for a in compact_lists(wl))
    assert positions[1].shape[1] == 128
    lidx = torch.as_tensor(dof.T[None].astype(np.int32), **z).contiguous()
    ones = torch.ones((1, C), **z)
    zeros4 = torch.zeros((1, 4, C), **z)
    Tq = torch.zeros((1, 14, C), **z)
    tabs = torch.zeros(313, **z)
    tabs[42 + 84 + 7:42 + 84 + 7 + 36] = 1.0  # Mref
    scal = torch.tensor([1.0, 0.0, 0.0], **z)
    xm = torch.zeros((2, S + W), **z)
    xm[:, :W] = torch.arange(1, 3, dtype=torch.float32, **z)[:, None]
    plan = winkernel.cluster_launch(winmom.WINMOM, 1, C, NL, "cuda")
    assert C * NL > plan.cl * plan.cap and plan.cl == winkernel.MAX_CLUSTER
    counts = torch.zeros(W, **z)
    counts[0::2] = torch.as_tensor(np.bincount(dof.reshape(-1) // 2, minlength=128),
                                   dtype=torch.float32, **z)
    want = 6.0 * torch.arange(1, 3, dtype=torch.float32, **z)[:, None] * counts
    args = (xm, lidx, ones, ones, zeros4, zeros4, Tq, tabs, scal, S, W)
    before = winmom.WINMOM.launches, winmom.WINMOM_NEWTON.launches
    y = winmom.momentum_windows(*args, positions=positions)
    yn = winmom.momentum_windows(*args, Uq=Tq, Gu=torch.zeros((1, 28, C), **z),
                                 positions=positions)
    torch.cuda.synchronize()
    assert (winmom.WINMOM.launches, winmom.WINMOM_NEWTON.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(y[:, 0], want) and torch.equal(yn, y)


@pytest.fixture(scope="module")
def box():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (CUDA kernel has no CPU mode)")
    mesh = box_mesh((0, 0, 0), (1, 1, 1), 6, 6, 6, dtype=torch.float32, device="cuda")
    return VectorFunctionSpace(mesh, 2, n_components=3), FunctionSpace(mesh, 1)


def _inputs_3d(V, op, seed):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal((V.n_dofs, 3)), dtype=torch.float32,
                        device="cuda")
    x_pad = torch.zeros((3, op.wl.n_pad), device="cuda")
    x_pad[:, :op.wl.n] = torch.as_tensor(rng.standard_normal((3, op.wl.n)),
                                         dtype=torch.float32)
    return x, x_pad


@pytest.mark.cuda
@pytest.mark.parametrize("S", [128, None])
def test_momentum_3d_kernels_match_plain(box, S):
    V, _ = box
    op = winmom.WindowLaggedMomentum(V, S=S)
    # a cluster kernel: it reads the compressed rows and positions
    assert op.positions is not None and len(op.positions) == 3
    x, x_pad = _inputs_3d(V, op, 5)
    Tq, Uq, Gu = op.state_qp(x)
    weights = (1.0, 0.37, 0.021)
    for newton in (False, True):
        extra = (Uq, Gu) if newton else ()
        counter = winmom.WINMOM3D_NEWTON if newton else winmom.WINMOM3D
        before = counter.launches
        y = op.windows(x_pad, Tq, *weights, *extra)
        y2 = op.windows(x_pad, Tq, *weights, *extra)
        torch.cuda.synchronize()
        assert counter.launches == before + 2
        assert torch.equal(y, y2)
        y_plain = winmom.momentum_windows_plain(
            x_pad, op.lidx, op.valid, op.detj, op.G4, op.Cg4, Tq, op.tabs,
            op._scal(*weights), op.wl.S, op.wl.W, *extra)
        assert _rel(y, y_plain) <= TOL


@pytest.mark.cuda
def test_newton_3d_kernel_without_reaction_is_the_lagged_kernel(box):
    V, _ = box
    op = winmom.WindowLaggedMomentum(V, S=128)
    _, x_pad = _inputs_3d(V, op, 6)
    Tq = op.zero_transport()
    Gu = torch.zeros((op.wl.nb, 9 * op.nq, op.wl.C), device="cuda")
    weights = (1.0, 0.37, 0.021)
    y = op.windows(x_pad, Tq, *weights, Tq, Gu)
    y_lagged = op.windows(x_pad, Tq, *weights)
    torch.cuda.synchronize()
    assert _rel(y, y_lagged) <= 1e-7


@pytest.mark.cuda
@pytest.mark.parametrize("S", [128, 256, None, "chunked"])
def test_stiffness_3d_kernel_matches_plain(box, S, monkeypatch):
    # the cluster kernel at several strides; "chunked": a budget of 2 KB of
    # local results a block, so the default layout runs in several passes,
    # which must sum in the order of one pass (bitwise the same windows)
    _, Q = box
    op = winkernel.WindowStiffnessOperator(Q, S=None if S == "chunked" else S)
    x_pad = torch.zeros(op.wl.n_pad, device="cuda")
    x_pad[:op.wl.n] = torch.as_tensor(np.random.default_rng(7).standard_normal(op.wl.n),
                                      dtype=torch.float32)
    y_one = op.windows(x_pad)
    C = op.lidx.shape[2]
    if S == "chunked":
        monkeypatch.setattr(winkernel, "LOC_BYTES_3D", 2048)
        room = winkernel.CLUSTER_3D * winkernel.cluster_plan(C, 4)
        assert int(op.positions[0][:, -1].max()) > room
    before = winkernel.WINSTIFF3D.launches
    y = op.windows(x_pad)
    y2 = op.windows(x_pad)
    torch.cuda.synchronize()
    assert winkernel.WINSTIFF3D.launches == before + 2
    assert torch.equal(y, y2) and torch.equal(y, y_one)
    y_plain = winkernel.stiffness_windows_plain(x_pad, op.lidx, op.valid, op.Cg,
                                                op.kref, op.wl.S, op.wl.W)
    assert _rel(y, y_plain) <= TOL
    plan = winkernel.cluster_launch(winkernel.WINSTIFF3D, op.wl.nb, C, 4, "cuda")
    assert plan.resident > 0 and plan.clusters == min(op.wl.nb, plan.resident)
    # every cluster size and block size sums in the same order
    for cl, threads in ((1, 64), (2, 256), (4, 512), (8, 384)):
        monkeypatch.setattr(winkernel, "CLUSTER_3D", cl)
        monkeypatch.setattr(winkernel, "THREADS_3D", threads)
        assert torch.equal(op.windows(x_pad), y)


@pytest.mark.cuda
def test_3d_kernels_take_blocks_beyond_shared_memory_and_refuse_bad_inputs(box, monkeypatch):
    # one block of C cells, past what shared memory would hold (16 B a cell
    # for K4b 3-D, 120 B for K3 3-D): the 3-D kernels take it; one real
    # cell whose window dofs 0..NL-1 hold x = 1, all other cells masked
    S = W = 128
    z = dict(device="cuda")
    C = 30000
    lidx = torch.arange(4, dtype=torch.int32, **z)[None, :, None].expand(1, 4, C).contiguous()
    valid = torch.zeros((1, C), **z)
    valid[0, 0] = 1.0
    cg = torch.ones((1, 9, C), **z)
    kref = torch.ones((36, 4), **z)
    rowptr = torch.zeros((1, W + 1), dtype=torch.int32, **z)
    rowptr[0, 1:5] = torch.arange(1, 5, dtype=torch.int32, **z)
    rowptr[0, 5:] = 4
    ent = torch.zeros((1, 4 * C), dtype=torch.int32, **z)
    ent[0, :4] = torch.arange(4, dtype=torch.int32, **z)
    x = torch.zeros(S + W, **z)
    x[:4] = 1.0
    # the cluster kernel reads the lists' inverse: entry c*4 + i at pos[i*C + c]
    pos = torch.as_tensor(scatter_positions(rowptr.cpu().numpy(), ent.cpu().numpy(), 4),
                          **z)
    lists = dict(positions=(rowptr, pos))
    y = winkernel.stiffness_windows(x, lidx, valid, cg, kref, S, W, **lists)
    torch.cuda.synchronize()
    assert y[0, :4].tolist() == [36.0] * 4 and float(y[0, 4:].abs().max()) == 0.0
    for cl, threads in ((16, 256), (8, 1024)):  # at most 8 blocks of 512 threads
        with monkeypatch.context() as m:
            m.setattr(winkernel, "CLUSTER_3D", cl)
            m.setattr(winkernel, "THREADS_3D", threads)
            with pytest.raises(RuntimeError, match="launch failed"):
                winkernel.stiffness_windows(x, lidx, valid, cg, kref, S, W, **lists)
    with pytest.raises(TypeError, match="float32"):
        winkernel.stiffness_windows(x.double(), lidx, valid, cg, kref, S, W, **lists)
    with pytest.raises(ValueError, match="contiguous"):
        winkernel.stiffness_windows(x, lidx, valid, cg.transpose(1, 2).contiguous()
                                    .transpose(1, 2), kref, S, W, **lists)
    # K3 3-D on one block of C = 20,000 real cells, three components a
    # position past the stage of a cluster of MAX_CLUSTER blocks (so it runs
    # in passes): cell c puts local dof i on window dof 2 ((c*NL + i) mod
    # 128) of a window of 256 (the odd rows empty, so the compressed rows
    # are half of them), where component m of x is m + 1; with only the
    # mass term (Mref = 1, detJ = 1) every local result of component m is
    # 10 (m + 1), exact in float32, and the Newton kernel with Gu = 0 gives
    # the same windows
    S = W = 256
    C, NL = 20000, 10
    dof = 2 * ((np.arange(C)[:, None] * NL + np.arange(NL)) % 128)  # [C, NL]
    wl = WindowLayout(None, None, S, W, 1, C, None, np.ones((1, C), np.float32),
                      dof[None].astype(np.int32))
    positions = tuple(torch.as_tensor(a, **z) for a in compact_lists(wl))
    assert positions[1].shape[1] == 128
    lidx = torch.as_tensor(dof.T[None].astype(np.int32), **z).contiguous()
    ones = torch.ones((1, C), **z)
    zeros9 = torch.zeros((1, 9, C), **z)
    Tq = torch.zeros((1, 81, C), **z)
    tabs = torch.zeros(2107, **z)
    tabs[270 + 810 + 27:270 + 810 + 27 + 100] = 1.0  # Mref
    scal = torch.tensor([1.0, 0.0, 0.0], **z)
    xm = torch.zeros((3, S + W), **z)
    xm[:, :W] = torch.arange(1, 4, dtype=torch.float32, **z)[:, None]
    plan = winkernel.cluster_launch(winmom.WINMOM3D, 1, C, NL, "cuda")
    assert C * NL > plan.cl * plan.cap and plan.cl == winkernel.MAX_CLUSTER
    counts = torch.zeros(W, **z)
    counts[0::2] = torch.as_tensor(np.bincount(dof.reshape(-1) // 2, minlength=128),
                                   dtype=torch.float32, **z)
    want = 10.0 * torch.arange(1, 4, dtype=torch.float32, **z)[:, None] * counts
    args = (xm, lidx, ones, ones, zeros9, zeros9, Tq, tabs, scal, S, W)
    before = winmom.WINMOM3D.launches, winmom.WINMOM3D_NEWTON.launches
    y = winmom.momentum_windows(*args, positions=positions)
    yn = winmom.momentum_windows(*args, Uq=Tq, Gu=torch.zeros((1, 243, C), **z),
                                 positions=positions)
    torch.cuda.synchronize()
    assert (winmom.WINMOM3D.launches, winmom.WINMOM3D_NEWTON.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(y[:, 0], want) and torch.equal(yn, y)
    # refused before any launch: no lists, tables of another size, lists of
    # another shape
    with pytest.raises(ValueError, match="lists"):
        winmom.momentum_windows(*args)
    with pytest.raises(ValueError, match="inconsistent layout shapes"):
        winmom.momentum_windows(xm, lidx, ones, ones, zeros9, zeros9, Tq, tabs[:2000], scal,
                                S, W, positions=positions)
    with pytest.raises(ValueError, match="inconsistent layout shapes"):
        winmom.momentum_windows(*args, positions=(positions[0], positions[1][:, 1:].contiguous(),
                                                  positions[2]))
    assert (winmom.WINMOM3D.launches, winmom.WINMOM3D_NEWTON.launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.cuda
def test_momentum_3d_kernels_sum_in_one_order_at_every_cluster_size(box, monkeypatch):
    # K3 3-D's launch constants steer momentum_plan: clusters of 1-8 blocks,
    # 32-512 threads a block and stages of a few dozen positions (several
    # passes); both variants give the windows of the default launch bitwise
    V, _ = box
    op = winmom.WindowLaggedMomentum(V, S=128)
    x, x_pad = _inputs_3d(V, op, 13)
    Tq, Uq, Gu = op.state_qp(x)
    weights = (1.0, 0.37, 0.021)
    nb, NL, C = op.lidx.shape
    entries = int(op.positions[0][:, -1].max())
    for newton in (False, True):
        extra = (Uq, Gu) if newton else ()
        counter = winmom.WINMOM3D_NEWTON if newton else winmom.WINMOM3D
        y = op.windows(x_pad, Tq, *weights, *extra)
        passes = []
        with monkeypatch.context() as m:
            for cl, threads, loc_bytes in ((1, 512, 224 * 1024), (2, 128, 12 * 300),
                                           (3, 256, 12 * 60), (8, 32, 12 * 40),
                                           (4, 384, 224 * 1024)):
                m.setattr(winkernel, "MOMENTUM_CLUSTER", cl)
                m.setattr(winkernel, "MOMENTUM_THREADS", threads)
                m.setattr(winkernel, "MOMENTUM_LOC_BYTES", loc_bytes)
                plan = winkernel.cluster_launch(counter, nb, C, NL, "cuda")
                assert plan.threads == threads and 0 < plan.clusters <= plan.resident
                passes.append(entries > plan.cl * plan.cap)
                before = counter.launches
                assert torch.equal(op.windows(x_pad, Tq, *weights, *extra), y)
                assert counter.launches == before + 1
        assert passes == [False, False, True, True, False]


_SPACES = {
    "tri P1": (lambda: unit_square_mesh(12, "crossed", dtype=torch.float32, device="cuda"), 1),
    "tri P2": (lambda: unit_square_mesh(12, "crossed", dtype=torch.float32, device="cuda"), 2),
    "tet P1": (lambda: box_mesh((0, 0, 0), (1, 1, 1), 4, 4, 4, dtype=torch.float32,
                                device="cuda"), 1),
    "tet P2": (lambda: box_mesh((0, 0, 0), (1, 1, 1), 4, 4, 4, dtype=torch.float32,
                                device="cuda"), 2),
}


@pytest.fixture(scope="module", params=sorted(_SPACES))
def scalar_space(request):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (CUDA kernel has no CPU mode)")
    mesh_fn, degree = _SPACES[request.param]
    return FunctionSpace(mesh_fn(), degree)


def _padded(op, seed):
    x_pad = torch.zeros(op.wl.n_pad, device="cuda")
    x_pad[:op.wl.n] = torch.as_tensor(np.random.default_rng(seed).standard_normal(op.wl.n),
                                      dtype=torch.float32)
    return x_pad


def _field(x):
    # a rotating field in 2-D, the position vector in 3-D
    if x.shape[-1] == 2:
        return torch.stack([-x[..., 1], x[..., 0]], dim=-1)
    return x


def _convection_diffusion(V):
    u, v = formlang.TrialFunction(V), formlang.TestFunction(V)
    b = formlang.Coefficient(_field, vector=True)
    form = u * v + 0.01 * (formlang.dot(formlang.grad(u), formlang.grad(v))
                           + formlang.dot(b, formlang.grad(u)) * v)
    return formlang.compile_form(form, assembly.geometry(V.mesh), 2 * V.degree + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [128, None])
def test_mass_kernel_matches_plain(scalar_space, S):
    op = winkernel.WindowMassOperator(scalar_space, S=S)
    x_pad = _padded(op, 8)
    before = winkernel.WINMASS.launches
    y = op.windows(x_pad)
    y2 = op.windows(x_pad)
    torch.cuda.synchronize()
    assert winkernel.WINMASS.launches == before + 2
    assert torch.equal(y, y2)
    y_plain = winkernel.mass_windows_plain(x_pad, op.lidx, op.valid, op.detj, op.mref,
                                           op.wl.S, op.wl.W)
    assert _rel(y, y_plain) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("S", [128, None])
def test_element_kernel_matches_plain(scalar_space, S):
    form = _convection_diffusion(scalar_space)
    op = winform.window_operator(form, S=S)
    assert op.aloc.is_contiguous() and op.aloc.dtype == torch.float32
    x_pad = _padded(op, 9)
    before = winform.WINFORM.launches
    y = op.windows(x_pad)
    y2 = op.windows(x_pad)
    torch.cuda.synchronize()
    assert winform.WINFORM.launches == before + 2
    assert torch.equal(y, y2)
    y_plain = winform.element_windows_plain(x_pad, op.lidx, op.valid, op.aloc,
                                            op.wl.S, op.wl.W)
    assert _rel(y, y_plain) <= TOL
    # the whole apply against the compiled form's own einsum apply
    x = x_pad[:op.wl.n][op.inv]
    assert _rel(op.apply(x), form.apply(x)) <= TOL


@pytest.mark.cuda
def test_stiffness_p2_kernels_match_plain(scalar_space):
    if scalar_space.degree != 2:
        pytest.skip("the P1 variants have their own tests above")
    op = winkernel.WindowStiffnessOperator(scalar_space, S=128)
    # a cluster kernel: it reads the lists' inverse, not the lists
    assert op.positions is not None and op.scatter is None
    counter = winkernel.WINSTIFF_P2 if op.Cg.shape[1] == 4 else winkernel.WINSTIFF3D_P2
    x_pad = _padded(op, 10)
    before = counter.launches
    y = op.windows(x_pad)
    y2 = op.windows(x_pad)
    torch.cuda.synchronize()
    assert counter.launches == before + 2
    assert torch.equal(y, y2)
    y_plain = winkernel.stiffness_windows_plain(x_pad, op.lidx, op.valid, op.Cg,
                                                op.kref, op.wl.S, op.wl.W)
    assert _rel(y, y_plain) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mass", "element", "stiffness"])
def test_mass_and_element_kernels_sum_in_one_order_at_every_cluster_size(
        scalar_space, kind, monkeypatch):
    # the launch constants steer window_plan's rule (K4a, K5, K4b P2): one
    # block a window block, clusters of up to 8 with stages of a few hundred
    # bytes (several passes), and 32-1,024 threads a block; every launch
    # gives the windows of the default launch bitwise
    if kind == "mass":
        op = winkernel.WindowMassOperator(scalar_space, S=128)
        counter = winkernel.WINMASS
    elif kind == "element":
        op = winform.window_operator(_convection_diffusion(scalar_space), S=128)
        counter = winform.WINFORM
    else:
        if scalar_space.degree != 2:
            pytest.skip("the P1 stiffness variants do not take window_plan's rule")
        op = winkernel.WindowStiffnessOperator(scalar_space, S=128)
        counter = winkernel.WINSTIFF_P2 if op.Cg.shape[1] == 4 else winkernel.WINSTIFF3D_P2
    x_pad = _padded(op, 11)
    y = op.windows(x_pad)
    nb, NL, C = op.lidx.shape
    entries = int(op.positions[0][:, -1].max())
    passes = []
    for loc_bytes, threads in ((1 << 20, 1024), (4 * 300, 128), (4 * 40, 256),
                               (4 * 16, 32)):
        monkeypatch.setattr(winkernel, "WINDOW_LOC_BYTES", loc_bytes)
        monkeypatch.setattr(winkernel, "WINDOW_THREADS", threads)
        monkeypatch.setattr(winkernel, "WINDOW_THREADS_FEW", threads)
        plan = winkernel.cluster_launch(counter, nb, C, NL, "cuda")
        assert plan.threads == threads and 0 < plan.clusters <= plan.resident
        passes.append(entries > plan.cl * plan.cap)
        before = counter.launches
        assert torch.equal(op.windows(x_pad), y)
        assert counter.launches == before + 1
    assert passes[0] is False and passes[-1] is True


@pytest.mark.cuda
@pytest.mark.parametrize("NL", [3, 4, 6, 10])
def test_mass_and_element_kernels_take_large_blocks_and_refuse_bad_inputs(NL):
    # one block of C = 40,000 real cells (its local results far past a
    # cluster's shared memory, so that NL = 10 runs in passes): cell c puts
    # its local dof i on window dof (c*NL + i) mod W, where x = 1, so every
    # window dof sums its count of local results, each 2 NL (mass, detJ =
    # 2, Mref = 1) or NL (element, A = 1): exact in float32
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (CUDA kernel has no CPU mode)")
    S = W = 128
    z = dict(device="cuda")
    C = 40000
    dof = (np.arange(C)[:, None] * NL + np.arange(NL)) % W  # [C, NL]
    key = dof.reshape(-1)  # entry c*NL + i lands on key[c*NL + i]
    ent = np.argsort(key, kind="stable").astype(np.int32)[None]
    rowptr = np.searchsorted(key[ent[0]], np.arange(W + 1)).astype(np.int32)[None]
    positions = (torch.as_tensor(rowptr, **z),
                 torch.as_tensor(scatter_positions(rowptr, ent, NL), **z))
    lidx = torch.as_tensor(dof.T[None].astype(np.int32), **z).contiguous()
    valid = torch.ones((1, C), **z)
    x = torch.zeros(S + W, **z)
    x[:W] = 1.0
    counts = torch.as_tensor(np.bincount(key, minlength=W), dtype=torch.float32, **z)
    plan = winkernel.cluster_launch(winkernel.WINMASS, 1, C, NL, "cuda")
    if NL == 10:
        assert C * NL > plan.cl * plan.cap  # more than one pass
    y = winkernel.mass_windows(x, lidx, valid, torch.full((1, C), 2.0, **z),
                               torch.ones((NL, NL), **z), S, W, positions)
    aloc = torch.ones((1, NL * NL, C), **z)
    ye = winform.element_windows(x, lidx, valid, aloc, S, W, positions)
    torch.cuda.synchronize()
    assert torch.equal(y[0], 2.0 * NL * counts) and torch.equal(ye[0], NL * counts)
    with pytest.raises(TypeError, match="float32"):
        winform.element_windows(x, lidx, valid, aloc.double(), S, W, positions)
    with pytest.raises(ValueError, match="inconsistent layout shapes"):
        winform.element_windows(x, lidx, valid, aloc[:, 1:].contiguous(), S, W, positions)
    with pytest.raises(ValueError, match="NL in"):
        winkernel.mass_windows(x, lidx[:, :2].contiguous(), valid, valid,
                               torch.ones((2, 2), **z), S, W, positions)
    with pytest.raises(ValueError, match="lists"):
        winkernel.mass_windows(x, lidx, valid, valid, torch.ones((NL, NL), **z), S, W)


@pytest.mark.cuda
@pytest.mark.parametrize("NL", [6, 10])
def test_stiffness_p2_kernels_take_large_blocks_and_refuse_bad_inputs(NL, monkeypatch):
    # K4b P2 on one block of C = 40,000 real cells, as the K4a/K5 test
    # above: cell c puts its local dof i on window dof (c*NL + i) mod W,
    # where x = 1, with Cg = 1 and Kref = 1, so every local result is
    # DIM^2 * NL and every window dof sums its count of them: exact in
    # float32; NL = 10 runs in passes
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (CUDA kernel has no CPU mode)")
    S = W = 128
    z = dict(device="cuda")
    C = 40000
    d2 = 4 if NL == 6 else 9
    dof = (np.arange(C)[:, None] * NL + np.arange(NL)) % W  # [C, NL]
    key = dof.reshape(-1)
    ent = np.argsort(key, kind="stable").astype(np.int32)[None]
    rowptr = np.searchsorted(key[ent[0]], np.arange(W + 1)).astype(np.int32)[None]
    positions = (torch.as_tensor(rowptr, **z),
                 torch.as_tensor(scatter_positions(rowptr, ent, NL), **z))
    lidx = torch.as_tensor(dof.T[None].astype(np.int32), **z).contiguous()
    valid = torch.ones((1, C), **z)
    cg = torch.ones((1, d2, C), **z)
    kref = torch.ones((d2 * NL, NL), **z)
    x = torch.zeros(S + W, **z)
    x[:W] = 1.0
    counts = torch.as_tensor(np.bincount(key, minlength=W), dtype=torch.float32, **z)
    counter = winkernel.WINSTIFF_P2 if NL == 6 else winkernel.WINSTIFF3D_P2
    plan = winkernel.cluster_launch(counter, 1, C, NL, "cuda")
    if NL == 10:
        assert C * NL > plan.cl * plan.cap  # more than one pass
    before = counter.launches
    y = winkernel.stiffness_windows(x, lidx, valid, cg, kref, S, W, positions=positions)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert torch.equal(y[0], d2 * NL * counts)
    with pytest.raises(TypeError, match="float32"):
        winkernel.stiffness_windows(x.double(), lidx, valid, cg, kref, S, W,
                                    positions=positions)
    with pytest.raises(ValueError, match="inconsistent layout shapes"):
        winkernel.stiffness_windows(x, lidx, valid, cg, kref[1:].contiguous(), S, W,
                                    positions=positions)
    with pytest.raises(ValueError, match="lists"):
        winkernel.stiffness_windows(x, lidx, valid, cg, kref, S, W,
                                    scatter=(positions[0], positions[1]))
    # a launch the card refuses (more than 8 blocks a cluster, more than
    # 1,024 threads a block) raises, and counts nothing
    for name, value in (("MAX_CLUSTER", 16), ("WINDOW_THREADS_FEW", 2048)):
        with monkeypatch.context() as m:
            m.setattr(winkernel, "WINDOW_LOC_BYTES", 4 * 1024)
            m.setattr(winkernel, name, value)
            with pytest.raises(RuntimeError, match="launch failed"):
                winkernel.stiffness_windows(x, lidx, valid, cg, kref, S, W,
                                            positions=positions)
    assert counter.launches == before + 1


@pytest.mark.cuda
def test_stiffness_operator_checks_its_input(scalar_space):
    # the operator checks its tables once, at construction; windows() then
    # checks only x_pad, and still refuses one on the CPU, in float64, of
    # another length or not contiguous, before any launch
    op = winkernel.WindowStiffnessOperator(scalar_space, S=128)
    counter = winkernel._ENTRIES[(op.Cg.shape[1], op.lidx.shape[1])][0]
    x_pad = _padded(op, 12)
    before = counter.launches
    with pytest.raises(ValueError, match="one device"):
        op.windows(x_pad.cpu())
    with pytest.raises(TypeError, match="float32"):
        op.windows(x_pad.double())
    with pytest.raises(ValueError, match="inconsistent layout shapes"):
        op.windows(x_pad[1:].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        op.windows(torch.stack([x_pad, x_pad], dim=1)[:, 0])
    assert counter.launches == before
    y = op.windows(x_pad)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert y.is_contiguous() and tuple(y.shape) == (op.wl.nb, op.wl.W)
    assert torch.equal(y, winkernel.stiffness_windows(
        x_pad, op.lidx, op.valid, op.Cg, op.kref, op.wl.S, op.wl.W, op.scatter,
        op.positions))
