# flow_tpu_torch.attic.window and attic.winkernel against the JAX package:
# the window layouts must equal the JAX package's exactly (same RCM
# permutation, buckets and tables), the scatter lists of the CUDA kernels
# must reproduce the plain scatter, and the plain version of the window
# stiffness kernel (K4b) must match the JAX Pallas kernel run in interpret
# mode at the JAX package's own tolerance (rtol 3e-5: both compute in
# float32, in another summation order).
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from flow_tpu.attic.window import build_window_layout as jax_layout
from flow_tpu.attic.winkernel import WindowStiffnessOperator as JaxStiffness
from flow_tpu.fem.spaces import FunctionSpace as JaxFunctionSpace
from flow_tpu.models.karman import KarmanProblem as JaxKarman
from flow_tpu_torch.attic.window import (build_scatter_lists,
                                         build_window_layout, overlap_add_fn)
from flow_tpu_torch.attic.winkernel import (WindowStiffnessOperator,
                                            stiffness_windows_plain)
from flow_tpu_torch.fem import assembly
from flow_tpu_torch.fem.ell import ell_stiffness
from flow_tpu_torch.fem.spaces import FunctionSpace
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
