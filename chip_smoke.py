#!/usr/bin/env python3
"""Smoke run of flow_tpu_torch on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. device and build: the card's name and power limit from nvidia-smi, then
   the three CUDA kernels (csrc/stencil3d.cu, winstiff.cu, winmom.cu), one
   nvcc each, started together, and the meshkit library (g++) beside them;
2. stencil against plain: the stencil kernel (K1) against its plain PyTorch
   version on the 3-D cavity path's grids plus ragged ones, in float64
   (relative error <= 1e-13) and float32 (<= 1e-5: another summation order);
3. cavity parity: Cavity3DProblem(n=8) in float64 for 3 steps on the card
   and on the CPU: equal per-step iteration counts, U within 1e-10 and the
   mean-removed P within 1e-8;
4. cavity main path: Cavity3DProblem(n=64), 6,714,692 DoF, float32, the
   benchmark's box-path settings: 1 warm-up step and 5 timed steps;
5. Karman setup: KarmanProblem(lcar=0.02, n_refine=5), 1,905,056 DoF, the
   FastStepper window route with the benchmark's lagged FastStepper
   settings and a P1Hierarchy with window levels from 20,000 dofs;
6. window kernels against plain: the window momentum kernel (K3, lagged)
   and the window stiffness kernel (K4b) against their plain versions at
   the Karman main path's layouts, and K3 lagged and Newton on ragged small
   layouts, relative error <= 1e-5 (float32 in both, another summation
   order), two calls on one input bitwise equal; times of the kernel, the
   plain version and, as the yardstick, one torch.sparse CSR matvec of the
   same assembled operator;
7. Karman parity, lagged: KarmanProblem(lcar=0.2, n_refine=1) in float64,
   backward Euler, for 3 steps on the card (kernels) and on the CPU (plain
   versions): equal per-step iteration counts, U within 2e-6 and P within
   1e-4 of max|P| (the window kernels compute in float32 on both sides, in
   another summation order);
8. Karman lagged path: 1 warm-up step and 5 timed steps in float32, then
   one step with its substeps timed. Fails on a non-finite state, an
   unconverged solve, or no launch of K3 or K4b;
9. Karman parity, Newton: as 7 with Newton convection and BDF2 at the
   driver's tolerances: equal per-step Newton, linear, pressure and
   correction iterations, U within 2e-6 and P within 1e-4 of max|P|;
10. Karman Newton main path: run_karman_fast at its defaults (Newton,
   backward Euler, consistent force probe) on the window route,
   KarmanProblem(lcar=0.02, n_refine=5) in float32, one step per chunk:
   1 warm-up step and 5 timed steps, then one step with its substeps timed.
   Fails on a non-finite state or force, a last drag <= 0, an unconverged solve,
   or a step without its K3 Newton launches (2 per BiCGStab iteration), K3
   lagged launches (the velocity correction) or K4b launches;
11. K3 Newton at the main path's velocity layout, with the tables of the
   Newton path's final state: against its plain version (<= 1e-5
   relative), bitwise repeat, wall time (CUDA events), device time
   (torch.profiler, last, since profiling slows later host code),
   the plain version's time and the CSR yardstick of the assembled tangent.

The line before the last holds the kernel report, the one before it the
card; the last line is {"ok": true, "device": {...}}. Imports neither jax
nor flow_tpu.
"""
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# benchmark settings of the box path (bench.py, cavity3d with backend box)
BENCH_SETTINGS = dict(
    newton_tol=0.0, newton_rtol=1.0e-2, linear_rtol=1.0e-1,
    pressure_rtol=1.0e-4, correction_rtol=1.0e-5, cfl_target=1.0, dt_max=0.1,
)
DT0 = 1.0e-3
PRESSURE_MAXITER = 600  # BoxPackedStepper default
CORRECTION_MAXITER = 500  # fixed in BoxPackedStepper._correction

# the benchmark's FastStepper settings (bench.py:105-166, BENCH_PATCH=0) on
# the window route, with BiCGStab momentum as on the packed path
KARMAN_SETTINGS = dict(
    convection="lagged", rotational_form=True, momentum_solver="bicgstab",
    newton_tol=0.0, newton_rtol=1e-2, pressure_rtol=3e-4,
    pressure_maxiter=600, correction_rtol=1e-4, cfl_target=1.0, dt_max=1.0,
    packed=False, winkernel=True,
)
# run_karman_fast's defaults (flow_tpu/models/karman.py:301-327) with BDF2,
# for the Newton parity phase
KARMAN_NEWTON = dict(
    convection="newton", time_step_method="bdf2", rotational_form=True,
    momentum_solver="bicgstab", newton_tol=0.0, newton_rtol=1e-3,
    newton_maxiter=3, linear_rtol=1e-4, ew_forcing=False, pressure_rtol=1e-4,
    correction_rtol=1e-5, cfl_target=1.0, dt_max=1.0, packed=False,
    winkernel=True,
)
KARMAN_DT0 = 1.0e-4  # bench.py:197
KARMAN_MAIN = dict(lcar=0.02, n_refine=5)
KARMAN_DOFS = 1905056  # 2 n_V + n_Q of the JAX package's mesh at these args

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, float32 outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*args):
    print(*args, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def cuda_time_ms(fn, reps):
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps):
    """Device time per call from torch.profiler's kernel events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    cuda = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    us = (sum(e.device_time_total for e in cuda) if cuda
          else sum(e.self_device_time_total for e in events))
    return us / reps / 1e3


def bound_ms(nbytes, ops):
    """Least time for the work on the card, and what bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_build():
    from flow_tpu_torch import _build, native

    t0 = time.perf_counter()
    meshkit = {}

    def build_meshkit():
        try:
            meshkit["path"] = native.library_path()
        except Exception as e:  # reported below, after the nvcc builds
            meshkit["error"] = e

    th = threading.Thread(target=build_meshkit)
    th.start()
    names = ["stencil3d", "winstiff", "winmom"]
    _build.build_all(names)
    th.join()
    check("error" not in meshkit, f"meshkit build failed: {meshkit.get('error')}")
    for name in names:
        _build.load(name)
    secs = {n: round(_build.build_seconds.get(n, 0.0), 2) for n in names}
    log(f"[build] kernels and meshkit ready in {time.perf_counter() - t0:.2f} s "
        f"(nvcc seconds {secs}) into {_build.BUILD_DIR}")


def phase_stencil():
    import torch
    import torch.nn.functional as F
    from flow_tpu_torch.ops.stencil import stencil_apply_3d, stencil_apply_3d_plain

    shapes = [(65, 65, 65), (33, 33, 33), (17, 17, 17), (9, 9, 9), (5, 5, 5),
              (5, 6, 7), (2, 7, 9), (1, 4, 3), (1, 1, 1)]
    tols = {torch.float64: 1e-13, torch.float32: 1e-5}
    rng = np.random.default_rng(0)
    report = {}
    for dtype, tol in tols.items():
        for shape in shapes:
            x = torch.as_tensor(rng.standard_normal(shape), dtype=dtype, device="cuda")
            k = torch.as_tensor(rng.standard_normal((3, 3, 3)), dtype=dtype,
                                device="cuda")
            y = stencil_apply_3d(x, k)
            y_plain = stencil_apply_3d_plain(x, k)
            torch.cuda.synchronize()
            abs_err = float((y - y_plain).abs().max())
            rel_err = abs_err / max(float(y_plain.abs().max()), 1e-300)
            reps = 200 if x.numel() > 1000 else 50
            ms = cuda_time_ms(lambda: stencil_apply_3d(x, k), reps)
            plain_ms = cuda_time_ms(lambda: stencil_apply_3d_plain(x, k), reps)
            log(f"[stencil] {str(dtype):13s} {str(shape):15s} max_abs_err={abs_err:.3e} "
                f"rel_err={rel_err:.3e} kernel_ms={ms:.5f} plain_ms={plain_ms:.5f}")
            check(rel_err <= tol, f"stencil {shape} {dtype}: rel err {rel_err} > {tol}")
            report[(dtype, shape)] = (abs_err, ms, plain_ms)
    # the yardstick: a cuDNN convolution of the same stencil (TF32 is off)
    x = torch.as_tensor(rng.standard_normal((65, 65, 65)), dtype=torch.float32,
                        device="cuda")
    k = torch.as_tensor(rng.standard_normal((3, 3, 3)), dtype=torch.float32,
                        device="cuda")
    lib_ms = cuda_time_ms(lambda: F.conv3d(x[None, None], k[None, None], padding=1), 200)
    n = x.numel()
    b_ms, b_by = bound_ms(2 * 4 * n + 4 * 27, 54 * n)
    abs_err, ms, plain_ms = report[(torch.float32, (65, 65, 65))]
    log(f"[stencil] 65^3 f32 conv3d_ms={lib_ms:.5f} bound_ms={b_ms:.6f} ({b_by})")
    return dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)


def _cavity_run(n, dtype, device, n_steps, lmax=None):
    import torch
    from flow_tpu_torch import interop
    from flow_tpu_torch.models.cavity3d import Cavity3DProblem
    from flow_tpu_torch.navier_stokes.boxfast import BoxPackedStepper

    prob = Cavity3DProblem(n=n, mu=0.01, dtype=dtype, device=device)
    st = BoxPackedStepper(prob.V, prob.Q, prob.u_bcs, prob.p_bcs, prob.rho,
                          prob.mu, **BENCH_SETTINGS)
    if lmax is not None:
        interop.load_hierarchy_lmax(st.hierarchy, lmax)
    Uf, Pf = st.zeros()
    Uf, Pf, dt, tel = st.run(Uf, Pf, DT0, n_steps=n_steps)
    if device != "cpu":
        torch.cuda.synchronize()
    return st, Uf, Pf, tel


def phase_cavity_parity():
    import torch

    cpu, U_c, P_c, tel_c = _cavity_run(8, torch.float64, "cpu", 3)
    lmax = [L.lmax for L in cpu.hierarchy.levels]
    gpu, U_g, P_g, tel_g = _cavity_run(8, torch.float64, "cuda", 3, lmax=lmax)
    for key in ("linear_iters", "pressure_iters", "correction_iters"):
        a, b = tel_g[key].tolist(), tel_c[key].tolist()
        log(f"[cavity-parity] {key}: cuda={a} cpu={b}")
        check(a == b, f"cavity parity: {key} differ (cuda {a}, cpu {b})")
    du = float((U_g.cpu() - U_c).abs().max())
    dp = (P_g.cpu() - P_c)
    dp = float((dp - dp.mean()).abs().max())
    log(f"[cavity-parity] max|dU|={du:.3e} max|dP - mean|={dp:.3e}")
    check(du <= 1e-10, f"cavity parity: U differs by {du}")
    check(dp <= 1e-8, f"cavity parity: P differs by {dp}")


def phase_cavity_main():
    import torch
    from flow_tpu_torch.models.cavity3d import Cavity3DProblem
    from flow_tpu_torch.navier_stokes.boxfast import BoxPackedStepper
    from flow_tpu_torch.ops.stencil import STENCIL_3D

    t0 = time.perf_counter()
    prob = Cavity3DProblem(n=64, mu=0.01, dtype=torch.float32, device="cuda")
    st = BoxPackedStepper(prob.V, prob.Q, prob.u_bcs, prob.p_bcs, prob.rho,
                          prob.mu, **BENCH_SETTINGS)
    n_dofs = 3 * prob.V.n_dofs + prob.Q.n_dofs
    torch.cuda.synchronize()
    log(f"[cavity] n=64 n_dofs={n_dofs} setup {time.perf_counter() - t0:.1f} s")
    check(n_dofs == 6714692, f"unexpected n_dofs {n_dofs}")

    Uf, Pf = st.zeros()
    torch.cuda.reset_peak_memory_stats()
    STENCIL_3D.launches = 0
    Uf, Pf, dt, tel_w = st.run(Uf, Pf, DT0, n_steps=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Uf, Pf, dt, tel = st.run(Uf, Pf, dt, n_steps=5)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = STENCIL_3D.launches
    peak = torch.cuda.max_memory_allocated()

    tel_all = {k: tel_w[k].tolist() + tel[k].tolist() for k in tel}
    log(f"[cavity] steps/s={5 / elapsed:.4f} (5 steps in {elapsed:.3f} s, "
        f"after 1 warm-up step)")
    for k in ("dt", "linear_iters", "pressure_iters", "correction_iters"):
        log(f"[cavity] {k}: {tel_all[k]}")
    log(f"[cavity] peak_mem_bytes={peak} stencil_launches={launches}")
    check(bool(torch.isfinite(Uf).all()) and bool(torch.isfinite(Pf).all()),
          "cavity: non-finite state")
    check(bool(torch.isfinite(dt)), "cavity: non-finite dt")
    check(max(tel_all["pressure_iters"]) < PRESSURE_MAXITER,
          "cavity: a pressure solve did not converge")
    check(max(tel_all["correction_iters"]) < CORRECTION_MAXITER,
          "cavity: a correction solve did not converge")
    check(launches > 0, "cavity: the stencil kernel was never launched")
    umax = float(Uf.abs().max())
    check(abs(umax - 1.0) < 1e-6, f"cavity: max |u| {umax} is not the lid speed")
    return launches


def _karman(dtype, device, lcar, n_refine, lmax=None, settings=KARMAN_SETTINGS):
    from flow_tpu_torch import interop
    from flow_tpu_torch.models.karman import KarmanProblem
    from flow_tpu_torch.navier_stokes.fast import FastStepper
    from flow_tpu_torch.solvers.multigrid import P1Hierarchy

    prob = KarmanProblem(lcar=lcar, n_refine=n_refine, dtype=dtype, device=device)
    st = FastStepper(prob.V, prob.Q, prob.u_bcs, prob.p_bcs, prob.rho, prob.mu,
                     **settings)
    hier = P1Hierarchy(prob.mesh_hierarchy, bc_mask=st.mask_p, smoother_degree=3,
                       winkernel=True, fine_window=st.K_Q)
    if lmax is not None:
        interop.load_hierarchy_lmax(hier, lmax)
    st.pressure_precond = hier.v_cycle
    return prob, st, hier


def _check_solves(tel, where):
    for key in ("momentum_converged", "pressure_converged", "correction_converged"):
        check(bool(tel[key].all()), f"{where}: a {key.split('_')[0]} solve did not converge")


def phase_karman_setup():
    import torch

    t0 = time.perf_counter()
    prob, st, hier = _karman(torch.float32, "cuda", **KARMAN_MAIN)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    log(f"[karman] {KARMAN_MAIN} n_dofs={prob.n_dofs} setup {setup:.1f} s")
    check(prob.n_dofs == KARMAN_DOFS, f"unexpected n_dofs {prob.n_dofs}")
    for name, wl in (("V", st.winmom.wl), ("Q", st.K_Q.wl)):
        log(f"[karman] {name} layout: n={wl.n} nb={wl.nb} S={wl.S} W={wl.W} C={wl.C}")
    for L in hier.levels:
        if L.win is not None:
            wl = L.win.wl
            log(f"[karman] MG level n={L.n} window layout: nb={wl.nb} S={wl.S} "
                f"W={wl.W} C={wl.C}")
    check(sum(L.win is not None for L in hier.levels) == 2,
          "karman: expected window levels at 53,392 and 212,256 dofs")
    check(hier.levels[-1].win is st.K_Q,
          "karman: the finest level does not reuse the pressure operator")
    return prob, st, hier, setup


def _csr(rows, cols, vals, n):
    import torch

    A = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, (n, n)).coalesce()
    return A.to_sparse_csr()


def _stiffness_csr(op):
    """The window stiffness operator assembled on the padded permuted dofs."""
    import torch

    wl = op.wl
    nb, NL, C = op.lidx.shape
    K = op.kref.view(4, NL, NL)
    Ae = torch.einsum("bkc,kij->bcij", op.Cg, K) * op.valid[:, :, None, None]
    g = (torch.arange(nb, device=op.lidx.device) * wl.S)[:, None, None] \
        + op.lidx.permute(0, 2, 1)  # [b, c, i]
    rows = g[:, :, :, None].expand(nb, C, NL, NL).reshape(-1).long()
    cols = g[:, :, None, :].expand(nb, C, NL, NL).reshape(-1).long()
    return _csr(rows, cols, Ae.reshape(-1), wl.n_pad)


def _momentum_csr(op, Tq, scal, Uq=None, Gu=None):
    """The window momentum operator (with Uq/Gu the Newton tangent)
    assembled on the padded permuted dofs of both components (row
    m*n_pad + dof): element matrices from the plain local apply on unit
    inputs."""
    import torch
    from flow_tpu_torch.attic.winmom import momentum_local_plain

    wl = op.wl
    nb, NL, C = op.lidx.shape
    dev = op.lidx.device
    g = (torch.arange(nb, device=dev) * wl.S)[:, None, None] + op.lidx  # [b, i, c]
    rows, cols, vals = [], [], []
    for n in range(2):
        for j in range(NL):
            U = torch.zeros((2, nb, NL, C), dtype=torch.float32, device=dev)
            U[n, :, j, :] = 1.0
            loc = momentum_local_plain(U, op.valid, op.detj, op.G4, op.Cg4, Tq,
                                       op.tabs, scal, Uq, Gu)  # [m, b, i, c]
            for m in range(2):
                rows.append((m * wl.n_pad + g).reshape(-1))
                cols.append((n * wl.n_pad + g[:, j:j + 1, :]).expand(nb, NL, C).reshape(-1))
                vals.append(loc[m].reshape(-1))
    return _csr(torch.cat(rows).long(), torch.cat(cols).long(), torch.cat(vals),
                2 * wl.n_pad)


def _winstiff_work(op):
    """Bytes and operations of one window stiffness apply: the inputs the
    function needs (x, lidx, valid, Cg, Kref) read once and the output
    windows written once, not the scatter lists that only this kernel's
    design reads; the per-cell arithmetic on the real cells, plus the
    scatter sums."""
    wl = op.wl
    nb, NL, C = op.lidx.shape
    cells = int(op.valid.sum())
    nbytes = 4 * (wl.n_pad + nb * NL * C + nb * C + 4 * nb * C + 4 * NL * NL
                  + nb * wl.W)
    ops = cells * (NL * (4 * (2 * NL + 2)) + NL) + cells * NL
    return nbytes, ops


def _winmom_work(op, newton=False):
    """Bytes and operations of one window momentum apply: the inputs the
    function needs read once and the output windows written once, not the
    scatter lists that only this kernel's design reads; the per-cell
    arithmetic of csrc/winmom.cu (DIM=2, NL=6, NQ=7) on the real cells, plus
    the scatter sums. Newton mode adds the gradient table Gu and the
    reaction term; its state table Uq is Tq, counted once."""
    wl = op.wl
    nb, NL, C = op.lidx.shape
    DIM, NQ = 2, op.nq
    cells = int(op.valid.sum())
    nbytes = 4 * (DIM * wl.n_pad + nb * NL * C + 2 * nb * C + 2 * DIM * DIM * nb * C
                  + DIM * NQ * nb * C + op.tabs.numel() + 3 + DIM * nb * wl.W
                  + (DIM * DIM * NQ * nb * C if newton else 0))
    per_comp = (NQ * NL * 2 + DIM * NQ * NL * 2 + NQ * DIM * DIM * 2
                + NQ * (2 * DIM + 2) + NQ * DIM * 3
                + NL * ((2 * NL + 2) + (2 * NQ + DIM * DIM * (2 * NQ + 2)) + 2
                        + DIM * DIM * (2 * NL + 2) + 2))
    coupling = DIM * DIM * DIM * NL * (2 * NL + 2 + 3 * DIM)
    per_cell = DIM * per_comp + coupling + NQ + DIM * NL
    if newton:
        # per quadrature point: direction values, v.grad phi_i, and per
        # component (v.grad x)_m and the NL updates; then s_rho * re
        per_q = DIM * NL * 2 + 1 + NL * DIM * DIM * 3 + DIM * (2 * DIM + 2 + 4 * NL)
        per_cell += NQ * per_q + DIM * NL * 2
    return nbytes, cells * per_cell + DIM * cells * NL


def _rel(a, b):
    return float((a - b).abs().max()), float((a - b).abs().max() / b.abs().max())


def _check_kernel(name, fn, plain, tol=1e-5):
    import torch

    y = fn()
    y2 = fn()
    y_plain = plain()
    torch.cuda.synchronize()
    check(torch.equal(y, y2), f"{name}: two calls on one input differ")
    abs_err, rel_err = _rel(y, y_plain)
    check(rel_err <= tol, f"{name}: rel err {rel_err} > {tol}")
    return abs_err, rel_err


def phase_window_kernels(st, hier):
    import torch
    from flow_tpu_torch.attic import winkernel, winmom
    from flow_tpu_torch.models.karman import KarmanProblem

    rng = np.random.default_rng(1)
    report = {}

    # ragged small layouts: S=128 and auto
    small = KarmanProblem(lcar=0.1, n_refine=1, dtype=torch.float32, device="cuda")
    T = torch.as_tensor(rng.standard_normal((small.V.n_dofs, 2)), dtype=torch.float32,
                        device="cuda")
    for S in (128, None):
        op = winkernel.WindowStiffnessOperator(small.Q, S=S)
        x = torch.zeros(op.wl.n_pad, device="cuda")
        x[:op.wl.n] = torch.as_tensor(rng.standard_normal(op.wl.n), dtype=torch.float32)
        err = _check_kernel(
            "winstiff small", lambda: op.windows(x),
            lambda: winkernel.stiffness_windows_plain(
                x, op.lidx, op.valid, op.Cg, op.kref, op.wl.S, op.wl.W))
        mo = winmom.WindowLaggedMomentum(small.V, S=S)
        Tq = mo.transport_qp(T)
        xp = torch.zeros((2, mo.wl.n_pad), device="cuda")
        xp[:, :mo.wl.n] = torch.as_tensor(rng.standard_normal((2, mo.wl.n)),
                                          dtype=torch.float32)
        errm = _check_kernel(
            "winmom small", lambda: mo.windows(xp, Tq, 1.0, 0.37, 0.021),
            lambda: winmom.momentum_windows_plain(
                xp, mo.lidx, mo.valid, mo.detj, mo.G4, mo.Cg4, Tq, mo.tabs,
                mo._scal(1.0, 0.37, 0.021), mo.wl.S, mo.wl.W))
        Tn, Un, Gn = mo.state_qp(T)
        errn = _check_kernel(
            "winmom newton small", lambda: mo.windows(xp, Tn, 1.0, 0.37, 0.021, Un, Gn),
            lambda: winmom.momentum_windows_plain(
                xp, mo.lidx, mo.valid, mo.detj, mo.G4, mo.Cg4, Tn, mo.tabs,
                mo._scal(1.0, 0.37, 0.021), mo.wl.S, mo.wl.W, Un, Gn))
        log(f"[window] small S={S} nb={op.wl.nb}/{mo.wl.nb} "
            f"winstiff rel_err={err[1]:.3e} winmom rel_err={errm[1]:.3e} "
            f"winmom newton rel_err={errn[1]:.3e}")

    # the main path's layouts: K4b on the pressure operator and the two
    # window levels of the hierarchy below the finest (which is the pressure
    # operator itself), K3 on the velocity layout
    ops = [("pressure", st.K_Q)] + [(f"mg n={L.n}", L.win) for L in hier.levels
                                    if L.win is not None and L.win is not st.K_Q]
    for name, op in ops:
        x = torch.zeros(op.wl.n_pad, device="cuda")
        x[:op.wl.n] = torch.as_tensor(rng.standard_normal(op.wl.n), dtype=torch.float32)
        abs_err, rel_err = _check_kernel(
            f"winstiff {name}", lambda: op.windows(x),
            lambda: winkernel.stiffness_windows_plain(
                x, op.lidx, op.valid, op.Cg, op.kref, op.wl.S, op.wl.W))
        ms = cuda_time_ms(lambda: op.windows(x), 100)
        plain_ms = cuda_time_ms(lambda: winkernel.stiffness_windows_plain(
            x, op.lidx, op.valid, op.Cg, op.kref, op.wl.S, op.wl.W), 10)
        A = _stiffness_csr(op)
        _, csr_err = _rel((A @ x)[:op.wl.n], op.wl.overlap_add(op.windows(x)))
        check(csr_err <= 1e-5, f"winstiff {name}: the CSR yardstick differs ({csr_err})")
        lib_ms = cuda_time_ms(lambda: A @ x, 100)
        nbytes, nops = _winstiff_work(op)
        b_ms, b_by = bound_ms(nbytes, nops)
        log(f"[window] winstiff {name}: n={op.wl.n} max_abs_err={abs_err:.3e} "
            f"rel_err={rel_err:.3e} kernel_ms={ms:.5f} plain_ms={plain_ms:.5f} "
            f"csr_ms={lib_ms:.5f} (nnz {A.values().numel()}) bytes={nbytes} ops={nops} "
            f"bound_ms={b_ms:.6f} ({b_by})")
        report.setdefault("winstiff", dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                                           bound_ms=b_ms, bound_by=b_by,
                                           library_ms=lib_ms))
        del A

    op = st.winmom
    T = torch.as_tensor(0.01 * rng.standard_normal((op.wl.n, 2)), dtype=torch.float32,
                        device="cuda")
    Tq = op.transport_qp(T)
    xp = torch.zeros((2, op.wl.n_pad), device="cuda")
    xp[:, :op.wl.n] = torch.as_tensor(rng.standard_normal((2, op.wl.n)),
                                      dtype=torch.float32)
    # the weights of a momentum matvec at dt = 1e-3
    s = 1e-3 / st.rho
    w = (1.0, s * st.rho, s * st.mu)
    scal = op._scal(*w)
    for weights, tag in ((w, "momentum"), ((1.0, 0.0, 0.0), "mass")):
        abs_err, rel_err = _check_kernel(
            f"winmom {tag}", lambda: op.windows(xp, Tq, *weights),
            lambda: winmom.momentum_windows_plain(
                xp, op.lidx, op.valid, op.detj, op.G4, op.Cg4, Tq, op.tabs,
                op._scal(*weights), op.wl.S, op.wl.W))
        log(f"[window] winmom {tag}: max_abs_err={abs_err:.3e} rel_err={rel_err:.3e}")
        if tag == "momentum":
            err_main = abs_err
    ms = cuda_time_ms(lambda: op.windows(xp, Tq, *w), 100)
    plain_ms = cuda_time_ms(lambda: winmom.momentum_windows_plain(
        xp, op.lidx, op.valid, op.detj, op.G4, op.Cg4, Tq, op.tabs, scal,
        op.wl.S, op.wl.W), 5)
    A = _momentum_csr(op, Tq, scal)
    xf = xp.reshape(-1)
    y_csr = (A @ xf).view(2, op.wl.n_pad)[:, :op.wl.n]
    _, csr_err = _rel(y_csr, op.wl.overlap_add(op.windows(xp, Tq, *w)))
    check(csr_err <= 1e-5, f"winmom: the CSR yardstick differs ({csr_err})")
    lib_ms = cuda_time_ms(lambda: A @ xf, 100)
    nbytes, nops = _winmom_work(op)
    b_ms, b_by = bound_ms(nbytes, nops)
    log(f"[window] winmom main: n={op.wl.n} kernel_ms={ms:.5f} plain_ms={plain_ms:.5f} "
        f"csr_ms={lib_ms:.5f} (nnz {A.values().numel()}) bytes={nbytes} ops={nops} "
        f"bound_ms={b_ms:.6f} ({b_by})")
    report["winmom"] = dict(max_abs_err=err_main, ms=ms, plain_ms=plain_ms,
                            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
    del A
    torch.cuda.empty_cache()
    return report


def phase_karman_parity(settings, tag):
    import torch

    runs = {}
    lmax = None
    for device in ("cpu", "cuda"):
        prob, st, hier = _karman(torch.float64, device, lcar=0.2, n_refine=1, lmax=lmax,
                                 settings=settings)
        lmax = [L.lmax for L in hier.levels]
        U, P, dt, tel = st.run(*st.zeros(), KARMAN_DT0, n_steps=3)[:4]
        if device == "cuda":
            torch.cuda.synchronize()
        _check_solves(tel, f"{tag} ({device})")
        runs[device] = (U.cpu(), P.cpu(), tel)
    (U_c, P_c, tel_c), (U_g, P_g, tel_g) = runs["cpu"], runs["cuda"]
    for key in ("newton_iters", "linear_iters", "pressure_iters", "correction_iters"):
        a, b = tel_g[key].tolist(), tel_c[key].tolist()
        log(f"[{tag}] {key}: cuda={a} cpu={b}")
        check(a == b, f"{tag}: {key} differ (cuda {a}, cpu {b})")
    du = float((U_g - U_c).abs().max())
    dp = float((P_g - P_c).abs().max())
    pmax = float(P_c.abs().max())
    log(f"[{tag}] max|dU|={du:.3e} (max|U| {float(U_c.abs().max()):.3e}) "
        f"max|dP|={dp:.3e} (max|P| {pmax:.3e})")
    check(du <= 2e-6, f"{tag}: U differs by {du}")
    check(dp <= 1e-4 * pmax, f"{tag}: P differs by {dp}")


def _timed_step(st, U, P, dt):
    """One step with each substep synchronised and timed (ms)."""
    import torch

    times = {}

    def timed(name, fn):
        def wrapper(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            times[name] = 1e3 * (time.perf_counter() - t0)
            return out
        return wrapper

    st._pressure_solve = timed("pressure", st._pressure_solve)
    st._correction = timed("correction", st._correction)
    try:
        timed("step", st._step_impl)(U, P, dt)
    finally:
        del st._pressure_solve, st._correction
    times["momentum"] = times["step"] - times["pressure"] - times["correction"]
    return times


def phase_karman_main(prob, st, setup):
    import torch
    from flow_tpu_torch.attic.winkernel import WINSTIFF
    from flow_tpu_torch.attic.winmom import WINMOM

    U, P = st.zeros()
    torch.cuda.reset_peak_memory_stats()
    WINMOM.launches = 0
    WINSTIFF.launches = 0
    U, P, dt, tel_w = st.run(U, P, KARMAN_DT0, n_steps=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    U, P, dt, tel = st.run(U, P, dt, n_steps=5)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {"winmom": WINMOM.launches, "winstiff": WINSTIFF.launches}
    peak = torch.cuda.max_memory_allocated()

    tel_all = {k: tel_w[k].tolist() + tel[k].tolist() for k in tel}
    log(f"[karman] steps/s={5 / elapsed:.4f} (5 steps in {elapsed:.3f} s, after 1 "
        f"warm-up step; setup {setup:.1f} s)")
    for k in ("dt", "linear_iters", "pressure_iters", "correction_iters"):
        log(f"[karman] {k}: {tel_all[k]}")
    log(f"[karman] peak_mem_bytes={peak} launches={launches} "
        f"(per step: winmom {launches['winmom'] / 6:.1f}, "
        f"winstiff {launches['winstiff'] / 6:.1f})")
    check(tuple(U.shape) == (prob.V.n_dofs, 2) and tuple(P.shape) == (prob.Q.n_dofs,),
          "karman: state of the wrong shape")
    check(bool(torch.isfinite(U).all()) and bool(torch.isfinite(P).all()),
          "karman: non-finite state")
    check(bool(torch.isfinite(dt)), "karman: non-finite dt")
    _check_solves(tel_w, "karman")
    _check_solves(tel, "karman")
    check(launches["winmom"] > 0, "karman: the window momentum kernel was never launched")
    check(launches["winstiff"] > 0, "karman: the window stiffness kernel was never launched")
    umax = float(U.abs().max())
    # the inflow and outflow profiles peak at u_in = 0.01 on Dirichlet dofs
    check(0.0099 <= umax <= 0.1, f"karman: max |u| {umax} out of range")

    times = _timed_step(st, U, P, dt)
    log("[karman] substeps ms (one synchronised step): "
        + ", ".join(f"{k}={v:.2f}" for k, v in times.items()))
    return launches


def phase_newton_main():
    """run_karman_fast at its defaults on the window route at 1.9M DoF, one
    step per chunk: the first chunk is the warm-up, the next five are
    timed (each chunk ends in a device->host copy of its telemetry)."""
    import torch
    from flow_tpu_torch.attic.winkernel import WINSTIFF
    from flow_tpu_torch.attic.winmom import WINMOM, WINMOM_NEWTON
    from flow_tpu_torch.models.karman import run_karman_fast

    torch.cuda.reset_peak_memory_stats()
    WINMOM.launches = WINMOM_NEWTON.launches = WINSTIFF.launches = 0
    t0 = time.perf_counter()
    out = run_karman_fast(num_steps=6, chunk_size=1, winkernel=True,
                          dtype=torch.float32, device="cuda", **KARMAN_MAIN)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = {"winmom_newton": WINMOM_NEWTON.launches, "winmom": WINMOM.launches,
                "winstiff": WINSTIFF.launches}
    peak = torch.cuda.max_memory_allocated()
    prob, st, tel = out["problem"], out["stepper"], out["telemetry"]
    timed = sum(out["chunk_seconds"][1:])
    setup = total - sum(out["chunk_seconds"])
    log(f"[newton] run_karman_fast {KARMAN_MAIN} n_dofs={prob.n_dofs} float32 "
        f"convection={'lagged' if st.lagged else 'newton'} theta={st.theta}")
    log(f"[newton] steps/s={5 / timed:.4f} (5 steps in {timed:.3f} s, after 1 warm-up "
        f"step of {out['chunk_seconds'][0]:.3f} s; setup {setup:.1f} s)")
    for k in ("dt", "newton_iters", "linear_iters", "pressure_iters", "correction_iters"):
        log(f"[newton] {k}: {tel[k].tolist()}")
    log(f"[newton] drag: {tel['forces'][:, 0].tolist()}")
    log(f"[newton] lift: {tel['forces'][:, 1].tolist()}")
    log(f"[newton] peak_mem_bytes={peak} launches={launches} (per step: "
        + ", ".join(f"{k} {v / 6:.1f}" for k, v in launches.items()) + ")")
    check(prob.n_dofs == KARMAN_DOFS, f"newton: unexpected n_dofs {prob.n_dofs}")
    check(not st.lagged and st.theta == (0.0, 1.0), "newton: not the driver's defaults")
    U, P = out["u"], out["p"]
    check(tuple(U.shape) == (prob.V.n_dofs, 2) and tuple(P.shape) == (prob.Q.n_dofs,),
          "newton: state of the wrong shape")
    check(bool(torch.isfinite(U).all()) and bool(torch.isfinite(P).all()),
          "newton: non-finite state")
    check(np.isfinite(tel["forces"]).all(), "newton: non-finite forces")
    # the last step's drag: early in the start from rest the consistent
    # functional's rho du/dt term turns it negative (steps 3-4 at lcar=0.02,
    # n_refine 0-3; step 3 at n_refine 5); by step 6 it is near the
    # traction drag
    check(tel["forces"][-1, 0] > 0, "newton: the last step's drag is not positive")
    for key in ("momentum_converged", "pressure_converged", "correction_converged"):
        check(bool(tel[key].all()), f"newton: a {key.split('_')[0]} solve did not converge")
    check(bool((tel["newton_iters"] >= 1).all() and (tel["linear_iters"] >= 1).all()),
          "newton: a step without a Newton iteration")
    # every BiCGStab iteration is two K3 Newton launches; the correction CG
    # one K3 lagged launch per iteration plus one for its right-hand side
    check(launches["winmom_newton"] == 2 * int(tel["linear_iters"].sum()),
          "newton: K3 Newton launches do not match the BiCGStab iterations")
    check(launches["winmom"] == int(tel["correction_iters"].sum()) + 6,
          "newton: K3 lagged launches do not match the correction iterations")
    check(launches["winstiff"] > 0, "newton: the window stiffness kernel was never launched")
    umax = float(U.abs().max())
    check(0.0099 <= umax <= 0.1, f"newton: max |u| {umax} out of range")
    log(f"[newton] traction drag/lift at the final state: {prob.forces(U, P)}")
    times = _timed_step(st, U, P, st._scalar(out["dt"]))
    log("[newton] substeps ms (one synchronised step): "
        + ", ".join(f"{k}={v:.2f}" for k, v in times.items()))
    return out, launches


def phase_newton_kernel(st, U):
    """K3 Newton at the main path's velocity layout, with the tables of the
    Newton path's final state."""
    import torch
    from flow_tpu_torch.attic import winmom

    op = st.winmom
    rng = np.random.default_rng(2)
    Tq, Uq, Gu = op.state_qp(U)
    xp = torch.zeros((2, op.wl.n_pad), device="cuda")
    xp[:, :op.wl.n] = torch.as_tensor(rng.standard_normal((2, op.wl.n)),
                                      dtype=torch.float32)
    s = 1e-3 / st.rho
    w = (1.0, s * st.rho, s * st.mu)
    scal = op._scal(*w)

    def kernel():
        return op.windows(xp, Tq, *w, Uq, Gu)

    def plain():
        return winmom.momentum_windows_plain(xp, op.lidx, op.valid, op.detj, op.G4,
                                             op.Cg4, Tq, op.tabs, scal, op.wl.S,
                                             op.wl.W, Uq, Gu)

    abs_err, rel_err = _check_kernel("winmom newton main", kernel, plain)
    ms = cuda_time_ms(kernel, 100)
    plain_ms = cuda_time_ms(plain, 5)
    A = _momentum_csr(op, Tq, scal, Uq, Gu)
    xf = xp.reshape(-1)
    y_csr = (A @ xf).view(2, op.wl.n_pad)[:, :op.wl.n]
    _, csr_err = _rel(y_csr, op.wl.overlap_add(kernel()))
    check(csr_err <= 1e-5, f"winmom newton: the CSR yardstick differs ({csr_err})")
    lib_ms = cuda_time_ms(lambda: A @ xf, 100)
    nnz = A.values().numel()
    del A
    torch.cuda.empty_cache()
    nbytes, nops = _winmom_work(op, newton=True)
    b_ms, b_by = bound_ms(nbytes, nops)
    dev_ms = device_ms(kernel, 50)
    log(f"[window] winmom newton main: n={op.wl.n} nb={op.wl.nb} C={op.wl.C} "
        f"max_abs_err={abs_err:.3e} rel_err={rel_err:.3e} kernel_ms={ms:.5f} "
        f"device_ms={dev_ms:.5f} plain_ms={plain_ms:.5f} csr_ms={lib_ms:.5f} "
        f"(nnz {nnz}) bytes={nbytes} ops={nops} bound_ms={b_ms:.6f} ({b_by})")
    return dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs a GPU",
              file=sys.stderr)
        return 2
    if not (ROOT / "flow_tpu_torch" / "csrc" / "stencil3d.cu").is_file():
        print(f"chip_smoke: flow_tpu_torch sources not found beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))

    smi = nvidia_smi_line()
    log(f"[device] {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t_start = time.perf_counter()
    try:
        phase_build()
        k1 = phase_stencil()
        phase_cavity_parity()
        k1["launches"] = phase_cavity_main()
        prob, st, hier, setup = phase_karman_setup()
        kwin = phase_window_kernels(st, hier)
        phase_karman_parity(KARMAN_SETTINGS, "karman-parity")
        lagged = phase_karman_main(prob, st, setup)
        del prob, st, hier
        torch.cuda.empty_cache()
        phase_karman_parity(KARMAN_NEWTON, "newton-parity")
        out, newton = phase_newton_main()
        knewton = phase_newton_kernel(out["stepper"], out["u"])
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(f"[done] all phases in {time.perf_counter() - t_start:.1f} s")
    # launches: the Newton main path's counts (this slice's path), with the
    # lagged path's beside them; K1's from the cavity path
    kwin["winmom"]["launches"] = newton["winmom"]
    kwin["winstiff"]["launches"] = newton["winstiff"]
    knewton["launches"] = newton["winmom_newton"]
    paths = {"winmom": {"karman_newton": newton["winmom"], "karman_lagged": lagged["winmom"]},
             "winstiff": {"karman_newton": newton["winstiff"],
                          "karman_lagged": lagged["winstiff"]}}
    rows = [
        dict(name="stencil_apply_3d", route="cuda",
             source="flow_tpu_torch/csrc/stencil3d.cu",
             replaces="flow_tpu/ops/pallas_stencil.py:71", **k1),
        dict(name="momentum_windows (lagged)", route="cuda",
             source="flow_tpu_torch/csrc/winmom.cu",
             replaces="flow_tpu/attic/winmom.py:190", **kwin["winmom"]),
        dict(name="momentum_windows (Newton)", route="cuda",
             source="flow_tpu_torch/csrc/winmom.cu",
             replaces="flow_tpu/attic/winmom.py:199", **knewton),
        dict(name="stiffness_windows", route="cuda",
             source="flow_tpu_torch/csrc/winstiff.cu",
             replaces="flow_tpu/attic/winkernel.py:259", **kwin["winstiff"]),
    ]
    log(f"[done] launches by path: {json.dumps(paths)}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
