#!/usr/bin/env python3
"""Smoke run of flow_tpu_torch on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. device and build: the card's name and power limit from nvidia-smi, then
   the eight CUDA sources (csrc/stencil3d.cu, stencil2d.cu, winstiff.cu,
   winmom.cu, winmom3d.cu, winmass.cu, winform.cu, ell.cu), one nvcc each,
   started together, and the meshkit library (g++) beside them;
2. stencils against plain: the 27-point kernel (K1) on the 3-D cavity
   path's grids and the 9-point kernel (K2) on the 2-D multigrid levels of
   2,049^2 down, plus ragged grids (partial tiles, strips and chunks; sides
   of 1, 2 and 3), against their plain PyTorch versions, in float64
   (relative error <= 1e-13 for K1, 1e-12 for K2) and float32 (<= 1e-5:
   another summation order), two calls bitwise equal; at every level grid
   the operator's launch (StencilLaunch, fixed at construction) bitwise
   equal to the wrapper's, its wall time, its host µs a call and the
   checked wrapper's; cuDNN's convolution as the yardstick;
3. cavity parity: Cavity3DProblem(n=8) in float64 for 3 steps on the card
   and on the CPU: equal per-step iteration counts, U within 1e-10 and the
   mean-removed P within 1e-8;
4. cavity main path: Cavity3DProblem(n=64), 6,714,692 DoF, float32, the
   benchmark's box-path settings: 1 warm-up step and 5 timed steps; K1's
   launches by grid; fails if the iterations are not BOX_ITERS (K1 sums in
   the order it always did);
5. Karman setup: KarmanProblem(lcar=0.02, n_refine=5), 1,905,056 DoF, the
   FastStepper window route with the benchmark's lagged FastStepper
   settings and a P1Hierarchy with window levels from 20,000 dofs;
6. window kernels against plain: the window momentum kernel (K3, lagged)
   and the window stiffness kernel (K4b) against their plain versions at
   the Karman main path's layouts, and K3 lagged and Newton on ragged small
   layouts, relative error <= 1e-5 (float32 in both, another summation
   order), two calls on one input bitwise equal; times of the kernel, the
   plain version and, as the yardstick, one torch.sparse CSR matvec of the
   same assembled operator; K3's cluster launch (csrc/wincluster.cuh:
   blocks per cluster, threads, positions staged a block, passes, the
   clusters launched and the clusters the card holds at once), its
   compressed rows and its host µs a call;
7. Karman parity, lagged: KarmanProblem(lcar=0.2, n_refine=1) in float64,
   backward Euler, for 3 steps on the card (kernels) and on the CPU (plain
   versions): equal per-step iteration counts, U within 2e-6 and P within
   1e-4 of max|P| (the window kernels compute in float32 on both sides, in
   another summation order);
8. Karman lagged path: 1 warm-up step and 5 timed steps in float32, then
   one step with its substeps timed. Fails on a non-finite state, an
   unconverged solve, no launch of K3 or K4b, or if the BiCGStab, pressure
   and correction iterations are not KARMAN_LAGGED_ITERS (K3 2-D sums in
   the order it always did);
9. Karman parity, Newton: as 7 with Newton convection and BDF2 at the
   driver's tolerances: equal per-step Newton, linear, pressure and
   correction iterations, U within 2e-6 and P within 1e-4 of max|P|;
10. Karman Newton main path: run_karman_fast at its defaults (Newton,
   backward Euler, consistent force probe) on the window route,
   KarmanProblem(lcar=0.02, n_refine=5) in float32, one step per chunk:
   1 warm-up step and 5 timed steps, then one step with its substeps timed.
   Fails on a non-finite state or force, a last drag <= 0, an unconverged solve,
   a step without its K3 Newton launches (2 per BiCGStab iteration), K3
   lagged launches (the velocity correction) or K4b launches, or if the
   Newton, BiCGStab, pressure and correction iterations are not
   KARMAN_NEWTON_ITERS;
11. K3 Newton at the main path's velocity layout, with the tables of the
   Newton path's final state: against its plain version (<= 1e-5
   relative), bitwise repeat, wall time (CUDA events), host µs a call, the
   plain version's time and the CSR yardstick of the assembled tangent;
   its cluster launch and compressed rows;
12. 3-D parity: run_cavity3d_fast(n=4, winkernel=True) in float64 for 3
   steps on the card (kernels) and on the CPU (plain versions), lambda_max
   carried across: equal per-step iteration counts, U within 2e-6 and P
   within 1e-4 of max|P|;
13. 3-D main path: run_cavity3d_fast(n=64, winkernel=True) in float32,
   6,714,692 DoF, the JAX driver's defaults (Newton, backward Euler), one
   step per chunk: 1 warm-up step and 3 timed steps, then one step with its
   substeps timed. Fails on a non-finite state, an unconverged solve, or a
   step without its K3 3-D Newton launches (2 per BiCGStab iteration), K3
   3-D lagged launches (the velocity correction), K4b 3-D launches (one per
   pressure CG iteration) or K1 launches (the V-cycle), or if the Newton,
   BiCGStab, pressure and correction iterations are not CAVITY3D_ITERS (K3
   3-D sums in the order it always did);
14. 3-D kernels at the main path's layouts, with the tables of its final
   state: K3 3-D lagged and Newton (velocity, nb=525, C=3,063) and K4b 3-D
   (pressure, nb=68, C=23,958) against their plain versions (<= 1e-5
   relative), bitwise repeat, wall times and the plain versions' times;
   the cluster launches of K3 3-D and K4b 3-D (csrc/wincluster.cuh: blocks
   per cluster, threads, positions staged a block, passes, the clusters
   launched and the clusters the card holds at once; K3's compressed rows),
   K3 3-D's host µs a call and the time of the overlap-add of its velocity
   windows, and a layout of stride 16,384 on the same
   mesh, which runs in more than one pass, against its plain version; the
   CSR yardstick of K4b at N=64 and of K3 3-D at N=32, beside the kernel's
   time at N=32 (the assembled N=64 tangent has ~1.4G element entries
   before coalescing);
15. 2-D structured parity: the MG-preconditioned CG Poisson solves of
   unit_square_mesh(32) (Neumann and Dirichlet) in float64 on the card (K2)
   and on the CPU, lambda_max carried across: equal iterations, solutions
   within 1e-10;
16. 2-D structured main path: unit_square_mesh(2048), P1, 4,198,401 DoF,
   float32, the same two solves at rtol 1e-6 with a 6-level
   StructuredHierarchy; fails on no convergence, no K2 launch, a solution
   more than 1e-4 (relative) from the float64 solve, a true float64
   residual above 3e-4 of |b|, or if the CG iterations of the two solves
   and of their float64 references are not STRUCTURED2D_ITERS; K2's
   launches by grid;
17. formwin2d: unit_square_mesh(1024) P2, 4,198,401 DoF, float32: 1 + 5
   implicit Euler steps of a rotating convection-diffusion operator
   compiled by formlang, applied by K5 (window_operator) with the mass
   right-hand side by K4a (WindowMassOperator) and Jacobi-BiCGStab; fails
   unless K4a launches once per step and K5 once per BiCGStab matvec, or if
   the steps differ from the reference (CompiledForm.apply and mass_apply,
   run under torch's deterministic algorithms) by more than one iteration
   in any step or 1e-4 relative in the state, or if the iterations are not
   FORMWIN_ITERS (the kernels sum in the order they always did); then
   K4a and K5 against their plain versions at this layout, with the CSR
   yardstick and their cluster launch, whose clusters the card must hold
   at once;
18. K4b P2: Jacobi-CG Dirichlet P2 Poisson solves with WindowStiffnessOperator
   on unit_square_mesh(256) and box_mesh N=32 tets, float64 vectors
   (launches = iterations, solution within 1e-3 of the einsum operator's),
   each operator then against its plain version at its layout (2-D P2,
   NL = 6; 3-D P2, NL = 10), with its cluster launch (csrc/wincluster.cuh,
   window_plan's rule; the clusters the card holds at once must cover it)
   and its host µs per call; then K4a and K5 at NL = 10 on the tet layout
   against their plain versions, with the CSR yardstick and their cluster
   launch (68 window blocks: one cluster each, all resident), and at NL = 3
   and 4 on the P1 layouts of the same meshes;
19. big blocks: K4b 2-D P1 and K3 2-D lagged and Newton on
   unit_square_mesh(128) layouts with S=16,384, whose blocks hold more cells
   than one block's shared memory could (C=32,318 and 8,158), against
   their plain versions (K4b's local results live in a device scratch,
   K3's in the shared memory of a cluster of blocks);
20. einsum parity: run_karman_fast(winkernel=False) at its defaults on
   KarmanProblem(lcar=0.2, n_refine=2) in float64 for 3 steps on the card
   (the ELL kernels) and on the CPU (plain versions), lambda_max carried
   across: equal per-step iteration counts, U, P and the forces within 1e-8;
21. einsum main path: run_karman_fast(winkernel=False) at its defaults (the
   JAX driver's route: Newton, backward Euler, consistent force probe,
   P1Hierarchy with ELL on every level) at lcar=0.02, n_refine=5, 1,905,056
   DoF, float32, one step per chunk: 1 warm-up step and 5 timed steps, then
   one step with its substeps timed. Fails on a non-finite state or force,
   a last drag <= 0, an unconverged solve, no launch of the direct ELL
   kernel, an ELL operator (the pressure operator, each P1Hierarchy level)
   that did not launch the kernel its rule names, and only that one, or any
   window-kernel launch;
22. 3-D einsum path: run_cavity3d_fast(winkernel=False, n=64), 6,714,692
   DoF, float32, tangent_mode CAVITY3D_TANGENT, 1 warm-up and 3 timed steps,
   with its peak memory; fails on a non-finite state, an unconverged solve,
   a pressure operator whose rule does not name the windowed ELL kernel or
   that launched another, or no K1 launch;
23. ELL kernels against plain: the direct kernel (P1) and, wherever the
   segmented window tables exist, the windowed kernel (P2), whichever one
   the rule picks, at every ELL operator of the two einsum drivers and at
   the TPU probes' shapes (131,072 x 8 and 1,048,576 x 8, banded within
   +-64), float32, <= 1e-6 relative, the windowed kernel bitwise equal to
   the direct one, bitwise repeat; the rule's choice and its two byte
   counts; wall times, the plain versions' times, a torch.sparse CSR matvec
   as the yardstick and each kernel's bound from the bytes of the index
   width it reads;
24. packed parity: the packed-patch route (navier_stokes/patchfast.py, the
   benchmark's default Karman path) at KarmanProblem(lcar=0.2, n_refine=2)
   in float64, 3 steps on the card and on the CPU, lambda_max carried
   across: PackedPatchStepper with BiCGStab at tests/test_patchfast.py's
   tight tolerances, and run_karman_fast(backend="packed") at its defaults
   (GMRES, consistent force probe). Equal per-step iteration counts, U
   within 1e-9 of max|U|, the mean-removed P within 1e-7 of max|P|;
25. packed main path: the benchmark's PackedPatchStepper (bench.py:78-103:
   BiCGStab, newton_rtol 1e-2, linear_rtol 1e-1, pressure_rtol 3e-4,
   correction_rtol 1e-4, smoother degree 3, dt0 1e-4) at lcar=0.02,
   n_refine=5, 1,905,056 DoF, float32: setup seconds (problem,
   build_patch_info, PackedPatch, hierarchy), 1 warm-up step and 5 timed
   steps from rest, peak memory, then one step with its substeps timed.
   Fails on a non-finite state, an unconverged pressure or correction
   solve, any hand-kernel launch (none belongs on this path), or if the
   BiCGStab, pressure and correction iterations are not KARMAN_PACKED_ITERS;
26. packed driver: run_karman_fast(backend="packed") at its defaults
   (GMRES) on the same problem, one step per chunk, 1 + 5 steps. Fails on a
   non-finite state or force, a last drag <= 0 or a hand-kernel launch;
27. the packed path's launches from torch.profiler (after its timed phases):
   one step, one momentum apply, one ema_S, one V-cycle;
28. device times (torch.profiler, last, since profiling slows later host
   code) of the ELL kernels at every shape of 23 (with the L2 cache warm,
   and cold: after a 64 MB write), K3 2-D lagged and Newton (L2 warm and
   cold), K4b 2-D, the three 3-D kernels (L2 warm and cold; K4b 3-D also at
   its 2-pass layout), K1 and K2 at every level grid of their paths (L2
   warm and cold, the operator's launch) with cuDNN's convolution at the
   finest, K4a and K5 at NL = 6 and 10 (L2 warm and cold),
   and K4b 2-D and 3-D P2 (L2 warm and cold). Every K4b and K3 2-D row
   also carries host_us: perf_counter over 200 calls enqueued with no
   synchronisation, divided by the count, the least of five such loops;
   the K3 3-D rows the same over 20 calls, the least of three loops.

Then every hand kernel's launches by path (karman_packed: 0 for each), and
K1's and K2's launches by grid on each path, with launches x (device
time - bound) a grid. The line before the last holds the kernel report, the
one before it the card; the last line is {"ok": true, "device": {...}}. Imports neither jax
nor flow_tpu.
"""
import contextlib
import json
import os
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
CAVITY3D_MAIN = 64  # run_cavity3d_fast's n on the 3-D window route
CAVITY3D_DOFS = 6714692  # 3 n_V + n_Q at n=64
CAVITY3D_STEPS = 4  # 1 warm-up + 3 timed
# the 3-D window route's iterations a step at N=64 on the card (H100 80GB
# HBM3) with K3 3-D summing its local results from a device scratch along
# the scatter lists: the cluster walk sums every window row in the same
# order, so the steps, and these counts, must not move
CAVITY3D_ITERS = {"newton_iters": [1, 2, 2, 2], "linear_iters": [9, 20, 26, 34],
                  "pressure_iters": [4, 4, 3, 3], "correction_iters": [20, 20, 20, 20]}
# the Karman window routes' iterations a step at 1.9M DoF on the card (H100
# 80GB HBM3) with K3 2-D summing its local results from a device scratch
# along the scatter lists: the lagged route of phase 8 and run_karman_fast's
# Newton route of phase 10. The cluster walk sums every window row in the
# same order, so the steps, and these counts, must not move
# the box cavity's iterations a step at N=64 (phase 4, 1 + 5 steps) and
# the structured2d solves' CG iterations at 2,049^2 (float32 at rtol 1e-6,
# the float64 reference at 1e-10) on the card (H100 80GB HBM3) with the
# one-thread-a-point stencil kernels: the tiled kernels sum every point in
# the same order, so the steps, and these counts, must not move
BOX_ITERS = {"linear_iters": [4, 4, 6, 10, 11, 11], "pressure_iters": [4, 4, 3, 3, 3, 3],
             "correction_iters": [20, 20, 20, 20, 20, 20]}
STRUCTURED2D_ITERS = {"neumann": [4, 7], "dirichlet": [4, 7]}
KARMAN_LAGGED_ITERS = {"linear_iters": [3, 2, 3, 2, 3, 3],
                       "pressure_iters": [3, 3, 3, 3, 3, 3],
                       "correction_iters": [6, 6, 8, 8, 8, 8]}
KARMAN_NEWTON_ITERS = {"newton_iters": [1, 1, 2, 1, 2, 2],
                       "linear_iters": [6, 4, 10, 5, 10, 12],
                       "pressure_iters": [4, 4, 3, 3, 3, 3],
                       "correction_iters": [8, 8, 10, 10, 10, 10]}
# the packed-patch route (navier_stokes/patchfast.py): the benchmark's
# packed stepper (bench.py:78-103, BENCH_PATCH=packed, BiCGStab momentum)
PACKED_SETTINGS = dict(
    newton_tol=0.0, newton_rtol=1e-2, linear_rtol=1e-1, pressure_rtol=3e-4,
    correction_rtol=1e-4, momentum_solver="bicgstab", mg_smoother_degree=3,
    cfl_target=1.0, dt_max=1.0,
)
# tests/test_patchfast.py:119-123's tight settings, for the parity phase
PACKED_TIGHT = dict(newton_tol=1e-12, newton_rtol=0.0, pressure_rtol=1e-11,
                    correction_rtol=1e-11, momentum_solver="bicgstab",
                    mg_smoother_degree=3)
PACKED_PARITY = dict(lcar=0.2, n_refine=2)
PACKED_STEPS = 6  # 1 warm-up + 5 timed
# the packed main path's iterations a step at 1.9M DoF (1 warm-up + 5 timed
# steps from rest), pinned from the first run of this phase on the card
# (H100 80GB HBM3, 700 W): the path runs no hand kernel, and its scatters
# sum in a fixed order, so the steps, and these counts, must not move
KARMAN_PACKED_ITERS = {"linear_iters": [3, 2, 3, 3, 3, 3],
                       "pressure_iters": [3, 3, 3, 3, 3, 3],
                       "correction_iters": [6, 6, 8, 8, 8, 8]}
# the einsum 3-D route's Newton tangent: "linearize" keeps x's quadrature
# tables for a Newton iteration (the JAX default; JAX needed "jvp" where
# linearize's storage did not fit)
CAVITY3D_TANGENT = "linearize"
EINSUM_PARITY = dict(lcar=0.2, n_refine=2)  # the einsum CUDA-vs-CPU parity mesh
# the TPU probes' ELL shapes (rows, band, entries a row): P1's and P2's
ELL_PROBES = {"probe P1": (131072, 64, 8), "probe P2": (1048576, 64, 8)}
STRUCTURED2D_N = 2048  # unit_square_mesh(2048, "right"): the Poisson solves
STRUCTURED2D_DOFS = 4198401  # P1: 2049^2
FORMWIN_N = 1024  # unit_square_mesh(1024, "right") P2: the formwin2d steps
FORMWIN_DOFS = 4198401  # P2: 2049^2
FORMWIN_STEPS = 6  # 1 warm-up + 5 timed
# formwin2d's BiCGStab iterations a step on the card (H100 80GB HBM3) with
# K4a and K5 summing their local results from a device scratch along the
# scatter lists: the cluster kernels sum every window row in the same
# order, so the steps, and these counts, must not move
FORMWIN_ITERS = [7, 9, 9, 10, 10, 10]
# implicit Euler step and diffusivity of formwin2d: where |b| = 0.5 (h =
# 1/1024) the cell Peclet number |b| h / (2 kappa) is ~1 and the Courant
# number |b| dt / h ~2.6
FORMWIN_DT = 5e-3
FORMWIN_KAPPA = 2.5e-4

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


def host_us(fn, calls=200, loops=5):
    """Host µs per call of fn: perf_counter over `calls` calls enqueued back
    to back with no synchronisation, divided by the count; the least of
    `loops` such loops, since the host's clock spreads more than the
    device's. The device runs behind, so this is what the Python launch
    path costs the host."""
    import torch

    fn()
    best = float("inf")
    for _ in range(loops):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, time.perf_counter() - t0)
    torch.cuda.synchronize()
    return 1e6 * best / calls


def device_ms(fn, reps, kernel=None):
    """Device time per call from torch.profiler's kernel events. With
    `kernel` (one launch of it per call), the mean over the events whose
    name holds it: the profiler drops some events of a long session, so the
    mean is taken over the events it kept, and a session that kept none is
    run again (at most three times)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = prof.events()
        cuda = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                and (kernel is None or kernel in e.name)]
        if kernel is None or cuda:
            break
    check(kernel is None or cuda, f"the profiler shows no event of {kernel}")
    if kernel is not None:
        return sum(e.device_time_total for e in cuda) / len(cuda) / 1e3
    us = (sum(e.device_time_total for e in cuda) if cuda
          else sum(e.self_device_time_total for e in events))
    return us / reps / 1e3


@contextlib.contextmanager
def deterministic():
    """torch's deterministic algorithms for the block: index_add_ on the card
    then sums in a fixed order, so a reference repeats bitwise from run to
    run (cuBLAS needs CUBLAS_WORKSPACE_CONFIG, which main() sets)."""
    import torch

    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


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
    names = ["stencil3d", "stencil2d", "winstiff", "winmom", "winmom3d", "winmass",
             "winform", "ell"]
    _build.build_all(names)
    th.join()
    check("error" not in meshkit, f"meshkit build failed: {meshkit.get('error')}")
    for name in names:
        _build.load(name)
    secs = {n: round(_build.build_seconds.get(n, 0.0), 2) for n in names}
    log(f"[build] kernels and meshkit ready in {time.perf_counter() - t0:.2f} s "
        f"(nvcc seconds {secs}) into {_build.BUILD_DIR}")


# the grids each stencil runs on along the main paths: K1 on the box
# cavity's and the 3-D window route's pressure grid and the next level (the
# 17^3 level is the dense coarse solve), K2 on the structured2d hierarchy's
# levels 2,049^2 down to 129^2 (65^2 is the dense coarse solve)
STENCIL_LEVELS = {3: [(65, 65, 65), (33, 33, 33)],
                  2: [(2049, 2049), (1025, 1025), (513, 513), (257, 257), (129, 129)]}
STENCIL_KERNEL_NAMES = {3: "stencil27_kernel", 2: "stencil9_kernel"}


def _stencil_bound(shape, dim):
    """The stencil's bound in float32: x read and y written once, 2 3^dim
    operations a point."""
    n = int(np.prod(shape))
    return bound_ms(2 * 4 * n + 4 * 3**dim, 2 * 3**dim * n)


def phase_stencil(dim):
    """K1 (dim 3) or K2 (dim 2) against its plain version on the main path's
    grids (every multigrid level) and ragged ones, in float64 and float32;
    the launch of an operator (ops/stencil.StencilLaunch, fixed at
    construction) bitwise equal to the public wrapper's at every level
    grid, and the host µs a call of both; the cuDNN
    convolution of the same stencil as the yardstick at the finest grid.
    Returns the report of the finest grid in float32, the per-level rows,
    and the calls whose device times are taken last (L2 warm and cold at
    every level grid; the convolution)."""
    import torch
    import torch.nn.functional as F
    from flow_tpu_torch.ops import stencil

    if dim == 3:
        ragged = [(17, 17, 17), (9, 9, 9), (5, 5, 5), (5, 6, 7), (2, 7, 9), (1, 4, 3),
                  (3, 1, 70), (1, 1, 1)]
        apply, plain, conv, tag = (stencil.stencil_apply_3d, stencil.stencil_apply_3d_plain,
                                   F.conv3d, "stencil")
        tols = {torch.float64: 1e-13, torch.float32: 1e-5}
    else:
        ragged = [(65, 65), (1, 257), (257, 1), (7, 13), (2, 3), (3, 2), (1, 1)]
        apply, plain, conv, tag = (stencil.stencil_apply_2d, stencil.stencil_apply_2d_plain,
                                   F.conv2d, "stencil2d")
        tols = {torch.float64: 1e-12, torch.float32: 1e-5}
    levels = STENCIL_LEVELS[dim]
    rng = np.random.default_rng(0)
    report, rows, jobs = {}, {}, {}
    for dtype, tol in tols.items():
        for shape in levels + ragged:
            x = torch.as_tensor(rng.standard_normal(shape), dtype=dtype, device="cuda")
            k = torch.as_tensor(rng.standard_normal((3,) * dim), dtype=dtype,
                                device="cuda")
            y = apply(x, k)
            y_plain = plain(x, k)
            torch.cuda.synchronize()
            abs_err = float((y - y_plain).abs().max())
            rel_err = abs_err / max(float(y_plain.abs().max()), 1e-300)
            check(torch.equal(apply(x, k), y), f"{tag} {shape} {dtype}: calls differ")
            reps = 200 if x.numel() > 1000 else 50
            ms = cuda_time_ms(lambda: apply(x, k), reps)
            plain_ms = cuda_time_ms(lambda: plain(x, k), reps)
            log(f"[{tag}] {str(dtype):13s} {str(shape):15s} max_abs_err={abs_err:.3e} "
                f"rel_err={rel_err:.3e} kernel_ms={ms:.5f} plain_ms={plain_ms:.5f}")
            check(rel_err <= tol, f"{tag} {shape} {dtype}: rel err {rel_err} > {tol}")
            report[(dtype, shape)] = (abs_err, ms, plain_ms)
            if dtype != torch.float32 or shape not in levels:
                continue
            # the operator's launch, as StructuredLaplacian makes it
            launch = stencil.StencilLaunch(k, shape)
            xf = x.reshape(-1)
            check(torch.equal(launch(xf).reshape(shape), y),
                  f"{tag} {shape}: StencilLaunch differs from stencil_apply")
            b_ms, b_by = _stencil_bound(shape, dim)
            rows[shape] = dict(wall_ms=cuda_time_ms(lambda: launch(xf), reps),
                               host_us=host_us(lambda: launch(xf)),
                               host_us_checked=host_us(lambda: apply(x, k)),
                               bound_ms=b_ms, plan=launch.plan)
            kname = STENCIL_KERNEL_NAMES[dim]
            jobs[shape] = {
                "warm": (lambda launch=launch, xf=xf: launch(xf), kname),
                # after a 64 MB write, more than the 50 MB L2
                "cold": (lambda launch=launch, xf=xf: (_l2_flush().zero_(), launch(xf)),
                         kname)}
            log(f"[{tag}] {shape} f32 lean launch {launch.plan}: wall_ms="
                f"{rows[shape]['wall_ms']:.5f} host_us={rows[shape]['host_us']:.3f} "
                f"(checked wrapper {rows[shape]['host_us_checked']:.3f}) "
                f"bound_ms={b_ms:.6f} ({b_by})")
    # the yardstick: a cuDNN convolution of the same stencil (TF32 is off)
    x = torch.as_tensor(rng.standard_normal(levels[0]), dtype=torch.float32, device="cuda")
    k = torch.as_tensor(rng.standard_normal((3,) * dim), dtype=torch.float32, device="cuda")
    lib_ms = cuda_time_ms(lambda: conv(x[None, None], k[None, None], padding=1), 200)
    jobs["conv"] = (lambda: conv(x[None, None], k[None, None], padding=1), None)
    b_ms, b_by = _stencil_bound(levels[0], dim)
    abs_err, ms, plain_ms = report[(torch.float32, levels[0])]
    log(f"[{tag}] {levels[0]} f32 conv{dim}d_ms={lib_ms:.5f} bound_ms={b_ms:.6f} ({b_by})")
    return dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms,
                host_us=rows[levels[0]]["host_us"]), rows, jobs


def _stencil_device_times(tag, row, rows, jobs):
    """Device ms a call (profiler) at every level grid, L2 warm and cold,
    into `rows`, the finest grid's into `row`, and cuDNN's convolution at
    the finest grid; one line a kernel."""
    for shape, pair in jobs.items():
        if shape == "conv":
            row["library_device_ms"] = device_ms(pair[0], 100)
            continue
        for temp, (job, kname) in pair.items():
            rows[shape]["device_ms" if temp == "warm" else "device_cold_ms"] = \
                device_ms(job, 100, kernel=kname)
    finest = next(iter(rows))
    row["device_ms"] = rows[finest]["device_ms"]
    row["device_cold_ms"] = rows[finest]["device_cold_ms"]
    log(f"[profile] {tag} device ms a call, L2 warm / cold (lean wall; host us lean / "
        f"checked; bound): "
        + ", ".join(f"{s}={r['device_ms']:.5f}/{r['device_cold_ms']:.5f} "
                    f"({r['wall_ms']:.5f}; {r['host_us']:.3f}/{r['host_us_checked']:.3f}; "
                    f"{r['bound_ms']:.6f})" for s, r in rows.items())
        + f"; cuDNN conv device ms at {finest}: {row['library_device_ms']:.5f}")


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
    from flow_tpu_torch.ops.stencil import GRID_LAUNCHES, STENCIL_3D

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
    GRID_LAUNCHES.clear()
    Uf, Pf, dt, tel_w = st.run(Uf, Pf, DT0, n_steps=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Uf, Pf, dt, tel = st.run(Uf, Pf, dt, n_steps=5)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = STENCIL_3D.launches
    by_grid = dict(GRID_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    tel_all = {k: tel_w[k].tolist() + tel[k].tolist() for k in tel}
    log(f"[cavity] steps/s={5 / elapsed:.4f} (5 steps in {elapsed:.3f} s, "
        f"after 1 warm-up step)")
    for k in ("dt", "linear_iters", "pressure_iters", "correction_iters"):
        log(f"[cavity] {k}: {tel_all[k]}")
    log(f"[cavity] peak_mem_bytes={peak} stencil_launches={launches} by grid {by_grid}")
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
    check(sum(by_grid.values()) == launches, "cavity: launches by grid do not add up")
    for key, want in BOX_ITERS.items():
        check(tel_all[key] == want, f"cavity: {key} {tel_all[key]} are not BOX_ITERS' {want}")
    return launches, by_grid


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


def _stiffness_elements(op):
    """The element matrices [nb, C, NL, NL] of a window stiffness operator."""
    import torch

    NL = op.lidx.shape[1]
    K = op.kref.view(-1, NL, NL)
    return torch.einsum("bkc,kij->bcij", op.Cg, K) * op.valid[:, :, None, None]


def _stiffness_csr(op):
    """The window stiffness operator assembled on the padded permuted dofs."""
    return _element_csr(op, _stiffness_elements(op))


def _momentum_csr(op, Tq, scal, Uq=None, Gu=None):
    """The window momentum operator (with Uq/Gu the Newton tangent)
    assembled on the padded permuted dofs of every component (row
    m*n_pad + dof): element matrices from the plain local apply on unit
    inputs."""
    import torch
    from flow_tpu_torch.attic.winmom import momentum_local_plain

    wl = op.wl
    nb, NL, C = op.lidx.shape
    DIM = op.dim
    dev = op.lidx.device
    g = (torch.arange(nb, device=dev) * wl.S)[:, None, None] + op.lidx  # [b, i, c]
    rows, cols, vals = [], [], []
    for n in range(DIM):
        for j in range(NL):
            U = torch.zeros((DIM, nb, NL, C), dtype=torch.float32, device=dev)
            U[n, :, j, :] = 1.0
            loc = momentum_local_plain(U, op.valid, op.detj, op.G4, op.Cg4, Tq,
                                       op.tabs, scal, Uq, Gu)  # [m, b, i, c]
            for m in range(DIM):
                rows.append((m * wl.n_pad + g).reshape(-1).long())
                cols.append((n * wl.n_pad + g[:, j:j + 1, :]).expand(nb, NL, C)
                            .reshape(-1).long())
                vals.append(loc[m].reshape(-1))
            del U, loc
    return _csr(torch.cat(rows), torch.cat(cols), torch.cat(vals), DIM * wl.n_pad)


def _winstiff_work(op):
    """Bytes and operations of one window stiffness apply: the inputs the
    function needs (x, lidx, valid, Cg, Kref) read once and the output
    windows written once, not the scatter lists that only this kernel's
    design reads; the per-cell arithmetic on the real cells, plus the
    scatter sums."""
    wl = op.wl
    nb, NL, C = op.lidx.shape
    d2 = op.Cg.shape[1]
    cells = int(op.valid.sum())
    nbytes = 4 * (wl.n_pad + nb * NL * C + nb * C + d2 * nb * C + d2 * NL * NL
                  + nb * wl.W)
    ops = cells * (NL * (d2 * (2 * NL + 2)) + NL) + cells * NL
    return nbytes, ops


def _winmom_work(op, newton=False):
    """Bytes and operations of one window momentum apply: the inputs the
    function needs read once and the output windows written once, not the
    scatter lists or the scratch that only the kernels' design reads; the
    per-cell arithmetic of csrc/winmom.cu (DIM=2, NL=6, NQ=7) or
    csrc/winmom3d.cu (DIM=3, NL=10, NQ=27) on the real cells, plus the
    scatter sums. Newton mode adds the gradient table Gu and the reaction
    term; its state table Uq is Tq, counted once."""
    wl = op.wl
    nb, NL, C = op.lidx.shape
    DIM, NQ = op.dim, op.nq
    cells = int(op.valid.sum())
    nbytes = 4 * (DIM * wl.n_pad + nb * NL * C + 2 * nb * C + 2 * DIM * DIM * nb * C
                  + DIM * NQ * nb * C + op.tabs.numel() + 3 + DIM * nb * wl.W
                  + (DIM * DIM * NQ * nb * C if newton else 0))
    if DIM == 3:
        return nbytes, cells * _winmom3d_ops_per_cell(newton)
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


def _winmom3d_ops_per_cell(newton):
    """Flops per cell of csrc/winmom3d.cu (DIM=3, NL=10, NQ=27), term by
    term as the kernel computes them."""
    DIM, NL, NQ, D2 = 3, 10, 27, 9
    mass = NL * DIM * (2 * NL + 2)
    stress = NL * (D2 * NL * 2 + DIM * (2 * NL + 2))
    coupling = 1 + D2 * (NL * DIM * 2 + DIM + NL * (2 * NL + 2 * DIM))
    # per point: weight, direction values, T.grad phi_i, then per component
    # T.grad v_m, the two weights and the NL updates
    per_q = 2 + DIM * 2 * NL + DIM * 2 * DIM + NL * 2 * DIM + DIM * (2 * NL + 4 + 4 * NL)
    if newton:
        # v.grad phi_i, then per component (v.grad x)_m, two weights, updates
        per_q += DIM * 2 * DIM + NL * 2 * DIM + DIM * (2 * DIM + 4 + 4 * NL)
    return mass + stress + coupling + NQ * per_q + DIM * NL + DIM * NL


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


def _winmom_launch(op, newton):
    """K3's cluster launch at the layout of the momentum operator `op`
    (csrc/wincluster.cuh): its plan, the passes over the window blocks'
    compressed rows and the rows, as a log fragment and a dict."""
    from flow_tpu_torch.attic import winkernel, winmom

    nb, NL, C = op.lidx.shape
    if op.dim == 2:
        kernel = winmom.WINMOM_NEWTON if newton else winmom.WINMOM
    else:
        kernel = winmom.WINMOM3D_NEWTON if newton else winmom.WINMOM3D
    plan = winkernel.cluster_launch(kernel, nb, C, NL, "cuda")
    rows = op.positions[1]
    info = dict(cluster=plan.cl, threads=plan.threads, staged_per_block=plan.cap,
                passes=_cluster_passes(op, plan), clusters=plan.clusters,
                max_active_clusters=plan.resident, compressed_rows=rows.shape[1],
                listed_rows=int((rows < op.wl.W).sum()))
    return " ".join(f"{k}={v}" for k, v in info.items()), info


def phase_window_kernels(st, hier):
    """K4b and K3 lagged against their plain versions on small ragged
    layouts and at the Karman main path's layouts, with the CSR yardsticks.
    Returns the report of the main layouts and, to time their device times
    later, a call of each kernel there."""
    import torch
    from flow_tpu_torch.attic import winkernel, winmom
    from flow_tpu_torch.models.karman import KarmanProblem

    rng = np.random.default_rng(1)
    report, jobs = {}, {}

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
        h_us = host_us(lambda: op.windows(x))
        plain_ms = cuda_time_ms(lambda: winkernel.stiffness_windows_plain(
            x, op.lidx, op.valid, op.Cg, op.kref, op.wl.S, op.wl.W), 10)
        A = _stiffness_csr(op)
        _, csr_err = _rel((A @ x)[:op.wl.n], op.wl.overlap_add(op.windows(x)))
        check(csr_err <= 1e-5, f"winstiff {name}: the CSR yardstick differs ({csr_err})")
        lib_ms = cuda_time_ms(lambda: A @ x, 100)
        nbytes, nops = _winstiff_work(op)
        b_ms, b_by = bound_ms(nbytes, nops)
        log(f"[window] winstiff {name}: n={op.wl.n} max_abs_err={abs_err:.3e} "
            f"rel_err={rel_err:.3e} kernel_ms={ms:.5f} host_us={h_us:.3f} "
            f"plain_ms={plain_ms:.5f} "
            f"csr_ms={lib_ms:.5f} (nnz {A.values().numel()}) bytes={nbytes} ops={nops} "
            f"bound_ms={b_ms:.6f} ({b_by})")
        if "winstiff" not in report:
            report["winstiff"] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                                      bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                                      host_us=h_us)
            jobs["winstiff"] = (lambda op=op, x=x: op.windows(x))
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
    h_us = host_us(lambda: op.windows(xp, Tq, *w))
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
    launch, info = _winmom_launch(op, newton=False)
    log(f"[window] winmom main: n={op.wl.n} nb={op.wl.nb} S={op.wl.S} W={op.wl.W} "
        f"C={op.wl.C} {launch} kernel_ms={ms:.5f} host_us={h_us:.3f} "
        f"plain_ms={plain_ms:.5f} "
        f"csr_ms={lib_ms:.5f} (nnz {A.values().numel()}) bytes={nbytes} ops={nops} "
        f"bound_ms={b_ms:.6f} ({b_by})")
    check(info["clusters"] <= info["max_active_clusters"],
          "winmom: the card does not hold the launch's clusters at once")
    report["winmom"] = dict(max_abs_err=err_main, ms=ms, plain_ms=plain_ms,
                            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, host_us=h_us,
                            cluster=info["cluster"], threads=info["threads"])
    jobs["winmom"] = {"warm": lambda: op.windows(xp, Tq, *w),
                      "cold": lambda: (_l2_flush().zero_(), op.windows(xp, Tq, *w))}
    del A
    torch.cuda.empty_cache()
    return report, jobs


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
        def wrapper(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            times[name] = 1e3 * (time.perf_counter() - t0)
            return out
        return wrapper

    # the correction substep: the window route's or the packed stepper's,
    # or NSContext's on the einsum route
    owner, name = ((st, "_correction") if getattr(st, "winkernel", True)
                   else (st.ctx, "velocity_correction"))
    st._pressure_solve = timed("pressure", st._pressure_solve)
    setattr(owner, name, timed("correction", getattr(owner, name)))
    try:
        timed("step", st._step_impl)(U, P, dt)
    finally:
        del st._pressure_solve
        delattr(owner, name)
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
    for key, want in KARMAN_LAGGED_ITERS.items():
        check(tel_all[key] == want,
              f"karman: {key} {tel_all[key]} are not KARMAN_LAGGED_ITERS' {want}")
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
    for key, want in KARMAN_NEWTON_ITERS.items():
        check(tel[key].tolist() == want,
              f"newton: {key} {tel[key].tolist()} are not KARMAN_NEWTON_ITERS' {want}")
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
    h_us = host_us(kernel)
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
    launch, info = _winmom_launch(op, newton=True)
    log(f"[window] winmom newton main: n={op.wl.n} nb={op.wl.nb} C={op.wl.C} {launch} "
        f"max_abs_err={abs_err:.3e} rel_err={rel_err:.3e} kernel_ms={ms:.5f} "
        f"host_us={h_us:.3f} plain_ms={plain_ms:.5f} csr_ms={lib_ms:.5f} "
        f"(nnz {nnz}) bytes={nbytes} ops={nops} bound_ms={b_ms:.6f} ({b_by})")
    check(info["clusters"] <= info["max_active_clusters"],
          "winmom newton: the card does not hold the launch's clusters at once")
    return dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms, host_us=h_us, cluster=info["cluster"],
                threads=info["threads"]), {
                    "warm": kernel, "cold": lambda: (_l2_flush().zero_(), kernel())}


def phase_cavity3d_parity():
    import torch
    from flow_tpu_torch.models.cavity3d import run_cavity3d_fast

    runs = {}
    lmax = None
    for device in ("cpu", "cuda"):
        out = run_cavity3d_fast(num_steps=3, n=4, winkernel=True, device=device,
                                dtype=torch.float64, lmax=lmax)
        lmax = [L.lmax for L in out["stepper"].pressure_precond.__self__.levels]
        _check_solves(out["telemetry"], f"cavity3d-parity ({device})")
        runs[device] = (out["U"].cpu(), out["P"].cpu(), out["telemetry"])
    (U_c, P_c, tel_c), (U_g, P_g, tel_g) = runs["cpu"], runs["cuda"]
    for key in ("newton_iters", "linear_iters", "pressure_iters", "correction_iters"):
        a, b = tel_g[key].tolist(), tel_c[key].tolist()
        log(f"[cavity3d-parity] {key}: cuda={a} cpu={b}")
        check(a == b, f"cavity3d parity: {key} differ (cuda {a}, cpu {b})")
    du = float((U_g - U_c).abs().max())
    dp = float((P_g - P_c).abs().max())
    pmax = float(P_c.abs().max())
    log(f"[cavity3d-parity] max|dU|={du:.3e} (max|U| {float(U_c.abs().max()):.3e}) "
        f"max|dP|={dp:.3e} (max|P| {pmax:.3e})")
    check(du <= 2e-6, f"cavity3d parity: U differs by {du}")
    check(dp <= 1e-4 * pmax, f"cavity3d parity: P differs by {dp}")


def phase_cavity3d_main():
    """run_cavity3d_fast on the 3-D window route at N=64, one step per
    chunk: the first chunk is the warm-up, the next three are timed (each
    chunk ends in a device->host copy of its telemetry)."""
    import torch
    from flow_tpu_torch.attic.winkernel import WINSTIFF3D
    from flow_tpu_torch.attic.winmom import WINMOM3D, WINMOM3D_NEWTON
    from flow_tpu_torch.models.cavity3d import run_cavity3d_fast
    from flow_tpu_torch.ops.stencil import GRID_LAUNCHES, STENCIL_3D

    torch.cuda.reset_peak_memory_stats()
    kernels = {"winmom3d": WINMOM3D, "winmom3d_newton": WINMOM3D_NEWTON,
               "winstiff3d": WINSTIFF3D, "stencil3d": STENCIL_3D}
    for k in kernels.values():
        k.launches = 0
    GRID_LAUNCHES.clear()
    out = run_cavity3d_fast(num_steps=CAVITY3D_STEPS, n=CAVITY3D_MAIN, winkernel=True,
                            chunk_size=1, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in kernels.items()}
    launches["stencil3d by grid"] = dict(GRID_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    prob, st, tel = out["problem"], out["stepper"], out["telemetry"]
    n_dofs = 3 * prob.V.n_dofs + prob.Q.n_dofs
    timed = sum(out["chunk_seconds"][1:])
    n_timed = CAVITY3D_STEPS - 1
    setup, layouts = out["setup_seconds"], out["layout_seconds"]
    log(f"[cavity3d] run_cavity3d_fast n={CAVITY3D_MAIN} n_dofs={n_dofs} float32 "
        f"winkernel=True convection={'lagged' if st.lagged else 'newton'} "
        f"theta={st.theta}")
    for name, wl in (("V", st.winmom.wl), ("Q", st.K_Q.wl)):
        log(f"[cavity3d] {name} layout: n={wl.n} nb={wl.nb} S={wl.S} W={wl.W} C={wl.C}")
    log(f"[cavity3d] setup {setup:.1f} s (window layouts, tables and scatter lists "
        f"{layouts:.1f} s, the rest {setup - layouts:.1f} s)")
    log(f"[cavity3d] steps/s={n_timed / timed:.4f} ({n_timed} steps in {timed:.3f} s, "
        f"after 1 warm-up step of {out['chunk_seconds'][0]:.3f} s)")
    for k in ("dt", "newton_iters", "linear_iters", "pressure_iters", "correction_iters",
              "momentum_converged", "pressure_converged", "correction_converged"):
        log(f"[cavity3d] {k}: {tel[k].tolist()}")
    log(f"[cavity3d] peak_mem_bytes={peak} launches={launches} (per step: "
        + ", ".join(f"{k} {launches[k] / CAVITY3D_STEPS:.1f}" for k in kernels) + ")")
    check(n_dofs == CAVITY3D_DOFS, f"cavity3d: unexpected n_dofs {n_dofs}")
    check(not st.lagged and st.theta == (0.0, 1.0), "cavity3d: not the driver's defaults")
    U, P = out["U"], out["P"]
    check(tuple(U.shape) == (prob.V.n_dofs, 3) and tuple(P.shape) == (prob.Q.n_dofs,),
          "cavity3d: state of the wrong shape")
    check(bool(torch.isfinite(U).all()) and bool(torch.isfinite(P).all()),
          "cavity3d: non-finite state")
    _check_solves(tel, "cavity3d")
    check(bool((tel["newton_iters"] >= 1).all() and (tel["linear_iters"] >= 1).all()),
          "cavity3d: a step without a Newton iteration")
    # every BiCGStab iteration is two K3 3-D Newton launches; the correction
    # CG one K3 3-D lagged launch per iteration plus one for its right-hand
    # side; every pressure CG iteration one K4b 3-D launch and V-cycle
    check(launches["winmom3d_newton"] == 2 * int(tel["linear_iters"].sum()),
          "cavity3d: K3 3-D Newton launches do not match the BiCGStab iterations")
    check(launches["winmom3d"] == int(tel["correction_iters"].sum()) + CAVITY3D_STEPS,
          "cavity3d: K3 3-D lagged launches do not match the correction iterations")
    check(launches["winstiff3d"] == int(tel["pressure_iters"].sum()),
          "cavity3d: K4b 3-D launches do not match the pressure iterations")
    check(launches["stencil3d"] > 0, "cavity3d: the stencil kernel was never launched")
    check(sum(launches["stencil3d by grid"].values()) == launches["stencil3d"],
          "cavity3d: stencil launches by grid do not add up")
    for key, want in CAVITY3D_ITERS.items():
        check(tel[key].tolist() == want,
              f"cavity3d: {key} {tel[key].tolist()} are not CAVITY3D_ITERS' {want}")
    umax = float(U.abs().max())
    check(abs(umax - 1.0) < 1e-6, f"cavity3d: max |u| {umax} is not the lid speed")
    times = _timed_step(st, U, P, st._scalar(out["dt"]))
    log("[cavity3d] substeps ms (one synchronised step): "
        + ", ".join(f"{k}={v:.2f}" for k, v in times.items()))
    return out, launches


# the window stride of a K4b 3-D layout of the main path's mesh whose local
# results exceed one cluster's shared memory
WINSTIFF3D_CHUNKED_S = 16384


def _cluster_passes(op, plan):
    """Passes of a cluster kernel's launch `plan` (winkernel.ClusterLaunch)
    over the layout of `op`: the walk's rule (whole rows, at most plan.cl *
    plan.cap staged values a pass, csrc/wincluster.cuh) on the host over
    every window block's rowptr; the most of any block."""
    room = plan.cl * plan.cap
    most = 0
    for rp in op.positions[0].cpu().numpy():
        passes, r0 = 0, 0
        while r0 < len(rp) - 1:
            e0 = rp[r0]
            r0 = (len(rp) - 1 if rp[-1] - e0 <= room
                  else int(np.searchsorted(rp, e0 + room, side="right")) - 1)
            passes += 1
        most = max(most, passes)
    return most


def _winstiff3d_report(kq, rng):
    """K4b 3-D at the pressure layout of the 3-D main path: against its
    plain version (<= 1e-5 relative), bitwise repeat, wall time, the plain
    version's time, the CSR yardstick of the same assembled operator, the
    bound; the chosen cluster launch, its plan and how many such clusters
    the card holds at once (cudaOccupancyMaxActiveClusters); and a layout
    of stride WINSTIFF3D_CHUNKED_S on the same mesh, which runs in more
    than one pass, against its plain version. Returns the report and its device-time jobs
    {tag: call}."""
    import torch
    from flow_tpu_torch.attic import winkernel

    def inputs(op):
        x = torch.zeros(op.wl.n_pad, device="cuda")
        x[:op.wl.n] = torch.as_tensor(rng.standard_normal(op.wl.n), dtype=torch.float32)
        return x

    def plain_of(op, x):
        return lambda: winkernel.stiffness_windows_plain(x, op.lidx, op.valid, op.Cg,
                                                         op.kref, op.wl.S, op.wl.W)

    x = inputs(kq)
    nb, NL, C = kq.lidx.shape

    def kernel_q():
        return kq.windows(x)

    plain_q = plain_of(kq, x)
    abs_err, rel_err = _check_kernel("winstiff3d pressure", kernel_q, plain_q)
    ms = cuda_time_ms(kernel_q, 100)
    h_us = host_us(kernel_q)
    plain_ms = cuda_time_ms(plain_q, 10)
    A = _stiffness_csr(kq)
    _, csr_err = _rel((A @ x)[:kq.wl.n], kq.wl.overlap_add(kernel_q()))
    check(csr_err <= 1e-5, f"winstiff3d: the CSR yardstick differs ({csr_err})")
    lib_ms = cuda_time_ms(lambda: A @ x, 100)
    nnz = A.values().numel()
    del A
    nbytes, nops = _winstiff_work(kq)
    b_ms, b_by = bound_ms(nbytes, nops)
    plan = winkernel.cluster_launch(winkernel.WINSTIFF3D, nb, C, NL, "cuda")
    chosen = (plan.cl, plan.threads)
    log(f"[window3d] winstiff3d pressure: n={kq.wl.n} nb={nb} S={kq.wl.S} W={kq.wl.W} "
        f"C={C} cluster={plan.cl} threads={plan.threads} staged_per_block={plan.cap} "
        f"passes={_cluster_passes(kq, plan)} clusters={plan.clusters} "
        f"max_active_clusters={plan.resident} max_abs_err={abs_err:.3e} "
        f"rel_err={rel_err:.3e} kernel_ms={ms:.5f} host_us={h_us:.3f} "
        f"plain_ms={plain_ms:.5f} csr_ms={lib_ms:.5f} (N=64, nnz {nnz}) bytes={nbytes} "
        f"ops={nops} "
        f"bound_ms={b_ms:.6f} ({b_by})")
    row = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, library_ms=lib_ms, cluster=chosen[0], threads=chosen[1],
               host_us=h_us)
    jobs = {"warm": kernel_q, "cold": lambda: (_l2_flush().zero_(), kernel_q())}
    big = winkernel.WindowStiffnessOperator(kq.space, S=WINSTIFF3D_CHUNKED_S)
    xb = inputs(big)
    nbb, _, Cb = big.lidx.shape
    passes_b = _cluster_passes(big, winkernel.cluster_launch(winkernel.WINSTIFF3D, nbb, Cb,
                                                              NL, "cuda"))
    check(passes_b > 1, f"winstiff3d: the S={big.wl.S} layout fits one pass")
    abs_b, rel_b = _check_kernel("winstiff3d chunked", lambda: big.windows(xb),
                                 plain_of(big, xb))
    ms_b = cuda_time_ms(lambda: big.windows(xb), 20)
    log(f"[window3d] winstiff3d chunked layout: S={big.wl.S} nb={nbb} W={big.wl.W} "
        f"C={Cb} passes={passes_b} max_abs_err={abs_b:.3e} rel_err={rel_b:.3e} "
        f"kernel_ms={ms_b:.5f}")
    jobs["chunked"] = lambda: big.windows(xb)
    return row, jobs


def phase_window3d_kernels(st, U):
    """K3 3-D lagged and Newton and K4b 3-D at the 3-D main path's layouts,
    with the tables of its final state; K3's cluster launch and host µs a
    call, and the overlap-add of its velocity windows; the CSR yardsticks
    of K4b at N=64 and of K3 at N=32."""
    import torch
    from flow_tpu_torch.attic import winkernel, winmom
    from flow_tpu_torch.models.cavity3d import Cavity3DProblem

    rng = np.random.default_rng(3)
    report, jobs = {}, {}
    op = st.winmom
    xp = torch.zeros((3, op.wl.n_pad), device="cuda")
    xp[:, :op.wl.n] = torch.as_tensor(rng.standard_normal((3, op.wl.n)),
                                      dtype=torch.float32)
    # the weights of a momentum matvec at dt = 1e-3
    s = 1e-3 / st.rho
    w = (1.0, s * st.rho, s * st.mu)
    scal = op._scal(*w)
    Tq, Uq, Gu = op.state_qp(U)
    for name, extra in (("winmom3d", ()), ("winmom3d_newton", (Uq, Gu))):
        def kernel(extra=extra):
            return op.windows(xp, Tq, *w, *extra)

        def plain(extra=extra):
            return winmom.momentum_windows_plain(xp, op.lidx, op.valid, op.detj, op.G4,
                                                 op.Cg4, Tq, op.tabs, scal, op.wl.S,
                                                 op.wl.W, *extra)

        abs_err, rel_err = _check_kernel(f"{name} main", kernel, plain)
        # at dt = 1e-3 the mass term dominates; weights of order one hold
        # the convection, stress and reaction terms to the same tolerance
        strong = (1.0, 0.37, 0.021)
        _, rel_strong = _check_kernel(
            f"{name} strong", lambda extra=extra: op.windows(xp, Tq, *strong, *extra),
            lambda extra=extra: winmom.momentum_windows_plain(
                xp, op.lidx, op.valid, op.detj, op.G4, op.Cg4, Tq, op.tabs,
                op._scal(*strong), op.wl.S, op.wl.W, *extra))
        log(f"[window3d] {name} with weights {strong}: rel_err={rel_strong:.3e}")
        if not extra:
            _check_kernel(f"{name} mass", lambda: op.windows(xp, Tq, 1.0, 0.0, 0.0),
                          lambda: winmom.momentum_windows_plain(
                              xp, op.lidx, op.valid, op.detj, op.G4, op.Cg4, Tq,
                              op.tabs, op._scal(1.0, 0.0, 0.0), op.wl.S, op.wl.W))
        ms = cuda_time_ms(kernel, 20)
        h_us = host_us(kernel, calls=20, loops=3)
        plain_ms = cuda_time_ms(plain, 3)
        nbytes, nops = _winmom_work(op, newton=bool(extra))
        b_ms, b_by = bound_ms(nbytes, nops)
        launch, info = _winmom_launch(op, newton=bool(extra))
        log(f"[window3d] {name} main: n={op.wl.n} nb={op.wl.nb} S={op.wl.S} W={op.wl.W} "
            f"C={op.wl.C} {launch} max_abs_err={abs_err:.3e} "
            f"rel_err={rel_err:.3e} kernel_ms={ms:.5f} host_us={h_us:.3f} "
            f"plain_ms={plain_ms:.5f} bytes={nbytes} ops={nops} "
            f"bound_ms={b_ms:.6f} ({b_by})")
        report[name] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                            bound_by=b_by, host_us=h_us, cluster=info["cluster"],
                            threads=info["threads"])
        jobs[name] = {"warm": kernel, "cold": lambda kernel=kernel: (_l2_flush().zero_(),
                                                                     kernel())}
    # the overlap-add of the velocity windows, which every K3 apply on the
    # route is followed by: what the kernel's time can bring to the step
    # is bounded by it
    y = op.windows(xp, Tq, *w)
    oa_ms = cuda_time_ms(lambda: op.wl.overlap_add(y), 20)
    log(f"[window3d] overlap_add of the velocity windows [3, {op.wl.nb}, {op.wl.W}]: "
        f"ms={oa_ms:.5f}")
    for name in ("winmom3d", "winmom3d_newton"):
        report[name]["overlap_add_ms"] = oa_ms
    del y
    del Uq, Gu
    torch.cuda.empty_cache()

    report["winstiff3d"], jobs["winstiff3d"] = _winstiff3d_report(st.K_Q, rng)

    # K3's CSR yardstick at N=32, where its assembly fits: the kernel and
    # the CSR matvec of the same assembled operator on the same input
    small = Cavity3DProblem(n=32, mu=st.mu, dtype=torch.float32, device="cuda")
    op32 = winmom.WindowLaggedMomentum(small.V)
    U32 = torch.as_tensor(0.1 * rng.standard_normal((small.V.n_dofs, 3)),
                          dtype=torch.float32, device="cuda")
    Tq32, Uq32, Gu32 = op32.state_qp(U32)
    xp32 = torch.zeros((3, op32.wl.n_pad), device="cuda")
    xp32[:, :op32.wl.n] = torch.as_tensor(rng.standard_normal((3, op32.wl.n)),
                                          dtype=torch.float32)
    xf = xp32.reshape(-1)
    for name, extra in (("winmom3d", ()), ("winmom3d_newton", (Uq32, Gu32))):
        A = _momentum_csr(op32, Tq32, op32._scal(*w), *extra)
        y = op32.windows(xp32, Tq32, *w, *extra)
        y_csr = (A @ xf).view(3, op32.wl.n_pad)[:, :op32.wl.n]
        _, csr_err = _rel(y_csr, op32.wl.overlap_add(y))
        check(csr_err <= 1e-5, f"{name}: the N=32 CSR yardstick differs ({csr_err})")
        lib_ms = cuda_time_ms(lambda: A @ xf, 50)
        ms32 = cuda_time_ms(lambda: op32.windows(xp32, Tq32, *w, *extra), 50)
        log(f"[window3d] {name} at N=32 (n={op32.wl.n} nb={op32.wl.nb} C={op32.wl.C}): "
            f"kernel_ms={ms32:.5f} csr_ms={lib_ms:.5f} (nnz {A.values().numel()}) "
            f"csr rel_err={csr_err:.3e}")
        report[name]["library_ms"] = lib_ms
        report[name]["kernel_ms_n32"] = ms32
        del A
        torch.cuda.empty_cache()
    return report, jobs

def _poisson2d(mesh, bc, rtol, lmax=None, dtype=None):
    """MG-preconditioned CG on the P1 Poisson problem of
    tests/test_structured_mg.py: pure Neumann with the constant nullspace,
    or Dirichlet on the whole boundary, with a StructuredHierarchy V-cycle
    (K2 on every level, the finest level's operator as the matrix), in
    `dtype` (default: the mesh's). Returns the hierarchy, the operator, b
    and solve() -> (x, the solve info, the synchronised solve ms)."""
    import torch
    from flow_tpu_torch import interop
    from flow_tpu_torch.fem.spaces import FunctionSpace
    from flow_tpu_torch.solvers import krylov
    from flow_tpu_torch.solvers.structured_mg import StructuredHierarchy

    Q = FunctionSpace(mesh, 1)
    mask = None
    if bc == "dirichlet":
        mask = np.zeros(Q.n_dofs)
        mask[Q.boundary_dofs()] = 1.0
    hier = StructuredHierarchy(mesh, bc_mask=mask, dtype=dtype)
    if lmax is not None:
        interop.load_hierarchy_lmax(hier, lmax)
    K = hier.levels[-1].K
    b = torch.as_tensor(np.random.default_rng(0).standard_normal(Q.n_dofs),
                        dtype=hier.dtype, device=mesh.device)
    nullspace = None
    if mask is None:
        b = b - b.mean()
        nullspace = [torch.ones_like(b)]
    else:
        b = b * (1.0 - hier.levels[-1].mask)

    def solve():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, info = krylov.cg(K, b, M=hier.v_cycle, rtol=rtol, maxiter=200,
                            nullspace=nullspace)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize()
        return x, info, 1e3 * (time.perf_counter() - t0)

    return hier, K, b, solve


def phase_structured2d_parity():
    """The 2-D structured Poisson solves of unit_square_mesh(32) in float64
    on the card (K2) and on the CPU (plain stencil), lambda_max carried
    across: equal CG iterations, solutions within 1e-10."""
    import torch
    from flow_tpu_torch.mesh import unit_square_mesh

    for bc in ("neumann", "dirichlet"):
        runs, lmax = {}, None
        for device in ("cpu", "cuda"):
            mesh = unit_square_mesh(32, "right", dtype=torch.float64, device=device)
            hier, _, _, solve = _poisson2d(mesh, bc, 1e-10, lmax)
            lmax = [L.lmax for L in hier.levels]
            x, info, _ = solve()
            check(bool(info.converged), f"structured2d parity ({device}, {bc}): no convergence")
            runs[device] = (x.cpu(), info.iters)
        dx = float((runs["cuda"][0] - runs["cpu"][0]).abs().max())
        log(f"[structured2d-parity] {bc}: iterations cuda={runs['cuda'][1]} "
            f"cpu={runs['cpu'][1]} max|dx|={dx:.3e} "
            f"(max|x| {float(runs['cpu'][0].abs().max()):.3e})")
        check(runs["cuda"][1] == runs["cpu"][1],
              f"structured2d parity ({bc}): iterations differ")
        check(dx <= 1e-10, f"structured2d parity ({bc}): x differs by {dx}")


def phase_structured2d_main():
    """unit_square_mesh(2048, 'right'), P1, 4,198,401 DoF, float32: the pure
    Neumann and the Dirichlet Poisson solves with the StructuredHierarchy
    V-cycle, rtol 1e-6. Each solve runs once as a warm-up; the counts are
    set to 0 before the second and read after it. The solution is held
    against a float64 solve (rtol 1e-10) of the same problem on the card,
    and its true residual is computed in float64 (the float32 rounding of
    x alone puts it near 1e-4)."""
    import torch
    from flow_tpu_torch.mesh import unit_square_mesh
    from flow_tpu_torch.ops.stencil import GRID_LAUNCHES, STENCIL_2D

    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    mesh = unit_square_mesh(STRUCTURED2D_N, "right", dtype=torch.float32, device="cuda")
    log(f"[structured2d] unit_square_mesh({STRUCTURED2D_N}) n_points={mesh.n_points} "
        f"mesh {time.perf_counter() - t0:.1f} s")
    check(mesh.n_points == STRUCTURED2D_DOFS, f"structured2d: n_dofs {mesh.n_points}")
    launches, by_grid = 0, {}
    for bc in ("neumann", "dirichlet"):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        hier, K, b, solve = _poisson2d(mesh, bc, 1e-6)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        solve()
        STENCIL_2D.launches = 0
        GRID_LAUNCHES.clear()
        x, info, ms = solve()
        n_launch = STENCIL_2D.launches
        launches += n_launch
        grids = dict(GRID_LAUNCHES)
        for g, c in grids.items():
            by_grid[g] = by_grid.get(g, 0) + c
        peak = torch.cuda.max_memory_allocated() - base
        # the float64 solve of the same problem, and the true residual of
        # the float32 solution in float64
        hier64, K64, b64, solve64 = _poisson2d(mesh, bc, 1e-10, dtype=torch.float64)
        x64, info64, _ = solve64()
        x32 = x.double()
        if bc == "neumann":
            x32, x64 = x32 - x32.mean(), x64 - x64.mean()
        err = float((x32 - x64).norm() / x64.norm())
        res = float((b64 - K64(x.double())).norm() / b64.norm())
        log(f"[structured2d] {bc}: levels {[L.grid[0] for L in hier.levels]} setup "
            f"{setup:.1f} s; CG iterations {info.iters} solve_ms={ms:.3f} "
            f"stencil2d_launches={n_launch} (by grid {grids}) peak_mem_bytes={peak} (above the "
            f"{base} allocated before the phase); against the float64 solve "
            f"({info64.iters} iterations): rel err {err:.3e}, true rel residual "
            f"{res:.3e}")
        check(bool(info.converged) and bool(info64.converged),
              f"structured2d ({bc}): CG did not converge")
        check(bool(torch.isfinite(x).all()), f"structured2d ({bc}): non-finite solution")
        check(n_launch > 0, f"structured2d ({bc}): the 2-D stencil kernel was never launched")
        check(sum(grids.values()) == n_launch,
              f"structured2d ({bc}): launches by grid do not add up")
        check([info.iters, info64.iters] == STRUCTURED2D_ITERS[bc],
              f"structured2d ({bc}): CG iterations {[info.iters, info64.iters]} are not "
              f"STRUCTURED2D_ITERS' {STRUCTURED2D_ITERS[bc]}")
        # measured on the H100: err 1.8e-5 / 1.1e-5, residual 9.4e-5 / 3.2e-5
        # (Neumann / Dirichlet)
        check(err <= 1e-4, f"structured2d ({bc}): {err} from the float64 solution")
        check(res <= 3e-4, f"structured2d ({bc}): true residual {res}")
        del hier, K, b, x, hier64, K64, b64, x64, x32
    torch.cuda.empty_cache()
    return launches, by_grid


def _bump(points):
    """The initial state of the formwin2d phase: a Gaussian bump at (0.5,
    0.75) of width 0.05."""
    r2 = (points[:, 0] - 0.5) ** 2 + (points[:, 1] - 0.75) ** 2
    return np.exp(-r2 / (2 * 0.05 ** 2))


def _rotating(x):
    """The transport field of the formwin2d phase: a solid-body rotation
    about (0.5, 0.5), |b| <= 0.71 on the unit square."""
    import torch

    return torch.stack([-(x[..., 1] - 0.5), x[..., 0] - 0.5], dim=-1)


def _formwin_steps(U, n_steps, apply_K, apply_M, free, mask, jac):
    """Implicit Euler steps (M + dt(kappa K + C)) u^{n+1} = M u^n with
    homogeneous Dirichlet rows (heat.py's masking), Jacobi-BiCGStab from the
    previous state, rtol 1e-5."""
    import torch
    from flow_tpu_torch.solvers import krylov

    iters, converged = [], True
    for _ in range(n_steps):
        U, info = krylov.bicgstab(lambda x: free * apply_K(x) + mask * x,
                                  free * apply_M(U), x0=U, M=lambda r: r / jac,
                                  rtol=1e-5, maxiter=500)
        iters.append(info.iters)
        converged &= bool(info.converged)
    torch.cuda.synchronize()
    return U, iters, converged


def _window_work(op, table_floats, ops_per_cell):
    """Bytes and operations of one window apply of K4a or K5: x, lidx, valid
    and the kernel's tables (`table_floats` floats) read once and the
    output windows written once (not the row pointers and list positions
    that only the kernels' design reads); `ops_per_cell` on the real
    cells, plus the row sums."""
    wl = op.wl
    nb, NL, C = op.lidx.shape
    cells = int(op.valid.sum())
    nbytes = 4 * (wl.n_pad + nb * NL * C + nb * C + table_floats + nb * wl.W)
    return nbytes, cells * (ops_per_cell + NL)


def _element_csr(op, Ae):
    """The assembled operator of element matrices Ae [nb, C, NL, NL] (masked
    cells zero) on the padded permuted dofs of op's window layout."""
    import torch

    wl = op.wl
    nb, NL, C = op.lidx.shape
    g = (torch.arange(nb, device=op.lidx.device) * wl.S)[:, None, None] \
        + op.lidx.permute(0, 2, 1)  # [b, c, i]
    rows = g[:, :, :, None].expand(nb, C, NL, NL).reshape(-1).long()
    cols = g[:, :, None, :].expand(nb, C, NL, NL).reshape(-1).long()
    return _csr(rows, cols, Ae.reshape(-1), wl.n_pad)


def _window_kernel_report(name, op, kernel, plain, Ae, nbytes, nops, reps=50,
                          counter=None, host=False):
    """Kernel against plain (<= 1e-5 relative, bitwise repeat), its wall
    time, the plain version's, the CSR matvec of the same assembled
    operator (checked against the kernel's apply) and the bound. With the
    `counter` of a cluster kernel (K4a, K5, K4b P2) also its launch: blocks
    a cluster, threads, staged entries a block, passes, clusters launched
    and the clusters the card holds at once, which must cover the launch
    (one wave); with `host`, the host µs per call (host_us). Returns the
    report and the device-time jobs (L2 warm, cold)."""
    import torch
    from flow_tpu_torch.attic import winkernel

    x = torch.zeros(op.wl.n_pad, device="cuda")
    x[:op.wl.n] = torch.as_tensor(np.random.default_rng(4).standard_normal(op.wl.n),
                                  dtype=torch.float32)
    abs_err, rel_err = _check_kernel(name, lambda: kernel(x), lambda: plain(x))
    ms = cuda_time_ms(lambda: kernel(x), reps)
    plain_ms = cuda_time_ms(lambda: plain(x), 5)
    h_us = host_us(lambda: kernel(x)) if host else None
    A = _element_csr(op, Ae)
    _, csr_err = _rel((A @ x)[:op.wl.n], op.wl.overlap_add(kernel(x)))
    check(csr_err <= 1e-5, f"{name}: the CSR yardstick differs ({csr_err})")
    lib_ms = cuda_time_ms(lambda: A @ x, reps)
    nnz = A.values().numel()
    del A
    b_ms, b_by = bound_ms(nbytes, nops)
    wl = op.wl
    nb, NL, C = op.lidx.shape
    row = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, library_ms=lib_ms)
    launch = "" if h_us is None else f" host_us={h_us:.3f}"
    if host:
        row["host_us"] = h_us
    if counter is not None:
        plan = winkernel.cluster_launch(counter, nb, C, NL, "cuda")
        row.update(plan._asdict(), passes=_cluster_passes(op, plan))
        launch += (f" cluster={plan.cl} threads={plan.threads} staged_per_block={plan.cap} "
                  f"passes={row['passes']} clusters={plan.clusters} "
                  f"max_active_clusters={plan.resident} window_blocks_per_cluster<="
                  f"{-(-nb // plan.clusters)}")
        check(0 < plan.clusters <= plan.resident,
              f"{name}: {plan.clusters} clusters launched, the card holds "
              f"{plan.resident} at once")
    log(f"[{name}] n={wl.n} nb={wl.nb} S={wl.S} W={wl.W} C={wl.C} NL={NL}{launch} "
        f"max_abs_err={abs_err:.3e} rel_err={rel_err:.3e} kernel_ms={ms:.5f} "
        f"plain_ms={plain_ms:.5f} csr_ms={lib_ms:.5f} (nnz {nnz}) bytes={nbytes} "
        f"ops={nops} bound_ms={b_ms:.6f} ({b_by})")
    return row, {"warm": lambda: kernel(x), "cold": lambda: (_l2_flush().zero_(), kernel(x))}


def _mass_report(name, M):
    from flow_tpu_torch.attic import winkernel

    nb, NL, C = M.lidx.shape
    Ae = (M.detj * M.valid)[:, :, None, None] * M.mref
    nbytes, nops = _window_work(M, nb * C + NL * NL, 2 * NL * NL + 2 * NL + 1)
    return _window_kernel_report(
        name, M, M.windows,
        lambda x: winkernel.mass_windows_plain(x, M.lidx, M.valid, M.detj, M.mref,
                                               M.wl.S, M.wl.W), Ae, nbytes, nops,
        counter=winkernel.WINMASS)


def _element_report(name, K):
    from flow_tpu_torch.attic import winform

    nb, NL, C = K.lidx.shape
    Ae = K.aloc.view(nb, NL, NL, C).permute(0, 3, 1, 2) * K.valid[:, :, None, None]
    nbytes, nops = _window_work(K, nb * NL * NL * C, 2 * NL * NL + NL)
    return _window_kernel_report(
        name, K, K.windows,
        lambda x: winform.element_windows_plain(x, K.lidx, K.valid, K.aloc, K.wl.S,
                                                K.wl.W), Ae, nbytes, nops,
        counter=winform.WINFORM)


def _stiffness_report(name, op, counter):
    """K4b P2 (a cluster kernel, `counter` its count) at op's layout: the
    report of _window_kernel_report with the cluster launch and host_us."""
    from flow_tpu_torch.attic import winkernel

    return _window_kernel_report(
        name, op, op.windows,
        lambda x: winkernel.stiffness_windows_plain(x, op.lidx, op.valid, op.Cg, op.kref,
                                                    op.wl.S, op.wl.W),
        _stiffness_elements(op), *_winstiff_work(op), counter=counter, host=True)


def phase_formwin2d():
    """unit_square_mesh(1024, 'right'), P2, 4,198,401 DoF, float32: implicit
    Euler for u_t + b.grad u = kappa lap u, the operator compiled by
    formlang and applied by K5 (window_operator), the right-hand side M u
    by K4a (WindowMassOperator), Jacobi from S.assemble_diag(). 1 + 5
    steps with the counts set to 0 before and read after; the same steps
    with CompiledForm.apply and assembly.mass_apply as the reference, under
    torch's deterministic algorithms (their index_add_ then sums in a fixed
    order, as the kernels do); then K4a and K5 against their plain versions
    at this layout."""
    import torch
    from flow_tpu_torch.attic import winform, winkernel
    from flow_tpu_torch.fem import assembly, formlang as fl
    from flow_tpu_torch.fem.bc import DirichletBC, combine_bcs
    from flow_tpu_torch.fem.spaces import FunctionSpace
    from flow_tpu_torch.mesh import unit_square_mesh

    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    mesh = unit_square_mesh(FORMWIN_N, "right", dtype=torch.float32, device="cuda")
    V = FunctionSpace(mesh, 2)
    check(V.n_dofs == FORMWIN_DOFS, f"formwin2d: n_dofs {V.n_dofs}")
    geom = assembly.geometry(mesh)
    u, v = fl.TrialFunction(V), fl.TestFunction(V)
    b = fl.Coefficient(_rotating, vector=True)
    S = fl.compile_form(u * v + FORMWIN_DT * (FORMWIN_KAPPA * fl.dot(fl.grad(u), fl.grad(v))
                                              + fl.dot(b, fl.grad(u)) * v), geom, 3)
    mask = torch.as_tensor(combine_bcs(V, [DirichletBC(V, 0.0)])[0], dtype=torch.float32,
                           device="cuda")
    free = 1.0 - mask
    with deterministic():
        jac = free * S.assemble_diag() + mask
    K = winform.window_operator(S)
    M = winkernel.WindowMassOperator(V)
    U0 = torch.as_tensor(_bump(V.dof_points_np), dtype=torch.float32, device="cuda") * free
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    layouts = K.layout_seconds + M.layout_seconds
    h = 1.0 / FORMWIN_N
    log(f"[formwin2d] unit_square_mesh({FORMWIN_N}) P2 n_dofs={V.n_dofs} "
        f"cells={mesh.n_cells} dt={FORMWIN_DT} kappa={FORMWIN_KAPPA} cell Peclet "
        f"|b| h / (2 kappa) = {0.5 * h / (2 * FORMWIN_KAPPA):.3f} at |b| = 0.5; setup "
        f"{setup:.1f} s (the two window layouts and scatter lists {layouts:.1f} s, the "
        f"rest {setup - layouts:.1f} s)")
    for name, op in (("K5", K), ("K4a", M)):
        wl = op.wl
        log(f"[formwin2d] {name} layout: n={wl.n} nb={wl.nb} S={wl.S} W={wl.W} C={wl.C}")

    torch.cuda.reset_peak_memory_stats()
    winkernel.WINMASS.launches = winform.WINFORM.launches = 0
    U, iters_w, conv_w = _formwin_steps(U0, 1, K.apply, M.apply, free, mask, jac)
    t0 = time.perf_counter()
    U, iters, conv = _formwin_steps(U, FORMWIN_STEPS - 1, K.apply, M.apply, free, mask, jac)
    elapsed = time.perf_counter() - t0
    launches = {"winmass": winkernel.WINMASS.launches, "winform": winform.WINFORM.launches}
    peak = torch.cuda.max_memory_allocated() - base
    iters = iters_w + iters
    n_timed = FORMWIN_STEPS - 1
    log(f"[formwin2d] steps/s={n_timed / elapsed:.4f} ({n_timed} steps in {elapsed:.3f} s "
        f"after 1 warm-up step) BiCGStab iterations {iters} peak_mem_bytes={peak} (of "
        f"the steps, above the {base} allocated before the phase) launches={launches}")
    check(conv_w and conv, "formwin2d: a BiCGStab solve did not converge")
    check(launches["winmass"] == FORMWIN_STEPS,
          "formwin2d: K4a launches do not match the steps")
    check(launches["winform"] == sum(2 * i + 1 for i in iters),
          "formwin2d: K5 launches do not match the BiCGStab iterations")
    check(iters == FORMWIN_ITERS,
          f"formwin2d: BiCGStab iterations {iters}, not the sum-order-preserving "
          f"{FORMWIN_ITERS}")
    check(tuple(U.shape) == (V.n_dofs,) and bool(torch.isfinite(U).all()),
          "formwin2d: state of the wrong shape or not finite")
    umax, u0max = float(U.abs().max()), float(U0.abs().max())
    check(0.0 < umax <= u0max * (1 + 1e-3), f"formwin2d: max |u| {umax} (initial {u0max})")

    # the reference: the compiled form's einsum apply and the assembled mass,
    # run twice to show that it repeats bitwise
    dg = assembly.geometry_on(mesh, torch.float32, mesh.device)
    with deterministic():
        runs = [_formwin_steps(U0, FORMWIN_STEPS, S.apply,
                               lambda x: assembly.mass_apply(V, dg, x), free, mask, jac)
                for _ in range(2)]
    (U_ref, iters_ref, conv_ref), (U_rep, iters_rep, _) = runs
    _, rel = _rel(U, U_ref)
    log(f"[formwin2d] reference (CompiledForm.apply + mass_apply, deterministic "
        f"algorithms): iterations {iters_ref}, repeat {iters_rep}, bitwise equal "
        f"{bool(torch.equal(U_rep, U_ref))}; state rel diff {rel:.3e}")
    check(conv_ref, "formwin2d reference: a BiCGStab solve did not converge")
    check(iters_rep == iters_ref and torch.equal(U_rep, U_ref),
          "formwin2d reference: its repeat differs under deterministic algorithms")
    check(all(abs(a - b) <= 1 for a, b in zip(iters, iters_ref)),
          "formwin2d: iterations differ from the reference's by more than one in a step")
    check(rel <= 1e-4, f"formwin2d: the state differs from the reference by {rel}")
    del U_ref, U_rep, runs, dg

    k4a, k4a_jobs = _mass_report("formwin2d winmass", M)
    k5, k5_jobs = _element_report("formwin2d winform", K)
    k4a["launches"], k5["launches"] = launches["winmass"], launches["winform"]
    torch.cuda.empty_cache()
    return k4a, k5, {"winmass": k4a_jobs, "winform": k5_jobs}


def _p2_poisson(V, kernel_counter):
    """Jacobi-CG on the Dirichlet P2 Poisson problem K u = M 1 with the
    window stiffness operator (K4b P2, float32 inside) as the matrix, rtol
    1e-6, on the mesh's dtype (float64: over the ~1,000 iterations at
    n=256, float32 vectors let the recursive residual drift from the true
    one). The solution is held against the same solve with the einsum
    stiffness apply in float64, within 1e-3: a float32 operator limits the
    attainable accuracy to ~eps32 x the condition number (2.4e-4 at n=256
    on the CPU's plain version); a residual check cannot tell, since the
    float32 rounding of K x alone is ~1e-3 of |b| here. Returns the
    operator and the launches."""
    import torch
    from flow_tpu_torch.attic import winkernel
    from flow_tpu_torch.fem import assembly
    from flow_tpu_torch.fem.bc import DirichletBC, combine_bcs
    from flow_tpu_torch.solvers import krylov

    mesh = V.mesh
    op = winkernel.WindowStiffnessOperator(V)
    dtype = mesh.dtype
    mask = torch.as_tensor(combine_bcs(V, [DirichletBC(V, 0.0)])[0], dtype=dtype,
                           device="cuda")
    free = 1.0 - mask
    geom = assembly.geometry(mesh)
    diag = torch.as_tensor(assembly.stiffness_diag(V, geom), dtype=dtype, device="cuda")
    jac = free * diag + mask
    dg = assembly.geometry_on(mesh, dtype, mesh.device)
    rhs = free * assembly.mass_apply(V, dg, torch.ones(V.n_dofs, dtype=dtype, device="cuda"))
    kernel_counter.launches = 0
    x, info = krylov.cg(lambda y: free * op.apply(free * y) + mask * y, rhs,
                        M=lambda r: r / jac, rtol=1e-6, maxiter=3000)
    torch.cuda.synchronize()
    launches = kernel_counter.launches
    x_ref, info_ref = krylov.cg(
        lambda y: free * assembly.stiffness_apply(V, dg, free * y) + mask * y, rhs,
        M=lambda r: r / jac, rtol=1e-8, maxiter=5000)
    err = float((x - x_ref).norm() / x_ref.norm())
    log(f"[k4b-p2] {V.dim}-D P2 Poisson n={V.n_dofs} layout nb={op.wl.nb} S={op.wl.S} "
        f"W={op.wl.W} C={op.wl.C}: CG iterations {info.iters} launches {launches}; "
        f"against the einsum-operator solve ({info_ref.iters} iterations) rel err "
        f"{err:.3e}")
    check(bool(info.converged) and bool(info_ref.converged),
          f"k4b-p2 ({V.dim}-D): CG did not converge")
    check(launches == info.iters, f"k4b-p2 ({V.dim}-D): launches do not match iterations")
    check(err <= 1e-3, f"k4b-p2 ({V.dim}-D): {err} from the einsum-operator solution")
    return op, launches


def phase_window_p2():
    """K4b P2 on its paths (Dirichlet P2 Poisson on unit_square_mesh(256)
    triangles and box_mesh N=32 tets), each operator against its plain
    version at its layout with its cluster launch and host µs per call,
    then K4a and K5 at NL=10 on the N=32 P2 tet layout against theirs, and
    at NL=3 and 4 on the P1 layouts of the same meshes. Returns the 2-D and
    3-D K4b reports and device-time jobs (L2 warm, cold), and the NL=10 K4a
    and K5 reports and jobs."""
    import torch
    from flow_tpu_torch.attic import winform, winkernel
    from flow_tpu_torch.fem import assembly, formlang as fl
    from flow_tpu_torch.fem.spaces import FunctionSpace
    from flow_tpu_torch.mesh import unit_square_mesh
    from flow_tpu_torch.mesh3d import box_mesh

    V2 = FunctionSpace(unit_square_mesh(256, "right", dtype=torch.float64, device="cuda"), 2)
    V3 = FunctionSpace(box_mesh((0, 0, 0), (1, 1, 1), 32, 32, 32, dtype=torch.float64,
                                device="cuda"), 2)
    op2, l2 = _p2_poisson(V2, winkernel.WINSTIFF_P2)
    op3, l3 = _p2_poisson(V3, winkernel.WINSTIFF3D_P2)
    k4b2, k4b2_job = _stiffness_report("k4b-p2 tri n=256", op2, winkernel.WINSTIFF_P2)
    k4b3, k4b3_job = _stiffness_report("k4b-p2 tets N=32", op3, winkernel.WINSTIFF3D_P2)
    k4b2["launches"], k4b3["launches"] = l2, l3

    u, v = fl.TrialFunction(V3), fl.TestFunction(V3)
    b = fl.Coefficient(lambda x: x - 0.5, vector=True)
    S = fl.compile_form(u * v + 1e-3 * (1e-2 * fl.dot(fl.grad(u), fl.grad(v))
                                        + fl.dot(b, fl.grad(u)) * v),
                        assembly.geometry(V3.mesh), 3)
    k4a10 = _mass_report("tets N=32 winmass", winkernel.WindowMassOperator(V3))
    k5_10 = _element_report("tets N=32 winform", winform.window_operator(S))
    for V in (V2, V3):
        V1 = FunctionSpace(V.mesh, 1)
        u, v = fl.TrialFunction(V1), fl.TestFunction(V1)
        S1 = fl.compile_form(u * v + 1e-3 * fl.dot(fl.grad(u), fl.grad(v)),
                             assembly.geometry(V1.mesh), 2)
        M1, K1 = winkernel.WindowMassOperator(V1), winform.window_operator(S1)
        x = torch.zeros(M1.wl.n_pad, device="cuda")
        x[:M1.wl.n] = torch.as_tensor(np.random.default_rng(6).standard_normal(M1.wl.n),
                                      dtype=torch.float32)
        errs = [_check_kernel(f"{tag} P1 {V.dim}-D", lambda op=op: op.windows(x),
                              lambda plain=plain: plain(x))[1] for tag, op, plain in (
            ("winmass", M1, lambda y: winkernel.mass_windows_plain(
                y, M1.lidx, M1.valid, M1.detj, M1.mref, M1.wl.S, M1.wl.W)),
            ("winform", K1, lambda y: winform.element_windows_plain(
                y, K1.lidx, K1.valid, K1.aloc, K1.wl.S, K1.wl.W)))]
        log(f"[k4a-k5 P1] {V.dim}-D NL={M1.lidx.shape[1]} nb={M1.wl.nb} C={M1.wl.C}: "
            f"winmass rel_err={errs[0]:.3e} winform rel_err={errs[1]:.3e}")
    torch.cuda.empty_cache()
    return (k4b2, k4b2_job), (k4b3, k4b3_job), (k4a10, k5_10)



def phase_window_bigblock():
    """K4b 2-D P1 and K3 2-D lagged and Newton on layouts whose blocks hold
    more cells than one block's shared memory could (unit_square_mesh(128),
    S=16,384: C=32,318 P1 and 8,158 P2 cells), against their plain
    versions: K4b's local results live in a device scratch, K3's in the
    shared memory of a cluster of blocks."""
    import torch
    from flow_tpu_torch.attic import winkernel, winmom
    from flow_tpu_torch.fem.spaces import FunctionSpace, VectorFunctionSpace
    from flow_tpu_torch.mesh import unit_square_mesh

    rng = np.random.default_rng(4)
    mesh = unit_square_mesh(128, "right", dtype=torch.float32, device="cuda")
    op = winkernel.WindowStiffnessOperator(FunctionSpace(mesh, 1), S=16384)
    check(op.wl.C * 3 * 4 > 232448, "bigblock: the K4b block fits shared memory")
    x = torch.zeros(op.wl.n_pad, device="cuda")
    x[:op.wl.n] = torch.as_tensor(rng.standard_normal(op.wl.n), dtype=torch.float32)
    err = _check_kernel("winstiff big block", lambda: op.windows(x),
                        lambda: winkernel.stiffness_windows_plain(
                            x, op.lidx, op.valid, op.Cg, op.kref, op.wl.S, op.wl.W))
    mo = winmom.WindowLaggedMomentum(VectorFunctionSpace(mesh, 2), S=16384)
    check(mo.wl.C * 12 * 4 > 232448, "bigblock: the K3 block fits shared memory")
    T = torch.as_tensor(rng.standard_normal((mo.wl.n, 2)), dtype=torch.float32,
                        device="cuda")
    Tq, Uq, Gu = mo.state_qp(T)
    xp = torch.zeros((2, mo.wl.n_pad), device="cuda")
    xp[:, :mo.wl.n] = torch.as_tensor(rng.standard_normal((2, mo.wl.n)),
                                      dtype=torch.float32)
    w = (1.0, 0.37, 0.021)
    errs = []
    for extra in ((), (Uq, Gu)):
        errs.append(_check_kernel(
            "winmom big block", lambda: mo.windows(xp, Tq, *w, *extra),
            lambda: winmom.momentum_windows_plain(
                xp, mo.lidx, mo.valid, mo.detj, mo.G4, mo.Cg4, Tq, mo.tabs,
                mo._scal(*w), mo.wl.S, mo.wl.W, *extra)))
    log(f"[bigblock] winstiff P1 2-D nb={op.wl.nb} C={op.wl.C} rel_err={err[1]:.3e}; "
        f"winmom 2-D nb={mo.wl.nb} C={mo.wl.C} {_winmom_launch(mo, newton=False)[0]} "
        f"lagged rel_err={errs[0][1]:.3e} newton rel_err={errs[1][1]:.3e}")


def phase_einsum_parity():
    """run_karman_fast on the einsum route (its defaults: Newton, backward
    Euler, consistent probe, P1Hierarchy with ELL on every level) at
    KarmanProblem(lcar=0.2, n_refine=2) in float64, 3 steps on the card (the
    ELL kernels) and on the CPU (their plain versions), lambda_max carried
    across: equal per-step iteration counts, U, P and the forces within
    1e-8 (absolute; of max|F| for the forces)."""
    import torch
    from flow_tpu_torch.models.karman import run_karman_fast

    runs, lmax = {}, None
    for device in ("cpu", "cuda"):
        out = run_karman_fast(num_steps=3, winkernel=False, device=device,
                              dtype=torch.float64, lmax=lmax, **EINSUM_PARITY)
        lmax = [L.lmax for L in out["stepper"].pressure_precond.__self__.levels]
        _check_solves(out["telemetry"], f"einsum-parity ({device})")
        runs[device] = (out["u"].cpu(), out["p"].cpu(), out["telemetry"])
    (U_c, P_c, tel_c), (U_g, P_g, tel_g) = runs["cpu"], runs["cuda"]
    for key in ("newton_iters", "linear_iters", "pressure_iters", "correction_iters"):
        a, b = tel_g[key].tolist(), tel_c[key].tolist()
        log(f"[einsum-parity] {key}: cuda={a} cpu={b}")
        check(a == b, f"einsum parity: {key} differ (cuda {a}, cpu {b})")
    du = float((U_g - U_c).abs().max())
    dp = float((P_g - P_c).abs().max())
    F_c, F_g = tel_c["forces"], tel_g["forces"]
    df = float(np.abs(F_g - F_c).max() / np.abs(F_c).max())
    log(f"[einsum-parity] max|dU|={du:.3e} (max|U| {float(U_c.abs().max()):.3e}) "
        f"max|dP|={dp:.3e} (max|P| {float(P_c.abs().max()):.3e}) forces rel {df:.3e}")
    check(du <= 1e-8 and dp <= 1e-8 and df <= 1e-8,
          f"einsum parity: U, P or the forces differ by more than 1e-8 "
          f"({du}, {dp}, {df})")


def _ell_counters():
    from flow_tpu_torch.fem import ell

    return {"ell_direct": ell.ELL_DIRECT, "ell_window": ell.ELL_WINDOW}


def phase_einsum_main():
    """run_karman_fast at its defaults on the einsum route (the JAX
    driver's) at 1.9M DoF, one step per chunk: the first chunk is the
    warm-up, the next five are timed. Each ELL operator (the pressure
    operator, every P1Hierarchy level) launches the kernel its rule names
    (fem/ell.py): the direct one on every level but the two coarsest."""
    import torch
    from flow_tpu_torch.attic.winkernel import WINSTIFF
    from flow_tpu_torch.attic.winmom import WINMOM, WINMOM_NEWTON
    from flow_tpu_torch.models.karman import run_karman_fast

    counters = {**_ell_counters(), "winmom": WINMOM, "winmom_newton": WINMOM_NEWTON,
                "winstiff": WINSTIFF}
    torch.cuda.reset_peak_memory_stats()
    for k in counters.values():
        k.launches = 0
    t0 = time.perf_counter()
    out = run_karman_fast(num_steps=6, chunk_size=1, winkernel=False,
                          dtype=torch.float32, device="cuda", **KARMAN_MAIN)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = {name: k.launches for name, k in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    prob, st, tel = out["problem"], out["stepper"], out["telemetry"]
    hier = st.pressure_precond.__self__
    timed = sum(out["chunk_seconds"][1:])
    setup = total - sum(out["chunk_seconds"])
    log(f"[einsum] run_karman_fast {KARMAN_MAIN} n_dofs={prob.n_dofs} float32 "
        f"winkernel=False convection={'lagged' if st.lagged else 'newton'} "
        f"theta={st.theta} tangent_mode={st.tangent_mode}")
    ells = {"pressure operator": st.K_Q, **{f"level n={L.n}": L.ell for L in hier.levels}}
    log("[einsum] ELL operators (the rule's kernel, this run's launches): "
        + ", ".join(f"{k} n={A.n} K={A.width} {A.kernel} {A.launches}"
                    for k, A in ells.items()))
    log(f"[einsum] steps/s={5 / timed:.4f} (5 steps in {timed:.3f} s, after 1 warm-up "
        f"step of {out['chunk_seconds'][0]:.3f} s; setup {setup:.1f} s)")
    for k in ("dt", "newton_iters", "linear_iters", "pressure_iters", "correction_iters"):
        log(f"[einsum] {k}: {tel[k].tolist()}")
    log(f"[einsum] drag: {tel['forces'][:, 0].tolist()}")
    log(f"[einsum] lift: {tel['forces'][:, 1].tolist()}")
    log(f"[einsum] peak_mem_bytes={peak} launches={launches} (per step: "
        + ", ".join(f"{k} {v / 6:.1f}" for k, v in launches.items()) + ")")
    check(prob.n_dofs == KARMAN_DOFS, f"einsum: unexpected n_dofs {prob.n_dofs}")
    check(not st.winkernel and not st.lagged and st.theta == (0.0, 1.0),
          "einsum: not the driver's defaults")
    U, P = out["u"], out["p"]
    check(tuple(U.shape) == (prob.V.n_dofs, 2) and tuple(P.shape) == (prob.Q.n_dofs,),
          "einsum: state of the wrong shape")
    check(bool(torch.isfinite(U).all()) and bool(torch.isfinite(P).all()),
          "einsum: non-finite state")
    check(np.isfinite(tel["forces"]).all(), "einsum: non-finite forces")
    check(tel["forces"][-1, 0] > 0, "einsum: the last step's drag is not positive")
    _check_solves(tel, "einsum")
    check(bool((tel["newton_iters"] >= 1).all() and (tel["linear_iters"] >= 1).all()),
          "einsum: a step without a Newton iteration")
    check(launches["ell_direct"] > 0, "einsum: the direct ELL kernel was never launched")
    for k, A in ells.items():
        other = "direct" if A.kernel == "window" else "window"
        check(A.launches[A.kernel] > 0 and A.launches[other] == 0,
              f"einsum: the {k} launched {A.launches}, not its rule's {A.kernel} kernel")
    check(launches["winmom"] == launches["winmom_newton"] == launches["winstiff"] == 0,
          "einsum: a window kernel was launched on the einsum route")
    umax = float(U.abs().max())
    check(0.0099 <= umax <= 0.1, f"einsum: max |u| {umax} out of range")
    times = _timed_step(st, U, P, st._scalar(out["dt"]))
    log("[einsum] substeps ms (one synchronised step): "
        + ", ".join(f"{k}={v:.2f}" for k, v in times.items()))
    return out, launches


def phase_cavity3d_einsum():
    """run_cavity3d_fast on the einsum route at N=64 (the JAX driver's
    route), one step per chunk: 1 warm-up and 3 timed steps. The pressure
    operator is the ELL stiffness of 274,625 rows, the V-cycle K1's; the
    tangent is kept per Newton iteration (tangent_mode "linearize"), and the
    peak memory says whether that fits."""
    import torch
    from flow_tpu_torch.models.cavity3d import run_cavity3d_fast
    from flow_tpu_torch.ops.stencil import GRID_LAUNCHES, STENCIL_3D

    counters = {**_ell_counters(), "stencil3d": STENCIL_3D}
    torch.cuda.reset_peak_memory_stats()
    for k in counters.values():
        k.launches = 0
    GRID_LAUNCHES.clear()
    out = run_cavity3d_fast(num_steps=CAVITY3D_STEPS, n=CAVITY3D_MAIN, winkernel=False,
                            tangent_mode=CAVITY3D_TANGENT, chunk_size=1,
                            dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in counters.items()}
    launches["stencil3d by grid"] = dict(GRID_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    prob, st, tel = out["problem"], out["stepper"], out["telemetry"]
    n_dofs = 3 * prob.V.n_dofs + prob.Q.n_dofs
    timed = sum(out["chunk_seconds"][1:])
    n_timed = CAVITY3D_STEPS - 1
    log(f"[cavity3d-einsum] run_cavity3d_fast n={CAVITY3D_MAIN} n_dofs={n_dofs} float32 "
        f"winkernel=False tangent_mode={st.tangent_mode} pressure operator "
        f"n={st.K_Q.n} K={st.K_Q.width} staged_max={st.K_Q.staged_max} "
        f"kernel={st.K_Q.kernel} launches={st.K_Q.launches}")
    log(f"[cavity3d-einsum] setup {out['setup_seconds']:.1f} s; steps/s="
        f"{n_timed / timed:.4f} ({n_timed} steps in {timed:.3f} s, after 1 warm-up step "
        f"of {out['chunk_seconds'][0]:.3f} s)")
    for k in ("dt", "newton_iters", "linear_iters", "pressure_iters", "correction_iters"):
        log(f"[cavity3d-einsum] {k}: {tel[k].tolist()}")
    log(f"[cavity3d-einsum] peak_mem_bytes={peak} launches={launches}")
    check(n_dofs == CAVITY3D_DOFS, f"cavity3d-einsum: unexpected n_dofs {n_dofs}")
    U, P = out["U"], out["P"]
    check(bool(torch.isfinite(U).all()) and bool(torch.isfinite(P).all()),
          "cavity3d-einsum: non-finite state")
    _check_solves(tel, "cavity3d-einsum")
    check(st.K_Q.kernel == "window" and launches["ell_window"] > 0
          and launches["ell_direct"] == 0,
          f"cavity3d-einsum: the pressure operator's rule is {st.K_Q.kernel}, launches "
          f"{launches}: not the windowed kernel alone")
    check(launches["stencil3d"] > 0, "cavity3d-einsum: the stencil kernel was never launched")
    umax = float(U.abs().max())
    check(abs(umax - 1.0) < 1e-6, f"cavity3d-einsum: max |u| {umax} is not the lid speed")
    times = _timed_step(st, U, P, st._scalar(out["dt"]))
    log("[cavity3d-einsum] substeps ms (one synchronised step): "
        + ", ".join(f"{k}={v:.2f}" for k, v in times.items()))
    return out, launches


def _banded_ell(n, band, K, seed):
    """The TPU probes' inputs: K entries a row within +-band of it."""
    import torch
    from flow_tpu_torch.fem.ell import ELLMatrix

    rng = np.random.default_rng(seed)
    cols = np.clip(np.arange(n)[:, None] + rng.integers(-band, band, size=(n, K)),
                   0, n - 1)
    return ELLMatrix(cols, rng.standard_normal((n, K)), torch.float32, "cuda")


_FLUSH = []


def _l2_flush():
    """A 64 MB buffer whose zero_() evicts the L2 cache (50 MB)."""
    import torch

    if not _FLUSH:
        _FLUSH.append(torch.empty(16 << 20, dtype=torch.float32, device="cuda"))
    return _FLUSH[0]


def _ell_bytes(A, kernel):
    """Bytes one apply must move with `kernel`'s index width: vals, the
    indices (int32 columns; or 16-bit window indices and the segment
    tables), x and y."""
    item = A.vals.element_size()
    nk = A.n * A.width
    if kernel == "direct":
        return nk * (item + 4) + 2 * A.n * item
    return nk * (item + 2) + 3 * 4 * A.seg_start.numel() + 2 * A.n * item


def _ell_report(name, A, report, jobs):
    """Both ELL kernels at A, whichever one the rule picks (the windowed one
    where A has window tables): each against its plain version (<= 1e-6
    relative in float32), the windowed one against the direct one bitwise
    (the same products summed in the same k order), bitwise repeat, wall
    time; the plain versions' times; a torch.sparse CSR matvec of A as the
    yardstick; each kernel's bound from the bytes of the index width it
    reads (_ell_bytes) and 2 n K flops. Adds a row per kernel to `report`
    and its device-time jobs (L2 warm and cold) to `jobs`."""
    import torch
    from flow_tpu_torch.fem import ell

    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.standard_normal(A.n), dtype=A.dtype, device="cuda")
    rows = torch.arange(A.n, device="cuda").repeat_interleave(A.width)
    csr = _csr(rows, A.cols.reshape(-1), A.vals.reshape(-1), A.n)
    lib_ms = cuda_time_ms(lambda: csr @ x, 200)
    _, csr_err = _rel(csr @ x, ell.ell_apply_plain(A.vals, A.cols, x))
    check(csr_err <= 1e-6, f"ell {name}: the CSR yardstick differs ({csr_err})")
    del csr
    y_direct = A.apply_direct(x)

    variants = {"direct": (A.apply_direct,
                           lambda: ell.ell_apply_plain(A.vals, A.cols, x))}
    if A.tables is not None:
        variants["window"] = (A.apply_window, lambda: ell.ell_apply_window_plain(
            A.vals, A.lidx, A.seg_start, A.seg_len, A.seg_off, x, A.tables.rows))
    log(f"[ell] {name}: n={A.n} K={A.width} rule={A.kernel} saved_bytes={A.saved_bytes} "
        f"staged_bytes={A.staged_bytes} (factor {ell.WINDOW_FACTOR}, rows "
        f"{ell.WINDOW_ROWS}, gap {ell.WINDOW_GAP})")
    for kernel, (fn, plain) in variants.items():
        abs_err, rel_err = _check_kernel(f"ell {kernel} {name}", lambda: fn(x), plain,
                                         tol=1e-6)
        if kernel == "window":
            check(torch.equal(fn(x), y_direct),
                  f"ell window {name}: differs from the direct kernel")
        nbytes = _ell_bytes(A, kernel)
        b_ms, b_by = bound_ms(nbytes, 2 * A.n * A.width)
        ms = cuda_time_ms(lambda: fn(x), 200)
        plain_ms = cuda_time_ms(plain, 50)
        report[(kernel, name)] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                                      bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
        kname = f"ell_{kernel}_kernel"
        jobs[(kernel, name, "warm")] = (lambda fn=fn: fn(x), kname)
        # the same call after a write of 64 MB, more than the 50 MB L2:
        # the kernel then reads the matrix from device memory
        jobs[(kernel, name, "cold")] = (lambda fn=fn: (_l2_flush().zero_(), fn(x)), kname)
        extra = ("" if kernel == "direct" else
                 f" tiles={A.seg_start.shape[0]} G={A.seg_start.shape[1]} "
                 f"staged_max={A.staged_max} staged_bytes={A.staged_bytes}")
        log(f"[ell] {kernel:6s} {name}:{extra} rel_err={rel_err:.3e} kernel_ms={ms:.5f}"
            f" plain_ms={plain_ms:.5f} csr_ms={lib_ms:.5f} bytes={nbytes} "
            f"bound_ms={b_ms:.6f} ({b_by})")


def _ell_device_times(kell, ell_jobs):
    """Device ms per call of every ELL job, L2 warm and cold, into kell."""
    for (kernel, name, temp), (job, kname) in ell_jobs.items():
        key = "device_cold_ms" if temp == "cold" else "device_ms"
        kell[(kernel, name)][key] = device_ms(job, 100, kernel=kname)
    log("[profile] ell device ms per call, L2 warm / cold: "
        + ", ".join(f"{k[0]} {k[1]}={v['device_ms']:.6f}/{v['device_cold_ms']:.6f}"
                    for k, v in kell.items()))


def _hand_kernels():
    """Every hand kernel's launch counter (flow_tpu_torch._build.Kernel), by
    its module-level name."""
    from flow_tpu_torch import _build
    from flow_tpu_torch.attic import winform, winkernel, winmom
    from flow_tpu_torch.fem import ell
    from flow_tpu_torch.ops import stencil

    return {name: k for mod in (stencil, ell, winmom, winkernel, winform)
            for name, k in vars(mod).items() if isinstance(k, _build.Kernel)}


def _packed_stepper(prob, **settings):
    from flow_tpu_torch.fem.patch import build_patch_info
    from flow_tpu_torch.navier_stokes.patchfast import PackedPatchStepper

    t0 = time.perf_counter()
    info = build_patch_info(prob.mesh_hierarchy)
    t1 = time.perf_counter()
    st = PackedPatchStepper(prob.V, prob.Q, prob.u_bcs, prob.p_bcs, prob.rho,
                            prob.mu, info, **settings)
    setup = {"build_patch_info": t1 - t0, **st.setup_seconds,
             "stepper": time.perf_counter() - t1}
    return st, setup


def phase_packed_parity():
    """The packed route at KarmanProblem(lcar=0.2, n_refine=2) in float64, 3
    steps on the CPU and on the card, lambda_max carried across: the
    PackedPatchStepper with BiCGStab at the tight tolerances, and
    run_karman_fast(backend="packed") at its defaults (GMRES, consistent
    force probe). Equal per-step iteration counts, U within 1e-9 of max|U|
    and the mean-removed P within 1e-7 of max|P|."""
    import torch
    from flow_tpu_torch import interop
    from flow_tpu_torch.models.karman import KarmanProblem, run_karman_fast

    runs, lmax = {}, None
    for device in ("cpu", "cuda"):
        prob = KarmanProblem(dtype=torch.float64, device=device, **PACKED_PARITY)
        st, _ = _packed_stepper(prob, **PACKED_TIGHT)
        if lmax is None:
            lmax = [L.lmax for L in st.hierarchy.levels]
        interop.load_hierarchy_lmax(st.hierarchy, lmax)
        U, P, _, tel = st.run(*st.zeros(), 1e-3, 3)
        U, P = st.from_packed_state(U, P)
        out = run_karman_fast(num_steps=3, backend="packed", convection="lagged",
                              problem=prob, lmax=lmax)
        runs[device] = {"stepper": (U.cpu(), P.cpu(), tel),
                        "driver": (out["u"].cpu(), out["p"].cpu(), out["telemetry"])}
        _check_solves(tel, f"packed-parity stepper ({device})")
        _check_solves(out["telemetry"], f"packed-parity driver ({device})")
    for what in ("stepper", "driver"):
        (U_c, P_c, tel_c), (U_g, P_g, tel_g) = runs["cpu"][what], runs["cuda"][what]
        for key in ("newton_iters", "linear_iters", "pressure_iters", "correction_iters"):
            a, b = list(tel_g[key].tolist()), list(tel_c[key].tolist())
            log(f"[packed-parity] {what} {key}: cuda={a} cpu={b}")
            check(a == b, f"packed parity: {what} {key} differ (cuda {a}, cpu {b})")
        umax, pmax = float(U_c.abs().max()), float(P_c.abs().max())
        du = float((U_g - U_c).abs().max())
        dp = P_g - P_c
        dp = float((dp - dp.mean()).abs().max())
        msg = (f"max|dU|={du:.3e} (max|U| {umax:.3e}) max|dP - mean|={dp:.3e} "
               f"(max|P| {pmax:.3e})")
        if what == "driver":
            F_c, F_g = tel_c["forces"], tel_g["forces"]
            msg += f" forces rel {float(np.abs(F_g - F_c).max() / np.abs(F_c).max()):.3e}"
        log(f"[packed-parity] {what} {msg}")
        check(du <= 1e-9 * umax, f"packed parity: {what} U differs by {du}")
        check(dp <= 1e-7 * pmax, f"packed parity: {what} P differs by {dp}")


def _profiled_launches(fn):
    """(device events, kernel launch calls) of one call of fn, from
    torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    cuda = sum(1 for e in events if e.device_type == torch.autograd.DeviceType.CUDA)
    calls = sum(1 for e in events if e.name in ("cudaLaunchKernel", "cuLaunchKernel",
                                                "cudaLaunchKernelExC"))
    return cuda, calls


def phase_packed_main():
    """The benchmark's packed stepper at 1.9M DoF in float32: 1 warm-up step
    and 5 timed steps from rest, then one step with its substeps timed. No
    hand kernel belongs on this path: every launch is PyTorch's."""
    import torch
    from flow_tpu_torch.models.karman import KarmanProblem

    # the path's own peak: its tables and its run, above what earlier
    # phases still hold
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    prob = KarmanProblem(dtype=torch.float32, device="cuda", **KARMAN_MAIN)
    t_prob = time.perf_counter() - t0
    st, setup = _packed_stepper(prob, **PACKED_SETTINGS)
    torch.cuda.synchronize()
    setup = {"problem": t_prob, **setup, "total": time.perf_counter() - t0}
    pp = st.pp
    log(f"[packed] {KARMAN_MAIN} n_dofs={prob.n_dofs} float32 C={pp.info.C} "
        f"n={pp.info.n} n2={pp.n2} n1={pp.n1} levels="
        f"{[L.lay.n_flat for L in st.hierarchy.levels]}")
    log("[packed] setup s: " + ", ".join(f"{k}={v:.2f}" for k, v in setup.items()))
    check(prob.n_dofs == KARMAN_DOFS, f"packed: unexpected n_dofs {prob.n_dofs}")

    hand = _hand_kernels()
    for k in hand.values():
        k.launches = 0
    U, P = st.zeros()
    U, P, dt, tel_w = st.run(U, P, KARMAN_DT0, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    U, P, dt, tel = st.run(U, P, dt, PACKED_STEPS - 1)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {name: k.launches for name, k in hand.items()}
    peak = torch.cuda.max_memory_allocated() - base

    tel_all = {k: tel_w[k].tolist() + tel[k].tolist() for k in tel}
    n_timed = PACKED_STEPS - 1
    log(f"[packed] steps/s={n_timed / elapsed:.4f} ({n_timed} steps in {elapsed:.3f} s, "
        f"after 1 warm-up step; setup {setup['total']:.1f} s)")
    for k in ("dt", "linear_iters", "pressure_iters", "correction_iters"):
        log(f"[packed] {k}: {tel_all[k]}")
    log(f"[packed] peak_mem_bytes={peak} (tables and run, above the {base} bytes "
        f"earlier phases hold) hand-kernel launches={launches}")
    check(bool(torch.isfinite(U).all()) and bool(torch.isfinite(P).all()),
          "packed: non-finite state")
    check(bool(torch.isfinite(dt)), "packed: non-finite dt")
    for key in ("pressure_converged", "correction_converged"):
        check(all(tel_all[key]), f"packed: a {key.split('_')[0]} solve did not converge")
    check(not any(launches.values()), f"packed: a hand kernel was launched: {launches}")
    counts = {k: tel_all[k] for k in ("linear_iters", "pressure_iters", "correction_iters")}
    check(counts == KARMAN_PACKED_ITERS,
          f"packed: iterations {counts} are not KARMAN_PACKED_ITERS' {KARMAN_PACKED_ITERS}")
    Ug, Pg = st.from_packed_state(U, P)
    umax = float(Ug.abs().max())
    check(0.0099 <= umax <= 0.1, f"packed: max |u| {umax} out of range")
    times = _timed_step(st, U, P, dt)
    log("[packed] substeps ms (one synchronised step): "
        + ", ".join(f"{k}={v:.2f}" for k, v in times.items()))
    return prob, st, (U, P, dt), launches


def phase_packed_driver(prob):
    """run_karman_fast(backend="packed") at its defaults (GMRES, backward
    Euler, consistent force probe) at 1.9M DoF, one step per chunk: 1
    warm-up and 5 timed steps."""
    import torch
    from flow_tpu_torch.models.karman import run_karman_fast

    hand = _hand_kernels()
    for k in hand.values():
        k.launches = 0
    t0 = time.perf_counter()
    out = run_karman_fast(num_steps=PACKED_STEPS, chunk_size=1, backend="packed",
                          convection="lagged", problem=prob)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = {name: k.launches for name, k in hand.items()}
    st, tel = out["stepper"], out["telemetry"]
    timed = sum(out["chunk_seconds"][1:])
    log(f"[packed-driver] run_karman_fast backend=packed {KARMAN_MAIN} float32 "
        f"momentum_solver={st.mom_solver}: steps/s={(PACKED_STEPS - 1) / timed:.4f} "
        f"(after 1 warm-up step of {out['chunk_seconds'][0]:.3f} s; setup "
        f"{total - sum(out['chunk_seconds']):.1f} s)")
    for k in ("dt", "linear_iters", "pressure_iters", "correction_iters"):
        log(f"[packed-driver] {k}: {tel[k].tolist()}")
    log(f"[packed-driver] drag: {tel['forces'][:, 0].tolist()}")
    log(f"[packed-driver] lift: {tel['forces'][:, 1].tolist()}")
    U, P = out["u"], out["p"]
    check(tuple(U.shape) == (prob.V.n_dofs, 2) and tuple(P.shape) == (prob.Q.n_dofs,),
          "packed driver: state of the wrong shape")
    check(bool(torch.isfinite(U).all()) and bool(torch.isfinite(P).all()),
          "packed driver: non-finite state")
    check(np.isfinite(tel["forces"]).all(), "packed driver: non-finite forces")
    check(tel["forces"][-1, 0] > 0, "packed driver: the last step's drag is not positive")
    check(st.mom_solver == "gmres", "packed driver: not the driver's default GMRES")
    check(not any(launches.values()), f"packed driver: a hand kernel was launched: {launches}")
    return out


def phase_packed_launches(st, state):
    """Launches of the packed path from torch.profiler (run after the timed
    phases: a profiler session slows later host code): one step, one
    momentum apply (the EMA volume apply and the ds tangents) and one
    ema_S."""
    U, P, dt = state
    A = st._mom_operator(U, dt)
    s = dt / st.rho
    rows = {"step": _profiled_launches(lambda: st._step_impl(U, P, dt)),
            "momentum apply": _profiled_launches(lambda: A(U)),
            "ema_S": _profiled_launches(lambda: st.pp.ema_S(U, s * st.mu, s * st.rho)),
            "V-cycle": _profiled_launches(lambda: st.pressure_precond(P))}
    log("[packed] launches from the profiler (device events, launch calls): "
        + ", ".join(f"{k}={v[0]}/{v[1]}" for k, v in rows.items()))
    check(rows["step"][0] > 0, "packed: the profiler shows no device event in a step")
    return rows


def main():
    # a workspace setting under which cuBLAS is deterministic, for the
    # references run under deterministic() (read when cuBLAS starts)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
        k1, k1_rows, k1_jobs = phase_stencil(3)
        k2, k2_rows, k2_jobs = phase_stencil(2)
        phase_cavity_parity()
        k1["launches"], box_grids = phase_cavity_main()
        prob, st, hier, setup = phase_karman_setup()
        kwin, win_jobs = phase_window_kernels(st, hier)
        phase_karman_parity(KARMAN_SETTINGS, "karman-parity")
        lagged = phase_karman_main(prob, st, setup)
        del prob, st, hier
        torch.cuda.empty_cache()
        phase_karman_parity(KARMAN_NEWTON, "newton-parity")
        out, newton = phase_newton_main()
        knewton, newton_job = phase_newton_kernel(out["stepper"], out["u"])
        del out
        torch.cuda.empty_cache()
        phase_cavity3d_parity()
        out3, launches3 = phase_cavity3d_main()
        k3d, jobs3 = phase_window3d_kernels(out3["stepper"], out3["U"])
        del out3
        torch.cuda.empty_cache()
        phase_structured2d_parity()
        k2["launches"], s2d_grids = phase_structured2d_main()
        k4a, k5, jobs2 = phase_formwin2d()
        (k4b_p2, k4b_p2_job), (k4b3_p2, k4b3_p2_job), nl10 = phase_window_p2()
        phase_window_bigblock()
        # the einsum routes and the ELL kernels (P1 direct, P2 windowed) at
        # every ELL operator of the two drivers and at the probes' shapes
        phase_einsum_parity()
        oute, einsum = phase_einsum_main()
        kell, ell_jobs = {}, {}
        ste = oute["stepper"]
        for L in ste.pressure_precond.__self__.levels:
            _ell_report(f"karman level n={L.n}", L.ell, kell, ell_jobs)
        del oute, ste
        torch.cuda.empty_cache()
        out3e, einsum3 = phase_cavity3d_einsum()
        _ell_report("cavity3d pressure n=274625", out3e["stepper"].K_Q, kell, ell_jobs)
        del out3e
        torch.cuda.empty_cache()
        for name, (n, band, K) in ELL_PROBES.items():
            _ell_report(name, _banded_ell(n, band, K, seed=0), kell, ell_jobs)
        # the packed-patch route (the bench's default Karman path): no hand
        # kernel, every launch PyTorch's; its profiler counts come after its
        # timed phases
        phase_packed_parity()
        prob_p, st_p, state_p, packed = phase_packed_main()
        packed_driver = phase_packed_driver(prob_p)
        phase_packed_launches(st_p, state_p)
        del prob_p, st_p, state_p, packed_driver
        torch.cuda.empty_cache()
        # device times from the profiler, last: a profiler session slows
        # later host code in the process
        _ell_device_times(kell, ell_jobs)
        for row, jobs in ((kwin["winmom"], win_jobs["winmom"]), (knewton, newton_job)):
            row["device_ms"] = device_ms(jobs["warm"], 50, kernel="winmom_kernel")
            row["device_cold_ms"] = device_ms(jobs["cold"], 50, kernel="winmom_kernel")
        log("[profile] K3 2-D device ms per call, L2 warm / cold (wall; host us; CSR): "
            + ", ".join(f"{tag}={r['device_ms']:.5f}/{r['device_cold_ms']:.5f} "
                        f"({r['ms']:.5f}; {r['host_us']:.3f}; {r['library_ms']:.5f})"
                        for tag, r in (("winmom lagged", kwin["winmom"]),
                                       ("winmom newton", knewton))))
        kwin["winstiff"]["device_ms"] = device_ms(win_jobs["winstiff"], 100)
        for name in ("winmom3d", "winmom3d_newton"):
            k3d[name]["device_ms"] = device_ms(jobs3[name]["warm"], 20,
                                               kernel="winmom3d_kernel")
            k3d[name]["device_cold_ms"] = device_ms(jobs3[name]["cold"], 20,
                                                    kernel="winmom3d_kernel")
        log("[profile] K3 3-D device ms per call, L2 warm / cold (wall; host us; "
            "overlap_add): "
            + ", ".join(f"{k}={k3d[k]['device_ms']:.5f}/{k3d[k]['device_cold_ms']:.5f} "
                        f"({k3d[k]['ms']:.5f}; {k3d[k]['host_us']:.3f}; "
                        f"{k3d[k]['overlap_add_ms']:.5f})"
                        for k in ("winmom3d", "winmom3d_newton")))
        k4b3 = {tag: device_ms(job, 20, kernel="winstiff_cluster_kernel")
                for tag, job in jobs3["winstiff3d"].items()}
        k3d["winstiff3d"]["device_ms"] = k4b3.pop("warm")
        k3d["winstiff3d"]["device_cold_ms"] = k4b3.pop("cold")
        log(f"[profile] winstiff3d device ms per call: L2 warm "
            f"{k3d['winstiff3d']['device_ms']:.5f} cold "
            f"{k3d['winstiff3d']['device_cold_ms']:.5f}; "
            + ", ".join(f"{k}={v:.5f}" for k, v in k4b3.items()))
        _stencil_device_times("K1", k1, k1_rows, k1_jobs)
        _stencil_device_times("K2", k2, k2_rows, k2_jobs)
        # K4a and K5 at NL = 6 (formwin2d) and NL = 10 (tets N=32), L2
        # warm and cold
        (k4a10, jobs4a10), (k5_10, jobs5_10) = nl10
        for row, jobs, kname in ((k4a, jobs2["winmass"], "winmass_kernel"),
                                 (k5, jobs2["winform"], "winform_kernel"),
                                 (k4a10, jobs4a10, "winmass_kernel"),
                                 (k5_10, jobs5_10, "winform_kernel")):
            row["device_ms"] = device_ms(jobs["warm"], 50, kernel=kname)
            row["device_cold_ms"] = device_ms(jobs["cold"], 50, kernel=kname)
        log("[profile] K4a/K5 device ms per call, L2 warm / cold (wall; CSR): "
            + ", ".join(f"{tag}={r['device_ms']:.5f}/{r['device_cold_ms']:.5f} "
                        f"({r['ms']:.5f}; {r['library_ms']:.5f})" for tag, r in (
                            ("winmass NL=6", k4a), ("winform NL=6", k5),
                            ("winmass NL=10", k4a10), ("winform NL=10", k5_10))))
        for row, jobs in ((k4b_p2, k4b_p2_job), (k4b3_p2, k4b3_p2_job)):
            row["device_ms"] = device_ms(jobs["warm"], 50, kernel="winstiff_p2_kernel")
            row["device_cold_ms"] = device_ms(jobs["cold"], 50,
                                              kernel="winstiff_p2_kernel")
        log("[profile] K4b P2 device ms per call, L2 warm / cold (wall; host us; CSR): "
            + ", ".join(f"{tag}={r['device_ms']:.5f}/{r['device_cold_ms']:.5f} "
                        f"({r['ms']:.5f}; {r['host_us']:.3f}; {r['library_ms']:.5f})"
                        for tag, r in (("winstiff_p2 tri n=256", k4b_p2),
                                       ("winstiff3d_p2 tets N=32", k4b3_p2))))
        log("[profile] device ms per call: "
            + ", ".join(f"{k}={v['device_ms']:.5f}" for k, v in
                        (("winmom lagged", kwin["winmom"]), ("winstiff", kwin["winstiff"]),
                         ("winmom newton", knewton), *k3d.items(), ("stencil2d", k2),
                         ("winmass", k4a), ("winform", k5), ("winstiff_p2 tri", k4b_p2),
                         ("winstiff3d_p2 tets", k4b3_p2))))
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(f"[done] all phases in {time.perf_counter() - t_start:.1f} s")
    # launches: each kernel's count on its main path (the 3-D route for the
    # 3-D kernels, the Newton driver for the 2-D window kernels), with the
    # other paths' beside them; K1's from the box cavity path
    kwin["winmom"]["launches"] = newton["winmom"]
    kwin["winstiff"]["launches"] = newton["winstiff"]
    knewton["launches"] = newton["winmom_newton"]
    for name in ("winmom3d", "winmom3d_newton", "winstiff3d"):
        k3d[name]["launches"] = launches3[name]
    paths = {"winmom": {"karman_newton": newton["winmom"], "karman_lagged": lagged["winmom"]},
             "winstiff": {"karman_newton": newton["winstiff"],
                          "karman_lagged": lagged["winstiff"]},
             "stencil3d": {"cavity_box": k1["launches"],
                           "cavity3d_window": launches3["stencil3d"]},
             "stencil2d": {"structured2d_poisson": k2["launches"]},
             "winmass": {"formwin2d": k4a["launches"]},
             "winform": {"formwin2d": k5["launches"]},
             "winstiff_p2": {"p2_poisson_2d": k4b_p2["launches"]},
             "winstiff3d_p2": {"p2_poisson_3d": k4b3_p2["launches"]},
             "ell_direct": {"karman_einsum": einsum["ell_direct"],
                            "cavity3d_einsum": einsum3["ell_direct"]},
             "ell_window": {"karman_einsum": einsum["ell_window"],
                            "cavity3d_einsum": einsum3["ell_window"]},
             "winmom_newton": {"karman_newton": newton["winmom_newton"]},
             "winmom3d": {"cavity3d_window": launches3["winmom3d"]},
             "winmom3d_newton": {"cavity3d_window": launches3["winmom3d_newton"]},
             "winstiff3d": {"cavity3d_window": launches3["winstiff3d"]}}
    # the packed Karman path launches none of them
    counter_of = {"winmom": "WINMOM", "winstiff": "WINSTIFF", "stencil3d": "STENCIL_3D",
                  "stencil2d": "STENCIL_2D", "winmass": "WINMASS", "winform": "WINFORM",
                  "winstiff_p2": "WINSTIFF_P2", "winstiff3d_p2": "WINSTIFF3D_P2",
                  "ell_direct": "ELL_DIRECT", "ell_window": "ELL_WINDOW",
                  "winmom_newton": "WINMOM_NEWTON", "winmom3d": "WINMOM3D",
                  "winmom3d_newton": "WINMOM3D_NEWTON", "winstiff3d": "WINSTIFF3D"}
    check(sorted(counter_of.values()) == sorted(packed),
          f"the launches by path name {sorted(counter_of.values())}, not {sorted(packed)}")
    for name, counter in counter_of.items():
        paths[name]["karman_packed"] = packed[counter]
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
        dict(name="momentum_windows 3-D (lagged)", route="cuda",
             source="flow_tpu_torch/csrc/winmom3d.cu",
             replaces="flow_tpu/attic/winmom.py:209", **k3d["winmom3d"]),
        dict(name="momentum_windows 3-D (Newton)", route="cuda",
             source="flow_tpu_torch/csrc/winmom3d.cu",
             replaces="flow_tpu/attic/winmom.py:219", **k3d["winmom3d_newton"]),
        dict(name="stiffness_windows", route="cuda",
             source="flow_tpu_torch/csrc/winstiff.cu",
             replaces="flow_tpu/attic/winkernel.py:259", **kwin["winstiff"]),
        dict(name="stiffness_windows 3-D", route="cuda",
             source="flow_tpu_torch/csrc/winstiff.cu",
             replaces="flow_tpu/attic/winkernel.py:259", **k3d["winstiff3d"]),
        dict(name="stiffness_windows P2", route="cuda",
             source="flow_tpu_torch/csrc/winstiff.cu",
             replaces="flow_tpu/attic/winkernel.py:259", **k4b_p2),
        dict(name="stiffness_windows 3-D P2", route="cuda",
             source="flow_tpu_torch/csrc/winstiff.cu",
             replaces="flow_tpu/attic/winkernel.py:259", **k4b3_p2),
        dict(name="stencil_apply_2d", route="cuda",
             source="flow_tpu_torch/csrc/stencil2d.cu",
             replaces="flow_tpu/ops/pallas_stencil.py:131", **k2),
        dict(name="mass_windows", route="cuda",
             source="flow_tpu_torch/csrc/winmass.cu",
             replaces="flow_tpu/attic/winkernel.py:150", **k4a),
        dict(name="element_windows", route="cuda",
             source="flow_tpu_torch/csrc/winform.cu",
             replaces="flow_tpu/attic/winform.py:92", **k5),
        # the ELL kernels at the largest operator of the path each takes:
        # the direct one on the einsum Karman path (its pressure operator),
        # the windowed one on the 3-D einsum path (its pressure operator)
        dict(name="ell_apply direct", route="cuda",
             source="flow_tpu_torch/csrc/ell.cu",
             replaces="scripts/pallas_gather_probe.py:76",
             launches=einsum["ell_direct"], **kell[("direct", "karman level n=212256")]),
        dict(name="ell_apply window", route="cuda",
             source="flow_tpu_torch/csrc/ell.cu",
             replaces="scripts/onehot_window_probe.py:125",
             launches=einsum3["ell_window"],
             **kell[("window", "cavity3d pressure n=274625")]),
    ]
    log(f"[done] launches by path: {json.dumps(paths)}")
    # the stencils' launches by level on each path, and launches x (device
    # time - bound) a level: what the path loses to each kernel above its bound
    for tag, levels, grids in (("stencil3d cavity_box", k1_rows, box_grids),
                               ("stencil3d cavity3d_window", k1_rows,
                                launches3["stencil3d by grid"]),
                               ("stencil3d cavity3d_einsum", k1_rows,
                                einsum3["stencil3d by grid"]),
                               ("stencil2d structured2d_poisson", k2_rows, s2d_grids)):
        loss = {g: c * 1e3 * (levels[g]["device_ms"] - levels[g]["bound_ms"])
                for g, c in grids.items() if g in levels}
        log(f"[done] {tag} launches by grid {grids}; launches x (device - bound) us "
            + ", ".join(f"{g}={v:.1f}" for g, v in loss.items())
            + f"; sum {sum(loss.values()):.1f}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    # host_us: the host µs per call of the K1, K2, K4b and K3 rows
    print(json.dumps({"kernels": [{k: r[k] for k in keys + ("host_us",) if k in keys or k in r}
                                  for r in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
