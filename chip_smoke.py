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
   DoF, float32, tangent_mode CAVITY3D_TANGENT, 1 warm-up and 1 timed step
   (CAVITY3D_EINSUM_STEPS; 3 timed until phase 31 needed the time), with
   its peak memory; fails on a non-finite state, an unconverged solve,
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
27a. Stokes parity: stokes.solve on Guermond1 (tests/test_stokes.py, its
   forcing written out) at unit_square_mesh(16) on the MINRES path (rtol
   3e-9) in float64, on the CPU and twice on the card, the CPU's lambda_max carried
   over: equal iterations, u within 1e-9 and p within 1e-7 of their
   largest entries (within the solve's own error against the dense LU),
   the card's two solves bitwise equal, the MMS errors small;
27b. path A, the Stokes bootstrap: run_karman_fast(backend="packed",
   from_rest=False) at the main path's mesh (lcar=0.02). The float32 run at
   n_refine=5 (1,905,056 DoF) takes the driver's bootstrap call (MINRES to
   rtol 1e-6, 2000 iterations at most, as the JAX driver asks) alone: it
   reaches the cap with its true residual above the target and raises, as
   the JAX package's does (float64 does the same there:
   scripts/torch_bootstrap_3d_probe.py); the float64 run at n_refine=4
   converges and the driver takes 1 + 5 steps from it, one a chunk. Each run's MINRES iterations, true residual, seconds and peak
   memory; fails on a hand-kernel launch, a non-finite state or force, an
   unconverged pressure or correction solve, or runs other than
   KARMAN_BOOTSTRAP_ITERS;
28. Boussinesq parity: compute_boussinesq(backend="packed") in float64 to
   t = 0.3 at lcar = 0.03 with one refinement (dense heat solve) and three
   (6,624 temperature dofs: the multigrid-GMRES heat solve), on the card
   and on the CPU: equal Banach sweeps and, a sweep, equal heat-GMRES,
   Picard, GMRES, pressure and correction iterations, u within 1e-8 and
   theta within 1e-10 of their largest entries; one step each of Chorin, IPCS and
   Rotational (einsum context, Newton) on unit_square_mesh(16), card
   against CPU (equal counts, u within 1e-10); the heat operator's
   applies, its load vector, the shifted multigrid's restriction and
   V-cycle twice on the card, bitwise equal;
29. Boussinesq main path: compute_boussinesq(lcar=0.01, n_refine=5,
   backend="packed", supg=False) in float64, 2,484,096 coupled DoF
   (velocity 2 x 764,160, pressure 191,616, temperature 764,160), to
   t = BOUSSINESQ_MAIN_TIME from rest (dt0 = 1e-2): setup seconds (mesh and
   projections, the packed stepper, the heat hierarchy), seconds a
   coupled step after the first with its heat and NS parts, the Banach
   sweeps a step, the iterations a sweep, peak memory, ||u||_L2 and
   ||theta||_L2; fails on a failed sweep, a heat solve off the multigrid
   path, or counts other than BOUSSINESQ_PACKED_ITERS. Then one coupled
   sweep under torch.profiler, a part at a time: the heat operator's
   assembly, its solve (launches an MG-GMRES iteration), one V-cycle and
   the NS step, with the aten ops with the most device time;
29a. 3-D Boussinesq parity: compute_boussinesq_3d in float64 on the card and
   on the CPU at n = (4, 4, 8) to t = 0.02 on both routes and at n = (2, 2,
   4) to t = 0.62 on the packed route (the fluid moves in its last step):
   equal counts a Banach sweep, u within 1e-8 and theta within 1e-10 of
   their largest entries, K1 launched on the packed route only;
29b. path B: compute_boussinesq_3d(backend="packed", n=(12, 12, 24)) in
   float64, 126,725 coupled DoF (the host splu factor took 130-136 s a
   sweep at n = (16, 16, 32), 62-67 s at N = 14), from rest to t = 0.62
   (six steps, eight sweeps; the fluid is at rest in the first five and
   moves in the last): the NS
   step on BoxPackedStepper (its pressure operator and V-cycle levels are
   K1), the heat solve on the host splu every sweep (its factor seconds
   apart); seconds a step split heat / NS, peak memory, K1's launches by
   grid, in all and a sweep; fails on a failed sweep, a heat solve off
   splu, a last step without Picard, BiCGStab and pressure iterations or
   without K1 launches, another hand kernel's launch, or counts other than
   BOUSSINESQ3D_PACKED_ITERS;
29c. path C: compute_boussinesq_3d(backend=None, n=(8, 8, 16), n_refine=2)
   in float64, 2,250,885 coupled DoF, one step from rest: Rotational on the
   twice refined tets, the heat solve by MG-GMRES on four P1 levels (1,377
   to 545,025 vertices; the extra level has 3,145,728 tets); fails on a
   failed sweep, a heat solve off the multigrid, a hand-kernel launch, or
   counts other than BOUSSINESQ3D_MG_ITERS;
29d. FastStepper's options, card against CPU: at KarmanProblem(lcar=0.2,
   n_refine=2) in float64, 3 steps from dt0 = 1e-4, lambda_max carried
   across, each of packed=True, patches= (PatchP1Hierarchy), GMRES
   momentum, forward Euler, assembled_jacobian=True, lagged_ell=True,
   momentum_precond="vertex" and divergence_probe=True: equal per-step
   counts, U and P within 1e-8, the forces (and div_norm) within 1e-8 of
   their largest entries;
29e. DiffStepper: the gradient of a 3-step rollout's loss in mu and U0 at
   the same mesh in float64, on the card and on the CPU (within 1e-8
   relative of each other), each against a central finite difference;
29f. patch mode at 1,905,056 DoF, float32: bench.py's BENCH_PATCH=1
   stepper (lagged, GMRES(32), PatchP1Hierarchy; the state kept in the
   patch layout) and PackedPatchStepper(momentum_solver="gmres") at the
   same settings, 1 + 5 steps each, counts side by side; fails on a
   non-finite state or force, a last drag <= 0, an unconverged solve, a
   hand-kernel launch, or patch counts other than PATCH_ITERS;
29g. the einsum route at 7,607,104 DoF (KarmanProblem(lcar=0.02,
   n_refine=6), built once), float32: (a) run_karman_fast at its defaults
   and (b) bench.py's FastStepper at BENCH_PATCH=0 with packed="auto" and
   packed=False, 1 + 3 steps each, one a chunk: steps/s, setup seconds,
   peak memory, counts, drag and lift, the ELL launches by operator and
   one synchronised step split by substep; fails on a non-finite state or
   force, a last drag <= 0, an unconverged solve, (a) or (b-auto) off the
   packed layout, no direct ELL launch, any window or stencil launch, or
   (a) or (b-auto) counts other than KARMAN_7M_ITERS (the unpacked run's
   index_add_ sums vary in order: logged). Then the ELL kernels (23's report)
   at its pressure operator (846,400 x 9) and its levels of 212,256 and
   53,392 rows;
30. device times (torch.profiler, last, since profiling slows later host
   code): one step each of 29g's (a) and (b-auto) (device events, launch
   calls, device ms, the idle share against the same step unprofiled, the
   top aten ops), the launches of one bootstrap MINRES iteration (a solve capped at
   20 iterations less one capped at 10), K1 in float64 at path B's grids,
   then of the ELL kernels at every shape of 23 (with the L2 cache warm,
   and cold: after a 64 MB write), K3 2-D lagged and Newton (L2 warm and
   cold), K4b 2-D, the three 3-D kernels (L2 warm and cold; K4b 3-D also at
   its 2-pass layout), K1 and K2 at every level grid of their paths (L2
   warm and cold, the operator's launch) with cuDNN's convolution at the
   finest, K4a and K5 at NL = 6 and 10 (L2 warm and cold),
   and K4b 2-D and 3-D P2 (L2 warm and cold). Every K4b and K3 2-D row
   also carries host_us: perf_counter over 200 calls enqueued with no
   synchronisation, divided by the count, the least of five such loops;
   the K3 3-D rows the same over 20 calls, the least of three loops.

31. the distributed layer (flow_tpu_torch/parallel/), run as
   `chip_smoke.py --distributed` in a process of its own (ranks on
   torch.distributed, world size = the cards present, one a rank on NCCL;
   a world of 1 runs in that process): (a) card against CPU: the four
   distributed steppers on small float64 problems on the cards and on as
   many gloo CPU ranks (parallel/cases.parity_cases): equal counts, state
   within 1e-8 (the window route, float32 inside: U within 2e-6 of max|U|,
   P within 1e-4 of max|P|); (b) ShardedPackedStepper at KARMAN_MAIN in
   float32 at PACKED_SETTINGS (BiCGStab), 1 + 5 steps: counts (at one rank
   they must be KARMAN_PACKED_ITERS; at more, SHARDED_PACKED_ITERS where
   pinned), steps/s, peak memory a rank, collectives a step and the host
   µs of a 0-d all_reduce, the device and NCCL time of one profiled step;
   (c) HaloProjection at KARMAN_MAIN in float32 with the
   multigrid on its refinement chain: the einsum route lagged and Newton,
   then the window route (K3 2-D) lagged and Newton, 1 + 2 steps each
   (HALO_SETTINGS): counts, s a step, one profiled step's device events
   and µs, the hand kernels' launches of each route (K3 on the window
   route, the ELL kernels in the replicated coarse hierarchy), and K3
   against its plain version at each rank's halo layout (<= 1e-5
   relative); the window route lagged and Newton one step each on
   box_mesh N=32 (K3 3-D); fails on a non-finite state, a route without
   its kernels' launches or a K3 that differs;
   (d) ShardedProjection one step and HaloPoisson one solve at
   KARMAN_MAIN's spaces; (e) on four cards or more, the sharded packed
   stepper at KarmanProblem(lcar=0.0175, n_refine=6) (9,894,272 DoF):
   counts, steps/s, peak memory a rank, NCCL time of one profiled step.
   Its summary (the halo route's launches) joins the kernel report;
32. seeding and I/O: scripts/schafer_turek.py's DFG 2D-2 seeding route.
   (a) In float64 at lcar=0.1 (n_refine 1 -> 2), on the CPU and on the
   card, lambda_max carried across: equal counts in both legs, U within
   1e-9 of max|U|, the mean-removed P within 1e-7 of max|P|. (b) On the
   card in float32: schafer_turek_problem(lcar=0.03, n_refine=3) (which
   must equal level 3 of the n_refine=4 hierarchy, points and cells) from
   the script's antisymmetric vortex blob (amplitude 0.4, Dirichlet rows
   zeroed), run_karman_fast(backend="packed", lagged, BDF2, the bench's
   tolerances, dt0 1e-4, dt_max 4e-3) 1 + 5 steps with a checkpoint;
   load_checkpoint, prolong_vector of U and P onto n_refine=4 (its DoF
   printed), the fine Dirichlet values re-imposed, restrict_vector giving
   the coarse vectors back bitwise and the card's prolongation equal to the
   CPU's bitwise, the transfer's seconds; the fine leg 1 + 5 steps from the
   prolonged state: steps/s, peak memory, counts (held to
   SEEDED_PACKED_ITERS), drag and lift (finite), each step through
   MetricsLogger, one more step under profiling.trace (a trace file must
   exist), device_memory_stats() naming the card. (c) The fine mesh through
   save_mesh/load_mesh, write_dolfin_xml/read_dolfin_xml and a gmsh 4.1
   binary file (written here) through read_msh (rcm=False: the same points
   and cells; rcm=True: reorder_rcm's), seconds and bytes of each; where
   h5py imports, XDMFFile.write of velocity and pressure and write_checkpoint
   / read_checkpoint back to the card (bitwise), else one line saying the
   XDMF leg did not run; run_karman(writer=) and compute_boussinesq(writer=)
   at their CPU tests' sizes, 2 steps each, through an XDMFFile (without
   h5py an in-memory writer). Fails on a hand-kernel launch;

Then every hand kernel's launches by path (karman_packed: 0 for each), and
K1's and K2's launches by grid on each path (path B's in float64), with
launches x (device time - bound) a grid. The line before the last holds the kernel report, the
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
CAVITY3D_EINSUM_STEPS = 2  # 1 warm-up + 1 timed: ~10 s a step
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
# the coupled Boussinesq driver (models/boussinesq.py) in float64: its
# parity runs (to t = 0.3: the heater ramp moves the fluid from the third
# step on) and its main path
BOUSSINESQ_PARITY = [dict(lcar=0.03, n_refine=1), dict(lcar=0.03, n_refine=3)]
BOUSSINESQ_PARITY_TIME = 0.3
BOUSSINESQ_MAIN = dict(lcar=0.01, n_refine=5, backend="packed", supg=False)
BOUSSINESQ_DOFS = {"velocity": 2 * 764160, "pressure": 191616,
                   "temperature": 764160, "coupled": 2484096}
# to t = 0.62: six steps (t = 0, 0.02, 0.06, 0.14, 0.3, 0.58); the momentum
# residual stays below its absolute 1e-10 (no Picard iteration) until the
# last step moves the fluid
BOUSSINESQ_MAIN_TIME = 0.62
# the main path's (step, sweep, failed, heat solver, heat GMRES, Picard,
# momentum GMRES, pressure CG, correction CG) a Banach sweep, pinned from
# the first run of this phase on the card (H100 80GB HBM3, 700 W): the
# heat path's sums read member tables and the packed route's sum in a
# fixed order, so these counts must not move
BOUSSINESQ_PACKED_ITERS = [(0, 1, None, "mg", 42, 0, 0, 0, 0),
                           (1, 1, None, "mg", 34, 0, 0, 0, 0),
                           (2, 1, None, "mg", 26, 0, 0, 0, 0),
                           (3, 1, None, "mg", 19, 0, 0, 0, 0),
                           (4, 1, None, "mg", 15, 0, 0, 0, 0),
                           (4, 2, None, "mg", 15, 0, 0, 0, 0),
                           (5, 1, None, "mg", 12, 1, 20, 8, 23),
                           (5, 2, None, "mg", 12, 1, 26, 8, 23)]
# steady Stokes (stokes.py): the card-vs-CPU parity of the MINRES path on
# Guermond1 (tests/test_stokes.py, written out below) at n = 16, float64
STOKES_PARITY_N = 16
# MINRES's rtol there: the recurrence's residual falls by 1.9x across the
# stop (1.44 and 0.76 of the target on the CPU), so the card and the CPU,
# whose sums round apart by ~1%, stop at the same iteration (at 1e-9 the
# target sits on a plateau: 143 on the card, 142 on the CPU)
STOKES_PARITY_RTOL = 3e-9
# the Stokes bootstrap of run_karman_fast(from_rest=False) on the packed
# route at the Karman main path's mesh: (dtype, n_refine) in the order
# tried. MINRES stops on its preconditioned recurrence; where the true
# residual is then above rtol 1e-6 |b| the solve raises, in the JAX
# package too, and the next run is tried; the last one converges and the
# driver takes its 1 + 5 steps. At 1,905,056 DoF MINRES reaches its cap of
# 2000 in float32 and in float64 alike (true residuals 7.4e-7 and 6.9e-7
# there; the float64 run, 128 s, is left to
# scripts/torch_bootstrap_3d_probe.py A); at 477,904 DoF (n_refine 4) it
# converges in float64 (n_refine 3 and 2 too)
KARMAN_BOOTSTRAP_RUNS = [("float32", 5), ("float64", 4)]
# each run's (dtype, n_refine, MINRES iterations, converged), pinned from
# the first runs of this path on the card (H100 80GB HBM3, 700 W): the
# Stokes operator sums read member tables, so these must not move
KARMAN_BOOTSTRAP_ITERS = [("float32", 5, 2000, False), ("float64", 4, 1878, True)]
# the 3-D Boussinesq driver (models/boussinesq3d.py) in float64: its parity
# runs (the moving one to t = 0.62, where the heater ramp moves the fluid)
BOUSSINESQ3D_PARITY = [dict(target_time=0.02, n=(4, 4, 8), backend=None),
                       dict(target_time=0.02, n=(4, 4, 8), backend="packed"),
                       dict(target_time=0.62, n=(2, 2, 4), backend="packed")]
# path B: the box-packed NS route (K1) with the host splu heat solve. A
# coupled step is nearly all the splu factor of the heat dofs (every
# sweep: a new Heat, a new factor): 130-136 s at n = (16, 16, 32) (70,785
# heat dofs), 62-67 s at N = 14 (47,937), 15.1-15.6 s at N = 12 (30,625)
# on the card machine's host. N = 13 is odd: its box would leave the
# stepper's pressure hierarchy one dense level, with no V-cycle on K1. So
# the path runs at N = 12, the largest even N under ~60 s a step
BOUSSINESQ3D_PACKED = dict(n=(12, 12, 24), backend="packed")
# six steps from rest (dt 0.01 doubling): at N = 12 the momentum residual
# stays below the absolute 1e-10 through t = 0.3 and the fluid moves in the
# sixth step (t = 0.3 -> 0.58, two sweeps; on the CPU, N = 10 and 12 alike;
# at N = 2-8 it moves a step earlier)
BOUSSINESQ3D_PACKED_TIME = 0.62
BOUSSINESQ3D_PACKED_DOFS = {"velocity": 3 * 30625, "pressure": 4225,
                            "temperature": 30625, "coupled": 126725}
# path C: Rotational on the twice-refined tets with the multigrid heat solve
BOUSSINESQ3D_MG = dict(n=(8, 8, 16), n_refine=2, backend=None)
BOUSSINESQ3D_MG_TIME = 0.0  # one step from rest
BOUSSINESQ3D_MG_DOFS = {"velocity": 3 * 545025, "pressure": 70785,
                        "temperature": 545025, "coupled": 2250885}
# (step, sweep, failed, heat solver, heat iterations, Newton/Picard, BiCGStab
# (packed only), pressure CG, correction CG) a Banach sweep of paths B and
# C, pinned from the first run of these phases on the card (H100 80GB
# HBM3, 700 W; path B's from its first run to t = 0.62, the CPU's counts
# too): the heat and Stokes sums read member tables, K1 sums in a fixed
# order, so these must not move
# (path C's fluid is at rest in its step: its NS solves take 0 iterations)
BOUSSINESQ3D_PACKED_ITERS = [(0, 1, None, "splu", 0, 0, 0, 0, 0),
                             (1, 1, None, "splu", 0, 0, 0, 0, 0),
                             (2, 1, None, "splu", 0, 0, 0, 0, 0),
                             (3, 1, None, "splu", 0, 0, 0, 0, 0),
                             (4, 1, None, "splu", 0, 0, 0, 0, 0),
                             (4, 2, None, "splu", 0, 0, 0, 0, 0),
                             (5, 1, None, "splu", 0, 1, 2, 7, 42),
                             (5, 2, None, "splu", 0, 1, 3, 7, 42)]
BOUSSINESQ3D_MG_ITERS = [(0, 1, None, "mg", 54, 0, None, 0, 0),
                         (0, 2, None, "mg", 54, 0, None, 0, 0)]
# the einsum 3-D route's Newton tangent: "linearize" keeps x's quadrature
# tables for a Newton iteration (the JAX default; JAX needed "jvp" where
# linearize's storage did not fit)
# FastStepper's other routes and options (PR 16): the card-vs-CPU parity
# runs at EINSUM_PARITY in float64, run_karman_fast's driver settings
FAST_PARITY_SETTINGS = dict(
    rotational_form=True, newton_tol=0.0, newton_rtol=1e-3, newton_maxiter=3,
    linear_rtol=1e-4, pressure_rtol=1e-4, correction_rtol=1e-5, cfl_target=1.0,
    dt_max=1.0,
)
FAST_PARITY_OPTIONS = {
    "packed": dict(packed=True),
    "patches": dict(patches=True),  # build_patch_info + PatchP1Hierarchy
    "gmres": dict(convection="lagged", momentum_solver="gmres"),
    "forward-euler": dict(time_step_method="forward euler"),
    "assembled-jacobian": dict(assembled_jacobian=True),
    "lagged-ell": dict(convection="lagged", lagged_ell=True),
    "vertex": dict(momentum_precond="vertex"),
    "divergence-probe": dict(divergence_probe=True),
}
# bench.py:105-183 at BENCH_PATCH=0 (the einsum FastStepper): lagged,
# GMRES(32), the calibrated Newton and linear tolerances, pressure 3e-4
# with maxiter 600, correction 1e-4, P1Hierarchy of degree 3; BENCH_PATCH=1
# adds patches= and PatchP1Hierarchy
FAST_BENCH = dict(
    convection="lagged", momentum_solver="gmres", rotational_form=True,
    newton_tol=0.0, newton_rtol=1e-2, newton_maxiter=4, linear_rtol=1e-1,
    pressure_rtol=3e-4, pressure_maxiter=600, correction_rtol=1e-4, cfl_target=1.0,
    dt_max=1.0,
)
KARMAN_7M = dict(lcar=0.02, n_refine=6)
KARMAN_7M_DOFS = 7607104  # BENCH_LARGE.json's size at these arguments
KARMAN_7M_STEPS = 4  # 1 warm-up + 3 timed
# the 7.6M packed runs' iterations a step ((a) run_karman_fast, (b-auto)
# the bench stepper), pinned from the card (H100 80GB HBM3, 700 W): every
# sum of these runs reads a member table (the packed layout's dof sums,
# P1Hierarchy's restriction), so they repeat. The unpacked run's are
# logged, not held: its dof sums are FunctionSpace.dof_sum's index_add_,
# whose order varies on the card
KARMAN_7M_ITERS = {
    "a": {"newton_iters": [1, 1, 2, 1], "linear_iters": [5, 4, 10, 6],
          "pressure_iters": [4, 4, 3, 3], "correction_iters": [8, 8, 9, 9]},
    "b-auto": {"newton_iters": [1, 1, 1, 1], "linear_iters": [4, 4, 4, 5],
               "pressure_iters": [3, 3, 3, 3], "correction_iters": [6, 6, 7, 6]},
}
PATCH_STEPS = 6  # 1 warm-up + 5 timed at KARMAN_MAIN
# the patch stepper's iterations a step at 1.9M, pinned as above
PATCH_ITERS = {"newton_iters": [1, 1, 1, 1, 1, 1], "linear_iters": [4, 3, 4, 4, 4, 5],
               "pressure_iters": [3, 3, 3, 3, 3, 3], "correction_iters": [6, 6, 8, 8, 8, 8]}
DIFF_STEPS = 3
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
# the distributed layer (parallel/, PR 17): world size = the cards present
DIST_SCRIPT_TIMEOUT = 900  # seconds for `chip_smoke.py --distributed`
SHARDED_PACKED_STEPS = 6  # 1 warm-up + 5 timed, as the single-card packed path
# HaloProjection at KARMAN_MAIN in float32 (no settings of the JAX package's
# own for this size: absolute Newton tolerance at the float32 floor of the
# momentum residual, two Newton steps at most, float32 Krylov tolerances)
HALO_SETTINGS = dict(newton_tol=1e-9, newton_maxiter=2, linear_rtol=1e-4,
                     pressure_rtol=1e-4, correction_rtol=1e-4, smoother_degree=3,
                     cfl_target=1.0, dt_max=1.0)
HALO_STEPS = 3  # 1 warm-up + 2 timed, each route
HALO3D_N = 32  # box_mesh N of the cavity route's K3 3-D check
PROJECTION_SETTINGS = dict(newton_tol=1e-6, newton_maxiter=2, linear_rtol=1e-3,
                           pressure_rtol=1e-4)
# the sharded packed stepper's counts at KARMAN_MAIN by world size where
# two four-card calls agreed (world 1 is held to KARMAN_PACKED_ITERS)
SHARDED_PACKED_ITERS = {4: {"linear_iters": [3, 2, 3, 3, 3, 3],
                            "pressure_iters": [3, 3, 3, 3, 3, 3],
                            "correction_iters": [6, 6, 8, 8, 8, 8]}}
KARMAN_10M = dict(lcar=0.0175, n_refine=6)  # BENCH_LARGE.json's "10M"
KARMAN_10M_DOFS = 9894272
# phase 32, the DFG 2D-2 seeding route of scripts/schafer_turek.py: a
# coarse leg at SEEDED_LCAR and n_refine SEEDED_COARSE, its checkpoint
# prolonged one refine_uniform level, a fine leg there; the script's dt0,
# dt_max and perturbation amplitude, the bench's packed tolerances (the
# driver's GMRES momentum solve, as the script runs it)
SEEDED_LCAR = 0.03
SEEDED_COARSE = 3  # the fine leg runs at n_refine 4
SEEDED_STEPS = 6  # 1 warm-up + 5 timed, each leg
SEEDED_DT0 = 1e-4
SEEDED_DT_MAX = 4e-3
SEEDED_AMPLITUDE = 0.4
SEEDED_SETTINGS = dict(
    backend="packed", convection="lagged", time_step_method="bdf2",
    **{k: PACKED_SETTINGS[k] for k in ("newton_rtol", "linear_rtol", "pressure_rtol",
                                       "correction_rtol", "cfl_target")})
# the card-vs-CPU run of the route, float64: lcar=0.1 is the coarsest DFG
# mesh with a cylinder (at 0.2 none of its cells touches it, and the
# consistent force probe has no body dofs, in the JAX package too)
SEEDED_PARITY = dict(lcar=0.1, n_coarse=1)
# the fine leg's iterations a step on the card (H100 80GB HBM3, 700 W),
# pinned from the first run of this phase: the packed route sums in a fixed
# order, so the steps, and these counts, must not move
SEEDED_PACKED_ITERS = {"linear_iters": [48, 22, 22, 26, 28, 28],
                       "pressure_iters": [5, 5, 6, 6, 5, 6],
                       "correction_iters": [8, 8, 8, 8, 8, 8]}

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12  # float64 outside the tensor cores


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
        # ... and the 3-D Boussinesq packed route's grids, (N+1, N+1, 2N+1)
        # at N = 16, 14, 12 and 4 and their coarse levels
        ragged = [(17, 17, 17), (9, 9, 9), (5, 5, 5), (5, 6, 7), (2, 7, 9), (1, 4, 3),
                  (3, 1, 70), (1, 1, 1), (17, 17, 33), (9, 9, 17), (15, 15, 29),
                  (8, 8, 15), (13, 13, 25), (7, 7, 13), (5, 5, 9), (3, 3, 5)]
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

    # the correction substep: the window route's or the packed-patch
    # stepper's, FastStepper's packed layout's, or NSContext's on the
    # einsum route (and in patch mode)
    pressure = "_pressure_solve"
    if getattr(st, "pctx", None) is not None and st.packed:
        pressure, owner, name = "_pressure_solve_pk", st, "_correction_pk"
    elif getattr(st, "winkernel", True):
        owner, name = st, "_correction"
    else:
        owner, name = st.ctx, "velocity_correction"
    setattr(st, pressure, timed("pressure", getattr(st, pressure)))
    setattr(owner, name, timed("correction", getattr(owner, name)))
    try:
        timed("step", st._step_impl)(U, P, dt)
    finally:
        delattr(st, pressure)
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
    route), one step per chunk: 1 warm-up and 1 timed step. The pressure
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
    out = run_cavity3d_fast(num_steps=CAVITY3D_EINSUM_STEPS, n=CAVITY3D_MAIN, winkernel=False,
                            tangent_mode=CAVITY3D_TANGENT, chunk_size=1,
                            dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in counters.items()}
    launches["stencil3d by grid"] = dict(GRID_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    prob, st, tel = out["problem"], out["stepper"], out["telemetry"]
    n_dofs = 3 * prob.V.n_dofs + prob.Q.n_dofs
    timed = sum(out["chunk_seconds"][1:])
    n_timed = CAVITY3D_EINSUM_STEPS - 1
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


def _boussinesq_counts(tel):
    keys = ("heat_solver", "heat_iters", "newton_iters", "linear_iters",
            "pressure_iters", "correction_iters")
    return [tuple(r.get(k) for k in ("step", "sweep", "failed") + keys) for r in tel]


def phase_boussinesq_parity():
    """compute_boussinesq(backend="packed") in float64 on the card and on
    the CPU (dense and multigrid heat solves): equal counts a sweep, u
    within 1e-8 and theta within 1e-10 of their largest entries; Chorin, IPCS and
    Rotational one step each on the card and the CPU; the heat path's sums
    twice on the card, bitwise equal."""
    import torch
    import flow_tpu_torch as ft
    from flow_tpu_torch import heat, interop
    from flow_tpu_torch.models.boussinesq import compute_boussinesq

    for cfg in BOUSSINESQ_PARITY:
        runs = {}
        for device in ("cpu", "cuda"):
            tel = []
            t0 = time.perf_counter()
            u, _, th = compute_boussinesq(BOUSSINESQ_PARITY_TIME, backend="packed",
                                          device=device, telemetry=tel, **cfg)
            runs[device] = (u.vector.cpu(), th.vector.cpu(), _boussinesq_counts(tel),
                            time.perf_counter() - t0)
        (uc, thc, cc, sc), (ug, thg, cg, sg) = runs["cpu"], runs["cuda"]
        du = float((ug - uc).abs().max()) / float(uc.abs().max())
        dth = float((thg - thc).abs().max()) / float(thc.abs().max())
        log(f"[boussinesq-parity] {cfg} t={BOUSSINESQ_PARITY_TIME}: {len(cg)} sweeps, "
            f"rel |du|={du:.3e} |dtheta|={dth:.3e}; cpu {sc:.1f} s, cuda {sg:.1f} s")
        log(f"[boussinesq-parity] (step, sweep, failed, heat solver, heat its, picard, "
            f"gmres, pressure, correction) cuda={cg}")
        check(cg == cc, f"boussinesq parity {cfg}: counts differ (cuda {cg}, cpu {cc})")
        check(not any(c[2] for c in cg), f"boussinesq parity {cfg}: a sweep failed")
        # u is the small residue of buoyancy against the hydrostatic
        # pressure (rho g ~ 1e4 against |u| ~ 1e-5): the two sides' sums
        # differ in the last bits of those large terms, ~1e-9 of max|u|
        check(du <= 1e-8 and dth <= 1e-10,
              f"boussinesq parity {cfg}: u or theta differ ({du}, {dth})")
    check({c[3] for c in cg} == {"mg"}, "boussinesq parity: the heat solve is not on mg")

    # the public schemes on the einsum context, one step on each device
    for name, method in (("Chorin", None), ("IPCS", "backward euler"),
                         ("Rotational", "crank-nicolson")):
        out = {}
        for device in ("cpu", "cuda"):
            mesh = ft.unit_square_mesh(16, dtype=torch.float64, device=device)
            V, Q = ft.VectorFunctionSpace(mesh, 2), ft.FunctionSpace(mesh, 1)
            bcs = [ft.DirichletBC(V.sub(0), lambda x: np.where(x[:, 1] > 1 - 1e-12, 1.0, 0.0)),
                   ft.DirichletBC(V.sub(1), 0.0)]
            s = getattr(ft.navier_stokes, name)(**({} if method is None else
                                                    {"time_step_method": method}))
            u1, _ = s.step(0.05, {0: ft.project((0.0, 0.0), V)}, ft.project(0.0, Q), bcs,
                           [], 1.0, 0.02, f={0: (0.0, -1.0), 1: (0.0, -1.0)},
                           verbose=False)
            out[device] = (u1.vector.cpu(), dict(s.last_stats))
        du = float((out["cuda"][0] - out["cpu"][0]).abs().max())
        counts = {d: [out[d][1][k] for k in ("newton_iters", "pressure_iters",
                                             "correction_iters")] for d in out}
        log(f"[boussinesq-parity] {name} one step: counts cuda={counts['cuda']} "
            f"cpu={counts['cpu']} max|du|={du:.3e}")
        check(counts["cuda"] == counts["cpu"], f"{name}: counts differ {counts}")
        check(du <= 1e-10, f"{name}: u differs by {du}")

    # the heat path's sums repeat bitwise on the card
    mesh = ft.rectangle_with_hole_mesh(0.0, 0.1, 0.0, 0.2, cx=0.05, cy=0.05, r=0.02,
                                       lcar=0.03, dtype=torch.float64, device="cuda")
    meshes = [mesh]
    for _ in range(3):
        meshes.append(ft.refine_uniform(meshes[-1]))
    Q = ft.FunctionSpace(meshes[-1], 2)
    W = ft.VectorFunctionSpace(meshes[-1], 2)
    rng = np.random.default_rng(0)
    conv = interop.function_to_torch(W, 1e-3 * rng.standard_normal((W.n_dofs, 2)))
    bcs = [ft.DirichletBC(Q, 1.0)]
    op = heat.Heat(Q, conv, 0.6, 1000.0, 4000.0, bcs, 1.0, supg_stabilization=True,
                   mesh_hierarchy=meshes)
    x = torch.as_tensor(rng.standard_normal(Q.n_dofs), device="cuda")
    hier = op._mg_hierarchy()
    r = torch.as_tensor(rng.standard_normal(hier.levels[-1].n), device="cuda")
    for what, fn in (("A apply", lambda: op.A_apply(x)), ("M apply", lambda: op.M_apply(x)),
                     ("load vector", lambda: heat.Heat(Q, conv, 0.6, 1000.0, 4000.0, bcs,
                                                       1.0).b_vec),
                     ("restriction", lambda: hier.restrict(hier.nlevels - 2, r)),
                     ("V-cycle", lambda: hier.v_cycle(r, 50.0, 1.0))):
        check(torch.equal(fn(), fn()), f"boussinesq: the heat {what} does not repeat bitwise")
    log("[boussinesq-parity] heat A/M applies, load vector, restriction and V-cycle "
        "repeat bitwise on the card")


def _profile_split(fn):
    """(device events, launch calls, device ms, the ten aten ops with the
    most device time) of one call of fn."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    cuda = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    calls = sum(1 for e in events if e.name in ("cudaLaunchKernel", "cuLaunchKernel",
                                                "cudaLaunchKernelExC"))
    ms = sum(e.device_time_total for e in cuda) / 1e3
    top = sorted(((a.key, a.self_device_time_total / 1e3, a.count)
                  for a in prof.key_averages()
                  if a.key.startswith("aten::") and a.self_device_time_total > 0),
                 key=lambda t: -t[1])[:10]
    return len(cuda), calls, ms, top


def phase_boussinesq_main():
    """The coupled driver at 2,484,096 DoF in float64 on the packed route,
    from rest to BOUSSINESQ_MAIN_TIME, then one coupled sweep profiled."""
    import torch
    import flow_tpu_torch as ft
    from flow_tpu_torch import heat, materials, parabolic
    from flow_tpu_torch.models.boussinesq import _cool, _hot, buoyancy_function, \
        compute_boussinesq, rho_of_theta
    from flow_tpu_torch.navier_stokes.packedapi import mesh_hierarchy_of

    hand = _hand_kernels()
    for k in hand.values():
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    tel = []
    t0 = time.perf_counter()
    u, p, th = compute_boussinesq(BOUSSINESQ_MAIN_TIME, device="cuda",
                                  dtype=torch.float64, telemetry=tel, **BOUSSINESQ_MAIN)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    launches = {name: k.launches for name, k in hand.items()}
    V, P, Q = u.space, p.space, th.space
    dofs = {"velocity": 2 * V.n_dofs, "pressure": P.n_dofs, "temperature": Q.n_dofs}
    dofs["coupled"] = sum(dofs.values())
    log(f"[boussinesq] {BOUSSINESQ_MAIN} float64 t={BOUSSINESQ_MAIN_TIME}: dofs {dofs}")
    check(dofs == BOUSSINESQ_DOFS, f"boussinesq: dofs {dofs}, not {BOUSSINESQ_DOFS}")
    st = next(iter(V._packed_api_cache.values()))
    hiers = list(Q.mesh._heat_mg_cache.values())
    sweeps = sum(r["heat_seconds"] + r["ns_seconds"] for r in tel if "failed" not in r)
    setup = {"mesh, spaces, projections and loop": total - sweeps,
             "packed stepper (in the first NS step)": st.setup_seconds["total"],
             "heat hierarchies (in heat solves)": sum(h.setup_seconds for h in hiers)}
    log("[boussinesq] setup s: " + ", ".join(f"{k}={v:.2f}" for k, v in setup.items())
        + f"; {len(hiers)} heat hierarchies of levels {[L.n for L in hiers[0].levels]}; "
        "packed stepper "
        + ", ".join(f"{k}={v:.2f}" for k, v in st.setup_seconds.items()))
    counts = _boussinesq_counts(tel)
    log("[boussinesq] (step, sweep, failed, heat solver, heat its, picard, gmres, "
        f"pressure, correction): {counts}")
    steps = sorted({r["step"] for r in tel})
    for s in steps:
        rows = [r for r in tel if r["step"] == s]
        heat_s = sum(r["heat_seconds"] for r in rows)
        ns_s = sum(r["ns_seconds"] for r in rows)
        log(f"[boussinesq] step {s}: t={rows[0]['t']:.6g} dt={rows[0]['dt']:.6g} "
            f"sweeps={len(rows)} s={heat_s + ns_s:.3f} (heat {heat_s:.3f}, NS {ns_s:.3f}) "
            f"heat its/sweep={[r['heat_iters'] for r in rows]}")
    later = [r for r in tel if r["step"] >= 1]
    n_later = len(steps) - 1
    per_step = sum(r["heat_seconds"] + r["ns_seconds"] for r in later) / max(n_later, 1)
    log(f"[boussinesq] seconds a coupled step after the first: {per_step:.4f} "
        f"(heat {sum(r['heat_seconds'] for r in later) / max(n_later, 1):.4f}, NS "
        f"{sum(r['ns_seconds'] for r in later) / max(n_later, 1):.4f}) over {n_later} "
        f"steps; total {total:.1f} s")
    nu, nth = ft.norm(u), ft.norm(th)
    log(f"[boussinesq] ||u||_L2={nu:.10e} ||theta||_L2={nth:.10e} peak_mem_bytes={peak} "
        f"(above the {base} bytes earlier phases hold) hand-kernel launches={launches}")
    check(not any(r.get("failed") for r in tel), "boussinesq: a sweep failed")
    check(all(r["heat_solver"] == "mg" for r in tel), "boussinesq: a heat solve is not mg")
    check(bool(torch.isfinite(u.vector).all()) and bool(torch.isfinite(th.vector).all()),
          "boussinesq: non-finite state")
    check(np.isfinite(nu) and 0.0 <= nu < 1e-3 and 39.0 < nth < 41.0,
          f"boussinesq: norms out of range ({nu}, {nth})")
    check(not any(launches.values()), f"boussinesq: a hand kernel was launched: {launches}")
    check(counts == BOUSSINESQ_PACKED_ITERS,
          f"boussinesq: counts {counts} are not BOUSSINESQ_PACKED_ITERS' "
          f"{BOUSSINESQ_PACKED_ITERS}")

    # one coupled sweep (the heat solve, then the NS step) under the
    # profiler, from the final state, through the driver's entry points
    room, t, dt = 293.0, tel[-1]["t"], tel[-1]["dt"]
    rho = materials.water.density
    heater = room + min(1.0, t / 30.0) * (320.0 - room)
    bcs = [ft.DirichletBC(Q, heater, _hot), ft.DirichletBC(Q, room, _cool)]

    chain = mesh_hierarchy_of(Q.mesh)

    def heat_op():
        return heat.Heat(Q, u, float(materials.water.thermal_conductivity(room)),
                         float(rho(room)), float(materials.water.specific_heat_capacity(room)),
                         bcs, 0.0, mesh_hierarchy=chain)

    op = heat_op()
    hier = op._mg_hierarchy()  # built outside the profile if this state needs another
    r = torch.ones(hier.levels[-1].n, dtype=torch.float64, device="cuda")

    fb = buoyancy_function(rho_of_theta(th, rho), -9.81, V)
    Uf, Pf = st.to_packed_state(u.vector, p.vector)
    Ff = st.pack_vec(fb.vector)
    # the heat sweep in its parts: the operator's assembly (forms, the
    # convection at the quadrature points, the BCs), the implicit Euler
    # solve on that operator (its load vector and the MG-GMRES loop), and
    # one V-cycle alone
    rows = {"heat assembly": _profile_split(heat_op),
            "heat solve": _profile_split(
                lambda: parabolic.ImplicitEuler(op).step(th, t, dt)),
            "V-cycle": _profile_split(lambda: hier.v_cycle(r, 1.0 / dt, 1.0)),
            "NS step": _profile_split(lambda: st.step_api(Uf, Pf, dt, Ff))}
    its = op.last_solve["iters"]
    for what, (n_ev, n_calls, ms, top) in rows.items():
        log(f"[boussinesq] {what} (profiled, the last sweep's state): {n_ev} device "
            f"events, {n_calls} launch calls, {ms:.2f} device ms; "
            "top aten ops by device ms (calls): "
            + ", ".join(f"{k[6:]} {v:.2f} ({c})" for k, v, c in top))
    # the idle shares against the last sweep's unprofiled seconds: its heat
    # part is the assembly and the solve
    heat_ms = rows["heat assembly"][2] + rows["heat solve"][2]
    log(f"[boussinesq] idle: heat (assembly and solve) "
        f"{1.0 - heat_ms / 1e3 / tel[-1]['heat_seconds']:.3f} of the unprofiled "
        f"{tel[-1]['heat_seconds']:.3f} s; NS step "
        f"{1.0 - rows['NS step'][2] / 1e3 / tel[-1]['ns_seconds']:.3f} of "
        f"{tel[-1]['ns_seconds']:.3f} s")
    log(f"[boussinesq] the profiled heat solve took {its} GMRES iterations: "
        f"{rows['heat solve'][1] / max(its, 1):.1f} launch calls an iteration "
        f"(its load vector and true residual included), "
        f"{rows['V-cycle'][1]} a V-cycle")
    return counts


# -- steady Stokes and the paths that start from it, and the 3-D driver -------
_PI = np.pi


def _host_field(fn):
    """A field of host points [..., 2] as a callable of host points or
    tensors (the BCs evaluate on the host, the forcing at the quadrature
    points on the mesh's device)."""
    import torch

    def f(x):
        if isinstance(x, torch.Tensor):
            return torch.as_tensor(fn(x.cpu().numpy()), dtype=x.dtype, device=x.device)
        return fn(x)

    return f


# Guermond1 with mu = 1 (tests/test_stokes.py), written out
GUERMOND_U = (
    _host_field(lambda x: _PI * np.sin(2 * _PI * x[..., 1]) * np.sin(_PI * x[..., 0]) ** 2),
    _host_field(lambda x: -_PI * np.sin(2 * _PI * x[..., 0]) * np.sin(_PI * x[..., 1]) ** 2))
GUERMOND_P = _host_field(lambda x: np.cos(_PI * x[..., 0]) * np.sin(_PI * x[..., 1]))
GUERMOND_F = (
    _host_field(lambda x: -2 * _PI**3 * np.sin(2 * _PI * x[..., 1])
                * (1 - 4 * np.sin(_PI * x[..., 0]) ** 2)
                - _PI * np.sin(_PI * x[..., 0]) * np.sin(_PI * x[..., 1])),
    _host_field(lambda x: 2 * _PI**3 * np.sin(2 * _PI * x[..., 0])
                * (1 - 4 * np.sin(_PI * x[..., 1]) ** 2)
                + _PI * np.cos(_PI * x[..., 0]) * np.cos(_PI * x[..., 1])))


def phase_stokes_parity():
    """stokes.solve on Guermond1 at n = STOKES_PARITY_N on the MINRES path
    (DENSE_THRESHOLD = 0, rtol STOKES_PARITY_RTOL) in float64 on the CPU
    and on the card, the CPU's
    lambda_max carried over: equal iterations, u within 1e-9 and p within
    1e-7 of their largest entries (the solve's own error against the dense
    LU), the card's solve bitwise equal when repeated, and the
    discretisation errors of the MMS solution on both."""
    import torch
    import flow_tpu_torch as ft
    from flow_tpu_torch import stokes

    orig_threshold, orig_lmax = stokes.DENSE_THRESHOLD, stokes.power_iteration_lmax
    seen = {}

    def lmax(*a, **k):
        if "lmax" not in seen:
            seen["lmax"] = orig_lmax(*a, **k)
        return seen["lmax"]

    stokes.DENSE_THRESHOLD, stokes.power_iteration_lmax = 0, lmax
    try:
        runs = []  # the CPU's, the card's, the card's again
        for device in ("cpu", "cuda", "cuda"):
            mesh = ft.unit_square_mesh(STOKES_PARITY_N, diagonal="left/right",
                                       dtype=torch.float64, device=device)
            WP = stokes.TaylorHood(mesh)
            bcs = [ft.DirichletBC(WP.sub(0), GUERMOND_U),
                   ft.DirichletBC(WP.sub(1), GUERMOND_P)]
            t0 = time.perf_counter()
            u, p = stokes.solve(WP, bcs, 1.0, GUERMOND_F, verbose=False,
                                tol=STOKES_PARITY_RTOL, max_iter=3000)
            secs = time.perf_counter() - t0
            row = (u, p, dict(stokes.last_info), secs,
                   ft.errornorm(GUERMOND_U, u), ft.errornorm(GUERMOND_P, p))
            runs.append(row)
    finally:
        stokes.DENSE_THRESHOLD, stokes.power_iteration_lmax = orig_threshold, orig_lmax
    (uc, pc, ic, sc, euc, epc), (ug, pg, ig, sg, eug, epg), (ug2, _, ig2, _, _, _) = runs
    du = float((ug.vector.cpu() - uc.vector).abs().max()) / float(uc.vector.abs().max())
    dp = float((pg.vector.cpu() - pc.vector).abs().max()) / float(pc.vector.abs().max())
    log(f"[stokes-parity] Guermond1 n={STOKES_PARITY_N} MINRES float64: iters cuda="
        f"{ig['iters']} cpu={ic['iters']} (cuda again {ig2['iters']}), residual cuda "
        f"{ig['resnorm']:.3e} cpu {ic['resnorm']:.3e}; rel |du|={du:.3e} |dp|={dp:.3e}; "
        f"L2 errors u {eug:.6e}/{euc:.6e} p {epg:.6e}/{epc:.6e} (cuda/cpu); "
        f"s cuda {sg:.2f} cpu {sc:.2f}")
    check(ig["solver"] == "minres" and ig["iters"] == ic["iters"] == ig2["iters"],
          f"stokes parity: iterations differ ({ig}, {ic}, {ig2})")
    # the solve stops at rtol 3e-9; its own error against the dense LU is
    # 5.0e-10 (u) and 1.15e-7 (p) of the largest entries on the CPU, and
    # the two sides' roundoff moves the iterate by less than that
    check(du <= 1e-9 and dp <= 1e-7, f"stokes parity: u or p differ ({du}, {dp})")
    check(torch.equal(ug.vector, ug2.vector), "stokes parity: the card's solve does not repeat")
    check(eug < 1e-2 and epg < 1e-1, f"stokes parity: MMS errors too large ({eug}, {epg})")


def phase_karman_bootstrap(prob_f32):
    """Path A: run_karman_fast(backend="packed", from_rest=False) at the
    Karman main path's mesh. Each (dtype, n_refine) of KARMAN_BOOTSTRAP_RUNS
    but the last takes the driver's bootstrap call (MINRES, rtol 1e-6, 2000
    at most) alone and must raise as pinned; the last runs the driver, 1 + 5
    steps, one a chunk. Returns the converged run's problem (for the launches
    a MINRES iteration, profiled last)."""
    import torch
    from flow_tpu_torch import stokes
    from flow_tpu_torch.models.karman import KarmanProblem, run_karman_fast

    hand = _hand_kernels()
    rows, out, prob = [], None, None
    for i, (dtype_name, n_refine) in enumerate(KARMAN_BOOTSTRAP_RUNS):
        dtype = getattr(torch, dtype_name)
        last = i == len(KARMAN_BOOTSTRAP_RUNS) - 1
        t0 = time.perf_counter()
        if dtype == torch.float32 and n_refine == KARMAN_MAIN["n_refine"]:
            prob = prob_f32
        else:
            prob = KarmanProblem(lcar=KARMAN_MAIN["lcar"], n_refine=n_refine, dtype=dtype,
                                 device="cuda")
        torch.cuda.synchronize()
        t_prob = time.perf_counter() - t0
        for k in hand.values():
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        if not last:
            try:
                prob.stokes_bootstrap(tol=1.0e-6, max_iter=2000)
                converged = True
            except RuntimeError:  # the pinned outcome, checked below
                converged = False
            torch.cuda.synchronize()
            info = dict(stokes.last_info, seconds=time.perf_counter() - t0)
        else:
            out = run_karman_fast(num_steps=PACKED_STEPS, chunk_size=1, backend="packed",
                                  convection="lagged", problem=prob, from_rest=False)
            torch.cuda.synchronize()
            info, converged = out["bootstrap"], True
        peak = torch.cuda.max_memory_allocated() - base
        launches = {name: k.launches for name, k in hand.items()}
        log(f"[bootstrap] {dtype_name} lcar={KARMAN_MAIN['lcar']} n_refine={n_refine} "
            f"n_dofs={prob.n_dofs}: MINRES iters={info['iters']} true residual "
            f"{info['resnorm']:.6e} converged={converged} solve s={info['seconds']:.3f} "
            f"(problem setup {t_prob:.1f} s) peak_mem_bytes={peak} (above {base})")
        check(not any(launches.values()), f"bootstrap: a hand kernel was launched: {launches}")
        rows.append((dtype_name, n_refine, info["iters"], converged))
        if not last:
            del prob
            torch.cuda.empty_cache()
    tel = out["telemetry"]
    timed = sum(out["chunk_seconds"][1:])
    log(f"[bootstrap] the driver from the bootstrap: steps/s={(PACKED_STEPS - 1) / timed:.4f} "
        f"(after 1 warm-up step of {out['chunk_seconds'][0]:.3f} s)")
    for k in ("dt", "linear_iters", "pressure_iters", "correction_iters"):
        log(f"[bootstrap] {k}: {tel[k].tolist()}")
    log(f"[bootstrap] drag: {tel['forces'][:, 0].tolist()}")
    U, P = out["u"], out["p"]
    check(bool(torch.isfinite(U).all()) and bool(torch.isfinite(P).all()),
          "bootstrap: non-finite state")
    check(np.isfinite(tel["forces"]).all() and tel["forces"][-1, 0] > 0,
          "bootstrap: non-finite forces or a last drag <= 0")
    for key in ("pressure_converged", "correction_converged"):
        check(bool(np.all(tel[key])), f"bootstrap: a {key.split('_')[0]} solve did not converge")
    log(f"[bootstrap] runs (dtype, n_refine, MINRES iters, converged): {rows}")
    check(rows == KARMAN_BOOTSTRAP_ITERS,
          f"bootstrap: runs {rows} are not KARMAN_BOOTSTRAP_ITERS' {KARMAN_BOOTSTRAP_ITERS}")
    return prob


def _minres_launches(prob):
    """Launch calls of one MINRES iteration of prob's bootstrap solve, from
    torch.profiler: (solve capped at 20 iterations - capped at 10) / 10."""
    from flow_tpu_torch import stokes

    def capped(n):
        def run():
            try:
                stokes.solve(prob.WP, prob.u_bcs, prob.mu, (0.0, 0.0), verbose=False,
                             tol=1.0e-6, max_iter=n)
            except RuntimeError:  # the cap, as asked for
                pass
        return _profiled_launches(run)

    (ev10, calls10), (ev20, calls20) = capped(10), capped(20)
    return (ev20 - ev10) / 10, (calls20 - calls10) / 10


def phase_boussinesq3d_parity():
    """compute_boussinesq_3d in float64 on the card and on the CPU at
    BOUSSINESQ3D_PARITY (both routes): equal counts a sweep, u within 1e-8
    and theta within 1e-10 of their largest entries; K1 launched on the
    packed route only."""
    import torch
    from flow_tpu_torch.models.boussinesq3d import compute_boussinesq_3d
    from flow_tpu_torch.ops.stencil import STENCIL_3D

    for cfg in BOUSSINESQ3D_PARITY:
        runs = {}
        for device in ("cpu", "cuda"):
            tel = []
            STENCIL_3D.launches = 0
            t0 = time.perf_counter()
            u, _, th = compute_boussinesq_3d(device=device, telemetry=tel, **cfg)
            runs[device] = (u.vector.cpu(), th.vector.cpu(), _boussinesq_counts(tel),
                            time.perf_counter() - t0, STENCIL_3D.launches)
        (uc, thc, cc, sc, _), (ug, thg, cg, sg, k1) = runs["cpu"], runs["cuda"]
        du = float((ug - uc).abs().max()) / max(float(uc.abs().max()), 1e-30)
        dth = float((thg - thc).abs().max()) / float(thc.abs().max())
        log(f"[boussinesq3d-parity] {cfg}: {len(cg)} sweeps, max|u| "
            f"{float(uc.abs().max()):.3e}, rel |du|={du:.3e} |dtheta|={dth:.3e}; K1 "
            f"launches {k1}; cpu {sc:.1f} s, cuda {sg:.1f} s; counts cuda={cg}")
        check(cg == cc, f"boussinesq3d parity {cfg}: counts differ (cuda {cg}, cpu {cc})")
        check(not any(c[2] for c in cg), f"boussinesq3d parity {cfg}: a sweep failed")
        check((float((ug - uc).abs().max()) <= 1e-8 * max(float(uc.abs().max()), 1e-8))
              and dth <= 1e-10, f"boussinesq3d parity {cfg}: u or theta differ ({du}, {dth})")
        check((k1 > 0) == (cfg["backend"] == "packed"),
              f"boussinesq3d parity {cfg}: K1 launches {k1}")
    check(any(c[5] for c in cg), "boussinesq3d parity: the moving run took no Picard step")


def _boussinesq3d_report(tag, tel, total, peak, dofs):
    steps = sorted({r["step"] for r in tel})
    for s in steps:
        rows = [r for r in tel if r["step"] == s]
        heat_s = sum(r.get("heat_seconds", 0.0) for r in rows)
        ns_s = sum(r.get("ns_seconds", 0.0) for r in rows)
        lu = [round(r["heat_factor_seconds"], 3) for r in rows if "heat_factor_seconds" in r]
        log(f"[{tag}] step {s}: t={rows[0]['t']:.6g} dt={rows[0]['dt']:.6g} sweeps="
            f"{len(rows)} s={heat_s + ns_s:.3f} (heat {heat_s:.3f}"
            + (f", of it splu factor {lu}" if lu else "") + f"; NS {ns_s:.3f}) heat its/sweep="
            f"{[r.get('heat_iters') for r in rows]}")
    sweeps = sum(r.get("heat_seconds", 0.0) + r.get("ns_seconds", 0.0) for r in tel)
    log(f"[{tag}] dofs {dofs}; total {total:.1f} s, of it sweeps {sweeps:.1f} s and setup "
        f"(mesh, spaces, projections, stepper or hierarchy in the first sweep's parts) "
        f"{total - sweeps:.1f} s; peak_mem_bytes={peak}")


def _dofs3d(u, p, th):
    dofs = {"velocity": 3 * u.space.n_dofs, "pressure": p.space.n_dofs,
            "temperature": th.space.n_dofs}
    dofs["coupled"] = sum(dofs.values())
    return dofs


def phase_boussinesq3d_packed():
    """Path B: compute_boussinesq_3d(backend="packed") at BOUSSINESQ3D_PACKED
    in float64 from rest to BOUSSINESQ3D_PACKED_TIME: the NS step on the box
    stepper (K1: the pressure operator, every V-cycle level), the heat on
    the host splu every sweep. Returns K1's launches by grid and the f64
    launches of those grids for their device times (taken last)."""
    import torch
    from flow_tpu_torch.models.boussinesq3d import compute_boussinesq_3d
    from flow_tpu_torch.ops import stencil

    hand = _hand_kernels()
    for k in hand.values():
        k.launches = 0
    stencil.GRID_LAUNCHES.clear()

    class SweepLaunches(list):
        """The telemetry list, each sweep's row stamped with K1's launches by
        grid so far (a row is appended after the sweep's NS step)."""

        def append(self, row):
            super().append(dict(row, k1_by_grid=dict(stencil.GRID_LAUNCHES)))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    tel = SweepLaunches()
    t0 = time.perf_counter()
    u, p, th = compute_boussinesq_3d(BOUSSINESQ3D_PACKED_TIME, device="cuda",
                                     dtype=torch.float64, telemetry=tel, **BOUSSINESQ3D_PACKED)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    launches = {name: k.launches for name, k in hand.items()}
    by_grid = dict(stencil.GRID_LAUNCHES)
    dofs = _dofs3d(u, p, th)
    _boussinesq3d_report("boussinesq3d-packed", tel, total, peak, dofs)
    counts = _boussinesq_counts(tel)
    log(f"[boussinesq3d-packed] {BOUSSINESQ3D_PACKED} (step, sweep, failed, heat solver, "
        f"heat its, picard, bicgstab, pressure, correction): {counts}")
    log(f"[boussinesq3d-packed] K1 launches {launches['STENCIL_3D']} by grid {by_grid}; "
        f"hand-kernel launches {launches}")
    prev, sweep_k1 = {}, []
    for r in tel:
        now = r["k1_by_grid"]
        sweep_k1.append({g: now[g] - prev.get(g, 0) for g in now if now[g] > prev.get(g, 0)})
        prev = now
    log("[boussinesq3d-packed] K1 launches a sweep by grid (step, sweep): "
        + "; ".join(f"({r['step']}, {r['sweep']}) {k}" for r, k in zip(tel, sweep_k1)))
    last = max(r["step"] for r in tel)
    moving = [(c, k) for r, c, k in zip(tel, counts, sweep_k1) if r["step"] == last]
    check(all(c[5] > 0 and c[6] > 0 and c[7] > 0 and sum(k.values()) > 0 for c, k in moving),
          f"boussinesq3d packed: the last step does not move the fluid through K1: {moving}")
    check(dofs == BOUSSINESQ3D_PACKED_DOFS, f"boussinesq3d packed: dofs {dofs}")
    check(len(counts) >= 2 and not any(c[2] for c in counts),
          "boussinesq3d packed: fewer than two sweeps, or a failed one")
    check(all(c[3] == "splu" for c in counts), "boussinesq3d packed: a heat solve off splu")
    check(launches["STENCIL_3D"] > 0 and sum(by_grid.values()) == launches["STENCIL_3D"],
          "boussinesq3d packed: no K1 launch, or its launches by grid do not add up")
    check(not any(v for k, v in launches.items() if k != "STENCIL_3D"),
          f"boussinesq3d packed: another hand kernel was launched: {launches}")
    check(bool(torch.isfinite(u.vector).all()) and bool(torch.isfinite(th.vector).all()),
          "boussinesq3d packed: non-finite state")
    check(counts == BOUSSINESQ3D_PACKED_ITERS,
          f"boussinesq3d packed: counts {counts} are not BOUSSINESQ3D_PACKED_ITERS' "
          f"{BOUSSINESQ3D_PACKED_ITERS}")
    # K1 in float64 at the path's grids, as StructuredLaplacian launches it
    rng = np.random.default_rng(0)
    jobs = {}
    for grid in by_grid:
        k = torch.as_tensor(rng.standard_normal((3, 3, 3)), device="cuda")
        x = torch.as_tensor(rng.standard_normal(int(np.prod(grid))), device="cuda")
        launch = stencil.StencilLaunch(k, grid)
        check(torch.equal(launch(x).reshape(grid),
                          stencil.stencil_apply_3d(x.reshape(grid), k)),
              f"boussinesq3d packed: StencilLaunch differs at {grid}")
        jobs[grid] = lambda launch=launch, x=x: launch(x)
    return by_grid, jobs


def _stencil_bound64(shape):
    """K1's bound in float64: x read and y written once, 54 operations a
    point at the float64 peak."""
    n = int(np.prod(shape))
    t_bytes = (2 * 8 * n + 8 * 27) / HBM_BYTES_PER_S
    t_ops = 2 * 27 * n / F64_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops)


def phase_boussinesq3d_mg():
    """Path C: compute_boussinesq_3d(backend=None) at BOUSSINESQ3D_MG in
    float64 from rest to BOUSSINESQ3D_MG_TIME: Rotational on the twice
    refined tets, the heat solve by MG-GMRES on the shifted P1 hierarchy
    (its extra level the refinement of the finest mesh). No hand kernel
    runs on this route."""
    import torch
    from flow_tpu_torch.models.boussinesq3d import compute_boussinesq_3d

    hand = _hand_kernels()
    for k in hand.values():
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    tel = []
    t0 = time.perf_counter()
    u, p, th = compute_boussinesq_3d(BOUSSINESQ3D_MG_TIME, device="cuda",
                                     dtype=torch.float64, telemetry=tel, **BOUSSINESQ3D_MG)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    launches = {name: k.launches for name, k in hand.items()}
    dofs = _dofs3d(u, p, th)
    hiers = list(th.space.mesh._heat_mg_cache.values())
    _boussinesq3d_report("boussinesq3d-mg", tel, total, peak, dofs)
    counts = _boussinesq_counts(tel)
    log(f"[boussinesq3d-mg] {BOUSSINESQ3D_MG} heat hierarchy levels "
        f"{[L.n for L in hiers[0].levels]} (setup {hiers[0].setup_seconds:.2f} s); "
        f"(step, sweep, failed, heat solver, heat its, newton, -, pressure, correction): "
        f"{counts}")
    check(dofs == BOUSSINESQ3D_MG_DOFS, f"boussinesq3d mg: dofs {dofs}")
    check(counts and not any(c[2] for c in counts), "boussinesq3d mg: a sweep failed")
    check(all(c[3] == "mg" for c in counts), "boussinesq3d mg: a heat solve off the multigrid")
    check(not any(launches.values()), f"boussinesq3d mg: a hand kernel was launched: {launches}")
    check(bool(torch.isfinite(u.vector).all()) and bool(torch.isfinite(th.vector).all()),
          "boussinesq3d mg: non-finite state")
    check(counts == BOUSSINESQ3D_MG_ITERS,
          f"boussinesq3d mg: counts {counts} are not BOUSSINESQ3D_MG_ITERS' "
          f"{BOUSSINESQ3D_MG_ITERS}")


# -- FastStepper's other routes (PR 16): parity, DiffStepper, patch mode, 7.6M --
def _fast_stepper(prob, options, lmax=None):
    """FastStepper on `prob` with FAST_PARITY_SETTINGS and `options` (patches=
    True builds the patch layout) and its pressure V-cycle (P1Hierarchy, or
    PatchP1Hierarchy in patch mode), lambda_max carried in `lmax`."""
    from flow_tpu_torch import interop
    from flow_tpu_torch.fem.patch import build_patch_info
    from flow_tpu_torch.navier_stokes.fast import FastStepper
    from flow_tpu_torch.solvers.multigrid import P1Hierarchy
    from flow_tpu_torch.solvers.patch_mg import PatchP1Hierarchy

    kw = dict(FAST_PARITY_SETTINGS, **options)
    info = build_patch_info(prob.mesh_hierarchy) if kw.pop("patches", False) else None
    st = FastStepper(prob.V, prob.Q, prob.u_bcs, prob.p_bcs, prob.rho, prob.mu,
                     patches=info, forces_probe=prob.consistent_force_probe(), **kw)
    if info is not None:
        hier = PatchP1Hierarchy(info, bc_mask=st.mask_p, smoother_degree=3)
    else:
        hier = P1Hierarchy(prob.mesh_hierarchy, bc_mask=st.mask_p, smoother_degree=3)
    if lmax is not None:
        interop.load_hierarchy_lmax(hier, lmax)
    st.pressure_precond = hier.v_cycle
    return st, hier


def phase_fast_parity():
    """FastStepper's options of this slice at KarmanProblem(lcar=0.2,
    n_refine=2) in float64, 3 steps from dt0 = 1e-4 on the card and on the
    CPU, lambda_max carried across: the packed layout, patch mode, GMRES
    momentum, forward Euler, the assembled Newton Jacobian, the lagged ELL
    operator, the vertex preconditioner and the divergence probe. Equal
    per-step counts; U, P within 1e-8, the forces (and div_norm) within
    1e-8 of their largest entries."""
    import torch
    from flow_tpu_torch.models.karman import KarmanProblem

    probs = {d: KarmanProblem(dtype=torch.float64, device=d, **EINSUM_PARITY)
             for d in ("cpu", "cuda")}
    for name, options in FAST_PARITY_OPTIONS.items():
        runs, lmax = {}, None
        for device in ("cpu", "cuda"):
            st, hier = _fast_stepper(probs[device], options, lmax=lmax)
            lmax = [L.lmax for L in hier.levels]
            U, P, _, tel = st.run(*st.zeros(), KARMAN_DT0, 3)
            _check_solves(tel, f"fast-parity {name} ({device})")
            runs[device] = (U.cpu(), P.cpu(), {k: v.cpu() for k, v in tel.items()}, st)
        (U_c, P_c, tel_c, st_c), (U_g, P_g, tel_g, st_g) = runs["cpu"], runs["cuda"]
        counts = {}
        for key in ("newton_iters", "linear_iters", "pressure_iters", "correction_iters"):
            a, b = tel_g[key].tolist(), tel_c[key].tolist()
            counts[key] = a
            check(a == b, f"fast parity {name}: {key} differ (cuda {a}, cpu {b})")
        du = float((U_g - U_c).abs().max())
        dp = float((P_g - P_c).abs().max())
        F_c, F_g = tel_c["forces"].numpy(), tel_g["forces"].numpy()
        df = float(np.abs(F_g - F_c).max() / np.abs(F_c).max())
        extra = ""
        if "div_norm" in tel_c:
            dd = float((tel_g["div_norm"] - tel_c["div_norm"]).abs().max()
                       / tel_c["div_norm"].abs().max())
            extra = f" div_norm {tel_g['div_norm'].tolist()} rel {dd:.3e}"
            check(dd <= 1e-8, f"fast parity {name}: div_norm differs by {dd}")
        layout = ("packed" if st_g.packed else "patch" if st_g.patch else "dense")
        log(f"[fast-parity] {name} ({layout}, {st_g.mom_solver}, theta={st_g.theta}): "
            f"{counts} max|dU|={du:.3e} max|dP|={dp:.3e} (max|P| "
            f"{float(P_c.abs().max()):.3e}) forces rel {df:.3e}{extra}")
        check(du <= 1e-8 and dp <= 1e-8 and df <= 1e-8,
              f"fast parity {name}: U, P or the forces differ ({du}, {dp}, {df})")
        check(max(counts["linear_iters"]) > 0, f"fast parity {name}: no momentum iteration")
        check((name == "packed") == st_g.packed and (name == "patches") == st_g.patch,
              f"fast parity {name}: the layout is {layout}")


def phase_diffstep():
    """DiffStepper at KarmanProblem(lcar=0.2, n_refine=2) in float64: the
    gradient of a DIFF_STEPS-step rollout's loss (sum U^2 + 0.1 sum P^2)
    with respect to mu and U0, on the card and on the CPU (agree within
    1e-8 relative), each against a central finite difference (mu: rel
    2e-5, step 1e-3 mu; U0 along a random free-dof direction: rel 5e-6)."""
    import torch
    from flow_tpu_torch.models.karman import KarmanProblem
    from flow_tpu_torch.navier_stokes import DiffStepper

    out = {}
    dt = 1e-3
    for device in ("cpu", "cuda"):
        prob = KarmanProblem(dtype=torch.float64, device=device, **EINSUM_PARITY)
        ds = DiffStepper(prob.V, prob.Q, prob.u_bcs, prob.p_bcs, rho=prob.rho,
                         mu=prob.mu, rotational_form=True)
        st = ds.st

        def loss(U, mu):
            U1, P1 = ds.rollout(U, st.zeros()[1], dt, DIFF_STEPS, mu=mu)
            return (U1 * U1).sum() + 0.1 * (P1 * P1).sum()

        U0 = st.zeros()[0]
        t0 = time.perf_counter()
        mu = st._scalar(prob.mu).requires_grad_(True)
        U = U0.clone().requires_grad_(True)
        g_mu, g_U = torch.autograd.grad(loss(U, mu), (mu, U))
        if device == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        rng = np.random.default_rng(3)
        v = (1.0 - st.mask_u) * torch.as_tensor(rng.standard_normal(tuple(U0.shape)),
                                                 device=U0.device)
        with torch.no_grad():
            h = 1e-3 * prob.mu
            fd_mu = float(loss(U0, st._scalar(prob.mu + h))
                          - loss(U0, st._scalar(prob.mu - h))) / (2 * h)
            h = 1e-6
            fd_v = float(loss(U0 + h * v, st._scalar(prob.mu))
                         - loss(U0 - h * v, st._scalar(prob.mu))) / (2 * h)
        gv = float((g_U * v).sum())
        out[device] = (float(g_mu), g_U.cpu(), gv)
        log(f"[diffstep] {device}: dL/dmu={float(g_mu):.10e} (fd {fd_mu:.10e}) "
            f"dL/dU0.v={gv:.10e} (fd {fd_v:.10e}) {secs:.2f} s")
        check(abs(float(g_mu) - fd_mu) <= 2e-5 * abs(fd_mu),
              f"diffstep {device}: dL/dmu {float(g_mu)} against fd {fd_mu}")
        check(abs(gv - fd_v) <= 5e-6 * abs(fd_v),
              f"diffstep {device}: dL/dU0.v {gv} against fd {fd_v}")
    (m_c, U_c, _), (m_g, U_g, _) = out["cpu"], out["cuda"]
    rel_mu = abs(m_g - m_c) / abs(m_c)
    rel_U = float((U_g - U_c).abs().max() / U_c.abs().max())
    log(f"[diffstep] card against CPU: dL/dmu rel {rel_mu:.3e}, dL/dU0 rel {rel_U:.3e}")
    check(rel_mu <= 1e-8 and rel_U <= 1e-8,
          f"diffstep: card and CPU gradients differ ({rel_mu}, {rel_U})")


def _run_chunks(st, U, P, dt, n_steps):
    """n_steps of st.run, one a call, each timed to a device sync ->
    (U, P, dt, telemetry of all steps, seconds a step)."""
    import torch

    tels, secs = [], []
    for _ in range(n_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        U, P, dt, tel = st.run(U, P, dt, 1)[:4]
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        tels.append(tel)
    tel = {k: torch.cat([t[k] for t in tels]).cpu() for k in tels[0]}
    return U, P, dt, tel, secs


def _fast_report(tag, st, tel, secs, peak, setup, launches):
    """Log a FastStepper run: steps/s after the warm-up, setup seconds,
    peak memory (the path's own: above what earlier phases still held,
    `peak` a (peak, base) pair), counts, forces, ELL launches by operator."""
    timed = sum(secs[1:])
    log(f"[{tag}] layout={'packed' if st.packed else 'patch' if st.patch else 'dense'} "
        f"convection={'lagged' if st.lagged else 'newton'} momentum={st.mom_solver} "
        f"steps/s={(len(secs) - 1) / timed:.4f} ({len(secs) - 1} steps in {timed:.3f} s "
        f"after 1 warm-up step of {secs[0]:.3f} s; setup {setup:.1f} s) "
        f"peak_mem_bytes={peak[0] - peak[1]} (above {peak[1]} held before) "
        f"launches={launches}")
    for k in ("dt", "newton_iters", "linear_iters", "pressure_iters", "correction_iters"):
        log(f"[{tag}] {k}: {tel[k].tolist()}")
    forces = np.asarray(tel["forces"])
    log(f"[{tag}] drag: {forces[:, 0].tolist()}")
    log(f"[{tag}] lift: {forces[:, 1].tolist()}")


def _fast_checks(tag, st, U, P, tel, launches, ell_expected):
    import torch

    check(bool(torch.isfinite(U).all()) and bool(torch.isfinite(P).all()),
          f"{tag}: non-finite state")
    forces = np.asarray(tel["forces"])
    check(np.isfinite(forces).all(), f"{tag}: non-finite forces")
    check(forces[-1, 0] > 0, f"{tag}: the last step's drag is not positive")
    _check_solves(tel, tag)
    windows = {k: v for k, v in launches.items() if not k.startswith("ELL_")}
    check(not any(windows.values()), f"{tag}: a window or stencil kernel was launched: "
          f"{windows}")
    if ell_expected:
        check(launches["ELL_DIRECT"] > 0, f"{tag}: the direct ELL kernel was never launched")


def _ell_by_operator(st, hier):
    ops = {} if st.K_Q is None else {"pressure operator": st.K_Q}
    ops.update({f"level n={L.n}": L.ell for L in hier.levels
                if getattr(L, "ell", None) is not None})
    return ", ".join(f"{k} n={A.n} K={A.width} {A.kernel} {A.launches}"
                     for k, A in ops.items())


def phase_karman7m(kell, ell_jobs):
    """The einsum route at 7,607,104 DoF (KarmanProblem(lcar=0.02,
    n_refine=6), built once), float32: (a) run_karman_fast at its defaults
    (Newton, BiCGStab, backward Euler; packed="auto" takes the lane-packed
    layout), (b) bench.py's FastStepper at BENCH_PATCH=0 with packed="auto"
    and with packed=False; each 1 warm-up + 3 timed steps, one a chunk, and
    one synchronised step split by substep. Then the ELL kernels at this
    mesh's pressure operator and its two largest hierarchy levels (phase
    23's report). Returns the (a) and (b-auto) steppers and states for the
    profiler."""
    import torch
    from flow_tpu_torch.models.karman import KarmanProblem, run_karman_fast
    from flow_tpu_torch.solvers.multigrid import P1Hierarchy
    from flow_tpu_torch.navier_stokes.fast import FastStepper

    hand = _hand_kernels()
    t0 = time.perf_counter()
    prob = KarmanProblem(dtype=torch.float32, device="cuda", **KARMAN_7M)
    torch.cuda.synchronize()
    t_prob = time.perf_counter() - t0
    log(f"[karman7m] {KARMAN_7M} n_dofs={prob.n_dofs} (V {prob.V.n_dofs}, Q "
        f"{prob.Q.n_dofs}, cells {prob.mesh.n_cells}) problem setup {t_prob:.1f} s")
    check(prob.n_dofs == KARMAN_7M_DOFS, f"karman7m: unexpected n_dofs {prob.n_dofs}")
    keep, counts = {}, {}

    # (a) run_karman_fast at its defaults
    for k in hand.values():
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = run_karman_fast(num_steps=KARMAN_7M_STEPS, chunk_size=1, problem=prob)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    st, tel = out["stepper"], out["telemetry"]
    launches = {n: k.launches for n, k in hand.items()}
    _fast_report("karman7m-a", st, tel, out["chunk_seconds"],
                 (torch.cuda.max_memory_allocated(), base),
                 total - sum(out["chunk_seconds"]), launches)
    hier = st.pressure_precond.__self__
    log(f"[karman7m-a] ELL operators (the rule's kernel, launches): {_ell_by_operator(st, hier)}")
    check(st.packed and not st.lagged and st.mom_solver == "bicgstab"
          and st.theta == (0.0, 1.0), "karman7m-a: not the driver's defaults on the packed layout")
    _fast_checks("karman7m-a", st, out["u"], out["p"], tel, launches, True)
    counts["a"] = {k: tel[k].tolist() for k in ("newton_iters", "linear_iters",
                                                "pressure_iters", "correction_iters")}
    times = _timed_step(st, out["u"], out["p"], st._scalar(out["dt"]))
    log("[karman7m-a] substeps ms (one synchronised step): "
        + ", ".join(f"{k}={v:.2f}" for k, v in times.items()))
    keep["a"] = (st, out["u"], out["p"], st._scalar(out["dt"]))
    for name, A in (("pressure n=%d" % st.K_Q.n, st.K_Q),
                    *((f"level n={L.n}", L.ell) for L in hier.levels[-3:-1])):
        _ell_report(f"karman7m {name}", A, kell, ell_jobs)
    del out, hier
    torch.cuda.empty_cache()

    # (b) the bench's FastStepper, packed="auto" and packed=False
    for tag, packed in (("b-auto", "auto"), ("b-unpacked", False)):
        for k in hand.values():
            k.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        st = FastStepper(prob.V, prob.Q, prob.u_bcs, prob.p_bcs, prob.rho, prob.mu,
                         packed=packed, forces_probe=prob.consistent_force_probe(),
                         **FAST_BENCH)
        hier = P1Hierarchy(prob.mesh_hierarchy, bc_mask=st.mask_p, smoother_degree=3)
        st.pressure_precond = hier.v_cycle
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        U, P, dt, tel, secs = _run_chunks(st, *st.zeros(), KARMAN_DT0, KARMAN_7M_STEPS)
        launches = {n: k.launches for n, k in hand.items()}
        _fast_report(f"karman7m-{tag}", st, tel, secs,
                     (torch.cuda.max_memory_allocated(), base), setup, launches)
        log(f"[karman7m-{tag}] ELL operators (the rule's kernel, launches): "
            f"{_ell_by_operator(st, hier)}")
        check(st.packed == (packed == "auto"), f"karman7m-{tag}: packed={st.packed}")
        _fast_checks(f"karman7m-{tag}", st, U, P, tel, launches, True)
        counts[tag] = {k: tel[k].tolist() for k in ("newton_iters", "linear_iters",
                                                    "pressure_iters", "correction_iters")}
        times = _timed_step(st, U, P, dt)
        log(f"[karman7m-{tag}] substeps ms (one synchronised step): "
            + ", ".join(f"{k}={v:.2f}" for k, v in times.items()))
        if tag == "b-auto":
            keep["b"] = (st, U, P, dt)
        del st, hier, U, P
        torch.cuda.empty_cache()
    log(f"[karman7m] counts: {json.dumps(counts)}")
    held = {k: counts[k] for k in KARMAN_7M_ITERS}
    check(held == KARMAN_7M_ITERS,
          f"karman7m: the iterations moved: {held} against {KARMAN_7M_ITERS}")
    return keep


def phase_patch_main():
    """Patch mode at KARMAN_MAIN (1,905,056 DoF) in float32: bench.py's
    BENCH_PATCH=1 stepper (FAST_BENCH with patches= and PatchP1Hierarchy),
    the state kept in the patch layout, and beside it PackedPatchStepper
    with GMRES at the same settings; 1 warm-up + 5 timed steps each, one a
    call. Fails on a non-finite state or force, a last drag <= 0, an
    unconverged solve, a hand-kernel launch (none belongs on either), or
    patch counts other than PATCH_ITERS."""
    import torch
    from flow_tpu_torch.fem.patch import build_patch_info
    from flow_tpu_torch.models.karman import KarmanProblem
    from flow_tpu_torch.navier_stokes.fast import FastStepper
    from flow_tpu_torch.solvers.patch_mg import PatchP1Hierarchy

    hand = _hand_kernels()
    prob = KarmanProblem(dtype=torch.float32, device="cuda", **KARMAN_MAIN)
    check(prob.n_dofs == KARMAN_DOFS, f"patch: unexpected n_dofs {prob.n_dofs}")
    counts = {}
    for k in hand.values():
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    info = build_patch_info(prob.mesh_hierarchy)
    st = FastStepper(prob.V, prob.Q, prob.u_bcs, prob.p_bcs, prob.rho, prob.mu,
                     patches=info, forces_probe=prob.consistent_force_probe(), **FAST_BENCH)
    hier = PatchP1Hierarchy(info, bc_mask=st.mask_p, smoother_degree=3)
    st.pressure_precond = hier.v_cycle
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    U, P, dt, tel, secs = _run_chunks(st, st.V.zeros(), st.Q.zeros(), KARMAN_DT0,
                                      PATCH_STEPS)
    launches = {n: k.launches for n, k in hand.items()}
    _fast_report("patch", st, tel, secs, (torch.cuda.max_memory_allocated(), base), setup,
                 launches)
    log(f"[patch] C={info.C} n={info.n} n_flat V={st.V.n_dofs} Q={st.Q.n_dofs} "
        f"levels={[L.n for L in hier.levels]}")
    check(st.patch and tuple(U.shape) == (st.V.n_dofs, 2), "patch: not the patch layout")
    _fast_checks("patch", st, U, P, tel, launches, False)
    check(not any(launches.values()), f"patch: a hand kernel was launched: {launches}")
    counts["patch"] = {k: tel[k].tolist() for k in ("newton_iters", "linear_iters",
                                                    "pressure_iters", "correction_iters")}
    times = _timed_step(st, st.V.from_patch(U), st.Q.from_patch(P), dt)
    log("[patch] substeps ms (one synchronised step, global layout in and out): "
        + ", ".join(f"{k}={v:.2f}" for k, v in times.items()))
    del st, hier, U, P
    torch.cuda.empty_cache()

    # beside it: PackedPatchStepper with GMRES at the same settings
    for k in hand.values():
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    ps, _ = _packed_stepper(prob, **dict(PACKED_SETTINGS, momentum_solver="gmres"))
    ps.forces_probe = prob.consistent_force_probe()
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    tels, secs = [], []
    U, P = ps.zeros()
    dt = KARMAN_DT0
    for _ in range(PATCH_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        U, P, dt, tel1 = ps.run(U, P, dt, 1)[:4]
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        tels.append(tel1)
    tel = {k: torch.cat([torch.as_tensor(t[k]).reshape(-1) for t in tels]).cpu()
           for k in tels[0] if k != "forces"}
    tel["forces"] = torch.cat([torch.as_tensor(t["forces"]).reshape(-1, 2) for t in tels]).cpu()
    launches = {n: k.launches for n, k in hand.items()}
    timed = sum(secs[1:])
    log(f"[patch-packed] PackedPatchStepper momentum=gmres steps/s="
        f"{(PATCH_STEPS - 1) / timed:.4f} (after 1 warm-up step of {secs[0]:.3f} s; "
        f"setup {setup:.1f} s) peak_mem_bytes={torch.cuda.max_memory_allocated() - base} "
        f"(above {base} held before)")
    counts["packed-patch"] = {k: tel[k].tolist() for k in ("newton_iters", "linear_iters",
                                                          "pressure_iters",
                                                          "correction_iters")}
    for k in counts["packed-patch"]:
        log(f"[patch] {k}: patch {counts['patch'][k]} packed-patch {counts['packed-patch'][k]}")
    check(not any(launches.values()), f"patch-packed: a hand kernel was launched: {launches}")
    _check_solves(tel, "patch-packed")
    Ug, Pg = ps.from_packed_state(U, P)
    check(bool(torch.isfinite(Ug).all()) and bool(torch.isfinite(Pg).all()),
          "patch-packed: non-finite state")
    log(f"[patch] counts: {json.dumps(counts)}")
    check(counts["patch"] == PATCH_ITERS,
          f"patch: the iterations moved: {counts['patch']} against {PATCH_ITERS}")
    del ps
    torch.cuda.empty_cache()


def _profile_fast_steps(keep):
    """One step of (a) and (b-auto) at 7.6M under torch.profiler: device
    events, launch calls, device ms and the aten ops with the most device
    time; the idle share is 1 - device ms / the wall ms of the same step
    run unprofiled just before (the profiler slows the host several-fold)."""
    import torch

    for tag, (st, U, P, dt) in keep.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st._step_impl(U, P, dt)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        ev, calls, ms, top = _profile_split(lambda: st._step_impl(U, P, dt))
        prof_wall = 1e3 * (time.perf_counter() - t0)
        log(f"[profile] karman7m ({tag}) one step: {ev} device events, {calls} launch "
            f"calls, {ms:.2f} ms of device; wall {wall:.2f} ms unprofiled ({prof_wall:.2f} "
            f"profiled), idle {max(0.0, 1.0 - ms / wall):.3f}; top: "
            + ", ".join(f"{k} {t:.2f} ms x{c}" for k, t, c in top))
        check(ev > 0, f"karman7m ({tag}): the profiler shows no device event")


# -- the distributed layer (31) ------------------------------------------------
RUN_CASES = "flow_tpu_torch.parallel.cases:run_cases"


def _ranks(cases, device, world, timeout=DIST_SCRIPT_TIMEOUT):
    """Every rank's results of parallel/cases.run_cases: NCCL ranks on the
    cards (device "cuda") or gloo ranks on the CPU."""
    from flow_tpu_torch.parallel import comm

    return comm.launch(RUN_CASES, world, args=(cases, device),
                       backend="nccl" if device == "cuda" else "gloo", timeout=timeout)


def phase_dist_parity(world):
    """(31a) the four distributed steppers in float64 on the cards and on as
    many gloo CPU ranks."""
    from flow_tpu_torch.parallel import cases

    pc = cases.parity_cases()
    t0 = time.perf_counter()
    card = _ranks(pc, "cuda", world)[0]
    t1 = time.perf_counter()
    cpu = _ranks(pc, "cpu", world)[0]
    log(f"[dist-parity] world={world}: cards {t1 - t0:.1f} s, CPU ranks "
        f"{time.perf_counter() - t1:.1f} s")
    names = ["packed karman lcar=0.2 bicgstab 3 steps", "projection lid n=10",
             "halo_poisson lid n=24", "halo mg bdf2 3 steps", "halo window lagged 2 steps",
             "halo window newton 2 steps"]
    for (i, same, du, dp, umax), name in zip(cases.compare(card, cpu), names):
        log(f"[dist-parity] {name}: counts equal={same} max|dU|={du:.3e} "
            f"max|dP - mean|={dp:.3e} (max|U| {umax:.3e})")
        check(same, f"dist parity: {name}: counts differ between the cards and the CPU")
        if "window" in name:
            pmax = float(np.abs(cpu[i]["steps"][-1][1]).max())
            check(du <= 2e-6 * umax and dp <= 1e-4 * pmax,
                  f"dist parity: {name}: state differs (dU {du}, dP {dp})")
        else:
            check(du <= 1e-8 and dp <= 1e-8,
                  f"dist parity: {name}: state differs (dU {du}, dP {dp})")
    packed = card[0]["run"][3]
    log(f"[dist-parity] packed counts (cards): " + ", ".join(
        f"{k}={packed[k].tolist()}" for k in ("linear_iters", "pressure_iters",
                                               "correction_iters")))


def _prof_text(p):
    if p is None:
        return "not profiled (no card)"
    return (f"{p['events']} device events, {p['device_us']:.1f} device us, NCCL "
            f"{p['nccl_us']:.1f} us")


def _pin_counts(tel):
    return {k: list(tel[k]) for k in ("linear_iters", "pressure_iters", "correction_iters")}


def phase_dist_packed(world, spec, tag, expect=None):
    """(31b, 31e) ShardedPackedStepper at `spec` in float32 at
    PACKED_SETTINGS, 1 + 5 steps from rest."""
    case = dict(kind="packed_main", spec=dict(problem="karman", **spec), dtype="float32",
                kw=PACKED_SETTINGS, dt=KARMAN_DT0, n_steps=SHARDED_PACKED_STEPS)
    t0 = time.perf_counter()
    res = _ranks([case], "cuda", world)
    wall = time.perf_counter() - t0
    r = res[0][0]
    counts = _pin_counts(r["tel"])
    prof = r["profile"]
    log(f"[{tag}] {spec} n_dofs={r['n_dofs']} world={world} float32: steps/s="
        f"{r['steps_per_s']:.4f} (after 1 warm-up step); setup {r['setup_s']:.1f} s "
        f"(wall of the job {wall:.1f} s); patches {r['seam_stats']}")
    log(f"[{tag}] counts {counts}; single-card pin KARMAN_PACKED_ITERS "
        f"{KARMAN_PACKED_ITERS}")
    log(f"[{tag}] peak memory a rank (bytes): {[x[0]['peak_bytes'] for x in res]}")
    log(f"[{tag}] collectives a step: {r['collectives_per_step']}; host us a 0-d "
        f"all_reduce (200 enqueued, one sync): {r['all_reduce_host_us']:.2f}")
    log(f"[{tag}] one profiled step (rank 0): {_prof_text(prof)}; ranks' NCCL us "
        f"{[round((x[0]['profile'] or {}).get('nccl_us', -1), 1) for x in res]}")
    check(all(x[0]["finite"] for x in res), f"{tag}: non-finite state")
    for key in ("pressure_converged", "correction_converged"):
        check(all(r["tel"][key]), f"{tag}: a {key.split('_')[0]} solve did not converge")
    check(not r["launches"], f"{tag}: a hand kernel was launched: {r['launches']}")
    check(0.0099 <= r["umax"] <= 0.1, f"{tag}: max |u| {r['umax']} out of range")
    if expect is not None:
        check(counts == expect, f"{tag}: counts {counts} are not {expect}")
    return r


def phase_dist_halo(world):
    """(31c) HaloProjection at KARMAN_MAIN in float32: the einsum and window
    routes, lagged and Newton, then the window route on box_mesh N=32."""
    routes = [(False, "lagged"), (False, "newton"), (True, "lagged"), (True, "newton")]
    case = dict(kind="halo_main", spec=dict(problem="karman", **KARMAN_MAIN),
                dtype="float32", mg=True, routes=routes, kw=HALO_SETTINGS,
                dt=KARMAN_DT0, n_steps=HALO_STEPS)
    box = dict(kind="halo_main", spec=dict(problem="box", n=(HALO3D_N,) * 3, x1=1.0),
               dtype="float32", routes=[(True, "lagged"), (True, "newton")],
               kw=HALO_SETTINGS, dt=KARMAN_DT0, n_steps=2)
    res = _ranks([case, box], "cuda", world)
    launches = {}
    for tag, out in (("halo karman", res[0][0]), ("halo box N=32", res[0][1])):
        for route, r in out.items():
            log(f"[dist-halo] {tag} {route} world={world}: {r['s_per_step']:.3f} s a step "
                f"(setup {r['setup_s']:.1f} s), pressure {r['tel']['pressure_iters']}, "
                f"correction {r['tel']['correction_iters']}, max|u| {r['umax']:.4e}, "
                f"one profiled step {_prof_text(r['profile'])}, hand-kernel launches "
                f"{r['launches']}, peak {r['peak_bytes']} bytes, collectives a step "
                f"{r['collectives_per_step']}")
            check(all(x[0 if tag == "halo karman" else 1][route]["finite"] for x in res),
                  f"dist halo: {tag} {route}: non-finite state")
            if r["kernel_check"] is not None:
                # K3 at the halo layout against its plain version (launches
                # outside the run's count); float32 sums in another order
                errs = [x[0 if tag == "halo karman" else 1][route]["kernel_check"]
                        for x in res]
                log(f"[dist-halo] {tag} {route}: K3 against plain at each rank's layout, "
                    f"max|kernel - plain| / max|plain| "
                    f"{[f'{e / m:.3e}' for e, m in errs]}")
                check(all(e <= 1e-5 * m for e, m in errs),
                      f"dist halo: {tag} {route}: K3 differs from its plain version")
            launches[f"{tag} {route}"] = r["launches"]
    k = launches
    check(k["halo karman window lagged"].get("WINMOM", 0) > 0,
          "dist halo: the window route launched no K3 2-D lagged")
    check(k["halo karman window newton"].get("WINMOM_NEWTON", 0) > 0,
          "dist halo: the Newton window route launched no K3 2-D Newton")
    check(k["halo box N=32 window lagged"].get("WINMOM3D", 0) > 0,
          "dist halo: the 3-D window route launched no K3 3-D lagged")
    check(k["halo box N=32 window newton"].get("WINMOM3D_NEWTON", 0) > 0,
          "dist halo: the 3-D Newton window route launched no K3 3-D Newton")
    ell = {n: sum(v.get(n, 0) for key, v in k.items() if key.startswith("halo karman"))
           for n in ("ELL_DIRECT", "ELL_WINDOW")}
    check(ell["ELL_DIRECT"] + ell["ELL_WINDOW"] > 0,
          "dist halo: the coarse hierarchy launched no ELL kernel")
    return launches


def phase_dist_projection(world):
    """(31d) ShardedProjection one step, HaloPoisson one solve at
    KARMAN_MAIN's spaces, float32."""
    case = dict(kind="projection_main", spec=dict(problem="karman", **KARMAN_MAIN),
                dtype="float32", kw=PROJECTION_SETTINGS, dt=KARMAN_DT0,
                poisson_rtol=1e-4, poisson_maxiter=2000)
    res = _ranks([case], "cuda", world)
    r = res[0][0]
    log(f"[dist-projection] ShardedProjection world={world}: one step {r['projection']['step_s']:.2f} s "
        f"(setup {r['projection']['setup_s']:.1f} s), max|u| {r['projection']['umax']:.4e}")
    log(f"[dist-projection] HaloPoisson world={world}: {r['poisson']['iters']} CG iterations in "
        f"{r['poisson']['solve_s']:.2f} s (setup {r['poisson']['setup_s']:.1f} s)")
    check(r["projection"]["finite"] and r["poisson"]["finite"],
          "dist projection: non-finite result")
    check(r["poisson"]["iters"] < 2000, "dist projection: HaloPoisson did not converge")


def distributed_main():
    """`chip_smoke.py --distributed`: phase 31 alone (after the build)."""
    import torch

    world = torch.cuda.device_count()
    log(f"[dist] world size {world} (the cards present)")
    t0 = time.perf_counter()
    phase_build()
    phase_dist_parity(world)
    packed = phase_dist_packed(world, KARMAN_MAIN, "dist-packed",
                               expect=KARMAN_PACKED_ITERS if world == 1 else
                               SHARDED_PACKED_ITERS.get(world))
    halo = phase_dist_halo(world)
    phase_dist_projection(world)
    summary = {"world": world, "halo_launches": halo,
               "packed_counts": _pin_counts(packed["tel"])}
    if world >= 4:
        big = phase_dist_packed(world, KARMAN_10M, "dist-packed-10M")
        check(big["n_dofs"] == KARMAN_10M_DOFS, f"10M: n_dofs {big['n_dofs']}")
        summary["packed_10m_counts"] = _pin_counts(big["tel"])
    log(f"[dist] phase 31 in {time.perf_counter() - t0:.1f} s")
    print("[dist-summary] " + json.dumps(summary), flush=True)
    return summary


def phase_distributed():
    """Phase 31 in a process of its own (`chip_smoke.py --distributed`): its
    ranks' host timings are not slowed by this process's profiler sessions,
    and the cards' memory is its own. Returns its summary."""
    import torch

    torch.cuda.empty_cache()
    proc = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--distributed"],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            cwd=str(ROOT))
    summary = None
    try:
        for line in proc.stdout:
            print(line, end="", flush=True)
            if line.startswith("[dist-summary] "):
                summary = json.loads(line[len("[dist-summary] "):])
        proc.wait(timeout=DIST_SCRIPT_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    check(proc.returncode == 0 and summary is not None,
          f"phase 31 (chip_smoke.py --distributed) failed with exit code {proc.returncode}")
    return summary



# -- phase 32: the DFG 2D-2 coarse-to-fine seeding route, mesh and field I/O --
def _st_seed(prob):
    """scripts/schafer_turek.py's initial velocity (:52-66): an antisymmetric
    vortex blob downstream of the cylinder (SEEDED_AMPLITUDE), projected
    onto V, its Dirichlet rows zeroed."""
    import torch
    from flow_tpu_torch import project
    from flow_tpu_torch.fem.bc import combine_bcs

    def u0x(x):
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)

    def u0y(x):
        r2 = ((x[..., 0] - 0.35) ** 2 + (x[..., 1] - 0.20) ** 2) / 0.05**2
        return SEEDED_AMPLITUDE * torch.exp(-r2)

    U0 = project((u0x, u0y), prob.V).vector
    mask, _ = combine_bcs(prob.V, prob.u_bcs)
    return (1.0 - torch.as_tensor(mask, dtype=U0.dtype, device=U0.device)) * U0


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _seeded_route(dtype, device, lcar, n_coarse, workdir, lmax=None):
    """scripts/schafer_turek.py's seeding route: the coarse leg (the
    perturbed start, run_karman_fast with a checkpoint, 1 + 5 steps), the
    transfer (load_checkpoint, prolong_vector of U and P one refine_uniform
    level, the fine Dirichlet values re-imposed through combine_bcs, as
    :77-115) and the fine leg from the prolonged state (:161-174). The coarse
    mesh must equal level n_coarse of the fine problem's hierarchy. lmax:
    {"coarse": [...], "fine": [...]} for the two pressure hierarchies."""
    import torch
    from flow_tpu_torch.fem.bc import combine_bcs
    from flow_tpu_torch.fem.transfer import prolong_vector, restrict_vector
    from flow_tpu_torch.io import load_checkpoint
    from flow_tpu_torch.models.karman import run_karman_fast, schafer_turek_problem

    lmax = lmax or {}
    on = dict(dtype=dtype, device=device)
    t0 = time.perf_counter()
    fine = schafer_turek_problem(lcar=lcar, n_refine=n_coarse + 1, **on)
    coarse = schafer_turek_problem(lcar=lcar, n_refine=n_coarse, **on)
    setup = time.perf_counter() - t0
    level = fine.mesh_hierarchy[n_coarse]
    check(np.array_equal(coarse.mesh.points_np, level.points_np)
          and np.array_equal(coarse.mesh.cells_np, level.cells_np),
          f"seeding: schafer_turek_problem(lcar={lcar}, n_refine={n_coarse}).mesh is not "
          f"level {n_coarse} of the n_refine={n_coarse + 1} hierarchy")
    ckpt = os.path.join(workdir, f"coarse_{torch.device(device).type}_{lcar}.npz")
    out_c = run_karman_fast(num_steps=SEEDED_STEPS, chunk_size=1, problem=coarse,
                            initial_state=(_st_seed(coarse), coarse.Q.zeros()),
                            dt0=SEEDED_DT0, dt_max=SEEDED_DT_MAX, checkpoint_path=ckpt,
                            lmax=lmax.get("coarse"), **SEEDED_SETTINGS)
    arrays, scalars = load_checkpoint(ckpt)
    Us, Ps = (torch.as_tensor(arrays[k], **on) for k in ("U", "P"))
    mask, val = (torch.as_tensor(a, **on) for a in combine_bcs(fine.V, fine.u_bcs))
    transfer_s = []
    for _ in range(2):  # the first call moves the edge tables to the device
        _sync(device)
        t0 = time.perf_counter()
        Uf = prolong_vector(Us, coarse.V, fine.V)
        Pf = prolong_vector(Ps, coarse.Q, fine.Q)
        U_seed = (1.0 - mask) * Uf + mask * val  # the fine Dirichlet values
        _sync(device)
        transfer_s.append(time.perf_counter() - t0)
    check(torch.equal(restrict_vector(Uf, fine.V, coarse.V), Us)
          and torch.equal(restrict_vector(Pf, fine.Q, coarse.Q), Ps),
          "seeding: restrict_vector(prolong_vector(x)) is not x")
    dt0 = min(float(scalars["dt"]), SEEDED_DT_MAX)
    if torch.device(device).type == "cuda":
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out_f = run_karman_fast(num_steps=SEEDED_STEPS, chunk_size=1, problem=fine,
                            initial_state=(U_seed, Pf), dt0=dt0, dt_max=SEEDED_DT_MAX,
                            lmax=lmax.get("fine"), **SEEDED_SETTINGS)
    _sync(device)
    fine_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base
            if torch.device(device).type == "cuda" else None)
    for leg, out in (("coarse", out_c), ("fine", out_f)):
        _check_solves(out["telemetry"], f"seeding {leg} leg ({device})")
        check(bool(torch.isfinite(out["u"]).all()) and bool(torch.isfinite(out["p"]).all()),
              f"seeding {leg} leg ({device}): non-finite state")
        check(np.isfinite(out["telemetry"]["forces"]).all(),
              f"seeding {leg} leg ({device}): non-finite drag or lift")
    return dict(coarse=coarse, fine=fine, out_c=out_c, out_f=out_f, Us=Us, Ps=Ps, Uf=Uf,
                Pf=Pf, dt0=dt0, setup=setup, transfer_s=transfer_s, fine_s=fine_s,
                peak=peak, ckpt=ckpt)


SEEDED_KEYS = ("linear_iters", "pressure_iters", "correction_iters")


def _seeded_counts(out):
    return {k: out["telemetry"][k].tolist() for k in SEEDED_KEYS}


def _write_msh41_binary(path, points, cells):
    """A gmsh 4.1 binary file of a triangle mesh: one node block and one
    triangle block on surface entity 1, 1-based tags, z = 0 (gmsh's own
    layout; the JAX package has no .msh writer)."""
    import struct

    n, m = len(points), len(cells)
    xyz = np.zeros((n, 3))
    xyz[:, :2] = points
    tags = np.arange(1, n + 1, dtype="<u8")
    elem = np.empty((m, 4), dtype="<u8")
    elem[:, 0] = np.arange(1, m + 1)
    elem[:, 1:] = cells + 1
    with open(path, "wb") as f:
        f.write(b"$MeshFormat\n4.1 1 8\n" + struct.pack("<i", 1) + b"\n$EndMeshFormat\n")
        f.write(b"$Nodes\n" + struct.pack("<4Q", 1, n, 1, n) + struct.pack("<3iQ", 2, 1, 0, n))
        f.write(tags.tobytes() + xyz.astype("<f8").tobytes() + b"\n$EndNodes\n")
        f.write(b"$Elements\n" + struct.pack("<4Q", 1, m, 1, m) + struct.pack("<3iQ", 2, 1, 2, m))
        f.write(elem.tobytes() + b"\n$EndElements\n")


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


class _HostWriter:
    """A writer that keeps each written Function's name, time and host
    values: the writer routes of the drivers where h5py is absent."""

    def __init__(self):
        self.rows = []

    def write(self, fn, t=0.0):
        self.rows.append((fn.name, float(t), fn.vector.detach().cpu().numpy()))


def _seeding_io(fine, U, P, work):
    """The mesh and field files of the fine state (phase 32's last leg)."""
    import torch
    from flow_tpu_torch import Function, mesh as tmesh, reorder_rcm
    from flow_tpu_torch.io import read_dolfin_xml, read_msh, write_dolfin_xml

    mesh = fine.mesh
    pts, cells = mesh.points_np, mesh.cells_np

    def same(m, p=pts, c=cells):
        return np.array_equal(m.points_np, p) and np.array_equal(m.cells_np, c)

    def size(path):
        return os.path.getsize(path)

    f_npz = os.path.join(work, "fine_mesh.npz")
    _, w = _timed(lambda: tmesh.save_mesh(f_npz, mesh))
    m, r = _timed(lambda: tmesh.load_mesh(f_npz, dtype=mesh.dtype))
    check(same(m) and m.device == mesh.device, "seeding io: load_mesh(save_mesh(mesh)) differs")
    log(f"[seeding-io] save_mesh {w:.3f} s, load_mesh {r:.3f} s, {size(f_npz)} bytes "
        f"({mesh.n_points} points, {mesh.n_cells} cells)")
    f_xml = os.path.join(work, "fine_mesh.xml")
    _, w = _timed(lambda: write_dolfin_xml(f_xml, mesh))
    m, r = _timed(lambda: read_dolfin_xml(f_xml, dtype=mesh.dtype))
    check(same(m) and m.device == mesh.device,
          "seeding io: read_dolfin_xml(write_dolfin_xml(mesh)) differs")
    log(f"[seeding-io] write_dolfin_xml {w:.3f} s, read_dolfin_xml {r:.3f} s, "
        f"{size(f_xml)} bytes")
    f_msh = os.path.join(work, "fine_mesh.msh")
    _, w = _timed(lambda: _write_msh41_binary(f_msh, pts, cells))
    m, r = _timed(lambda: read_msh(f_msh, dtype=mesh.dtype, rcm=False))
    check(same(m) and m.device == mesh.device, "seeding io: read_msh(rcm=False) differs")
    m_rcm, r_rcm = _timed(lambda: read_msh(f_msh, dtype=mesh.dtype))
    p2, c2 = reorder_rcm(pts, cells)
    check(same(m_rcm, p2, c2), "seeding io: read_msh(rcm=True) is not reorder_rcm's")
    log(f"[seeding-io] gmsh 4.1 binary: written {w:.3f} s, read_msh rcm=False {r:.3f} s, "
        f"rcm=True {r_rcm:.3f} s (renumbered: {not np.array_equal(p2, pts)}), "
        f"{size(f_msh)} bytes")
    try:
        import h5py  # noqa: F401
    except ImportError as e:
        log(f"[seeding-io] XDMF leg did not run: h5py does not import on this machine "
            f"({e}); XDMFFile needs it (the io extra)")
        return False
    from flow_tpu_torch.io import XDMFFile

    u = Function(fine.V, U).rename("velocity")
    p = Function(fine.Q, P).rename("pressure")
    f_x = os.path.join(work, "fine_state.xdmf")
    with XDMFFile(f_x) as xf:
        _, w = _timed(lambda: (xf.write(u, 0.0), xf.write(p, 0.0)))
        _, wc = _timed(lambda: xf.write_checkpoint(u, t=0.0))
    log(f"[seeding-io] XDMFFile.write of velocity and pressure {w:.3f} s, write_checkpoint "
        f"{wc:.3f} s, {size(f_x[:-5] + '.h5')} bytes of h5")
    (back, t), r = _timed(lambda: XDMFFile(f_x).read_checkpoint(fine.V, "velocity"))
    check(back.vector.device == U.device and torch.equal(back.vector, U),
          "seeding io: read_checkpoint differs from the written velocity")
    log(f"[seeding-io] read_checkpoint to the card {r:.3f} s: bitwise equal")
    return True


def _writer_routes(xdmf, work):
    """run_karman(writer=) and compute_boussinesq(writer=) on the card at
    their CPU tests' sizes in float64, 2 steps each, through an XDMFFile
    where h5py imports (else an in-memory writer)."""
    import torch
    from flow_tpu_torch.models.boussinesq import compute_boussinesq
    from flow_tpu_torch.models.karman import run_karman

    def writer(name):
        if xdmf:
            from flow_tpu_torch.io import XDMFFile

            return XDMFFile(os.path.join(work, f"{name}.xdmf"))
        return _HostWriter()

    for name, run, per_step in (
            ("run_karman", lambda w: run_karman(num_steps=2, lcar=0.2, dtype=torch.float64,
                                                writer=w), 2),
            ("compute_boussinesq", lambda w: compute_boussinesq(
                target_time=0.05, lcar=0.03, n_refine=1, backend="packed", writer=w), 3)):
        w = writer(name)
        _, secs = _timed(lambda: run(w))
        if xdmf:
            import h5py

            w.close()
            h5_path = os.path.join(work, f"{name}.h5")
            with h5py.File(h5_path, "r") as h5:
                n = sum(len(h5[g]) for g in h5 if g != "mesh")
            nbytes = os.path.getsize(h5_path)
        else:
            n, nbytes = len(w.rows), sum(a.nbytes for *_, a in w.rows)
            check(all(np.isfinite(a).all() for *_, a in w.rows),
                  f"writer routes: {name} wrote a non-finite field")
        log(f"[seeding-io] {name}(writer={type(w).__name__}): {n} fields written in 2 "
            f"steps, {nbytes} bytes, {secs:.2f} s")
        check(n == 2 * per_step, f"writer routes: {name} wrote {n} fields in 2 steps, "
              f"not {2 * per_step}")


def phase_seeding_io():
    """Phase 32: scripts/schafer_turek.py's seeding route and the I/O of
    its fine state."""
    import tempfile

    import torch
    from flow_tpu_torch.fem.transfer import prolong_vector
    from flow_tpu_torch.utils import MetricsLogger, device_memory_stats, profiling

    hand = _hand_kernels()
    for k in hand.values():
        k.launches = 0
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_seeding_") as work:
        # (a) the route in float64 on the CPU and on the card, lambda_max
        # carried across
        runs, lmax = {}, None
        for device in ("cpu", "cuda"):
            r = _seeded_route(torch.float64, device, SEEDED_PARITY["lcar"],
                              SEEDED_PARITY["n_coarse"], work, lmax=lmax)
            if lmax is None:
                lmax = {leg: [L.lmax for L in r[f"out_{leg[0]}"]["stepper"].hierarchy.levels]
                        for leg in ("coarse", "fine")}
            runs[device] = r
        for leg in ("out_c", "out_f"):
            a, b = (_seeded_counts(runs[d][leg]) for d in ("cuda", "cpu"))
            log(f"[seeding-parity] {leg[-1]} leg counts: cuda={a} cpu={b}")
            check(a == b, f"seeding parity: the {leg} counts differ (cuda {a}, cpu {b})")
            U_c, P_c = runs["cpu"][leg]["u"], runs["cpu"][leg]["p"]
            U_g, P_g = (runs["cuda"][leg][k].cpu() for k in ("u", "p"))
            du = float((U_g - U_c).abs().max())
            dp = P_g - P_c
            dp = float((dp - dp.mean()).abs().max())
            umax, pmax = float(U_c.abs().max()), float(P_c.abs().max())
            log(f"[seeding-parity] {leg[-1]} leg max|dU|={du:.3e} (max|U| {umax:.3e}) "
                f"max|dP - mean|={dp:.3e} (max|P| {pmax:.3e})")
            check(du <= 1e-9 * umax and dp <= 1e-7 * pmax,
                  f"seeding parity: the {leg} states differ (dU {du}, dP {dp})")
        del runs
        # (b) the route at the campaign's width, float32 on the card
        r = _seeded_route(torch.float32, "cuda", SEEDED_LCAR, SEEDED_COARSE, work)
        coarse, fine, out_f = r["coarse"], r["fine"], r["out_f"]
        log(f"[seeding] coarse: schafer_turek_problem(lcar={SEEDED_LCAR}, "
            f"n_refine={SEEDED_COARSE}) {coarse.n_dofs} DoF, equal (points and cells) "
            f"to level {SEEDED_COARSE} of the n_refine={SEEDED_COARSE + 1} hierarchy, "
            f"so the coarse leg ran on it; fine: {fine.n_dofs} DoF; both problems "
            f"built in {r['setup']:.1f} s")
        log(f"[seeding] coarse leg counts {_seeded_counts(r['out_c'])}, dt "
            f"{r['out_c']['telemetry']['dt'].tolist()}")
        cpu_U = prolong_vector(r["Us"].cpu(), coarse.V, fine.V)
        cpu_P = prolong_vector(r["Ps"].cpu(), coarse.Q, fine.Q)
        check(torch.equal(r["Uf"].cpu(), cpu_U) and torch.equal(r["Pf"].cpu(), cpu_P),
              "seeding: the card's prolongation differs from the CPU's")
        log(f"[seeding] transfer (prolong_vector of U [{r['Us'].shape[0]}, 2] and P, the "
            f"fine Dirichlet values re-imposed): {r['transfer_s'][0]:.4f} s on the card "
            f"with the edge tables' move to it, {r['transfer_s'][1]:.4f} s again; "
            f"restrict_vector gives the coarse vectors back bitwise; the card's "
            f"prolongation equals the CPU's bitwise; dt0 {r['dt0']:.6g}")
        tel, secs = out_f["telemetry"], out_f["chunk_seconds"]
        steps_s = (SEEDED_STEPS - 1) / sum(secs[1:])
        counts = _seeded_counts(out_f)
        log(f"[seeding] fine leg run_karman_fast(backend=packed, lagged, bdf2) "
            f"{fine.n_dofs} DoF float32: steps/s={steps_s:.4f} (after 1 warm-up step of "
            f"{secs[0]:.3f} s; stepper setup {r['fine_s'] - sum(secs):.1f} s), peak "
            f"{r['peak'] / 1e9:.3f} GB above the allocated before the leg")
        for k in SEEDED_KEYS + ("dt",):
            log(f"[seeding] fine {k}: {tel[k].tolist()}")
        log(f"[seeding] fine drag: {tel['forces'][:, 0].tolist()}")
        log(f"[seeding] fine lift: {tel['forces'][:, 1].tolist()}")
        if SEEDED_PACKED_ITERS is not None:
            check(counts == SEEDED_PACKED_ITERS,
                  f"seeding: fine counts {counts}, not SEEDED_PACKED_ITERS "
                  f"{SEEDED_PACKED_ITERS}")
        f_log = os.path.join(work, "fine_leg.jsonl")
        with MetricsLogger(f_log) as ml:
            for i in range(SEEDED_STEPS):
                ml.log(step=i, dt=float(tel["dt"][i]), seconds=float(secs[i]),
                       drag=float(tel["forces"][i, 0]), lift=float(tel["forces"][i, 1]),
                       **{k: int(tel[k][i]) for k in SEEDED_KEYS})
        summary = ml.summary()
        check(summary["linear_iters"]["n"] == SEEDED_STEPS
              and len(open(f_log).read().splitlines()) == SEEDED_STEPS,
              "seeding: the MetricsLogger lost a step")
        log(f"[seeding] MetricsLogger summary: " + json.dumps(
            {k: summary[k] for k in ("seconds",) + SEEDED_KEYS}))
        st = out_f["stepper"]
        Up, Pp = st.to_packed_state(out_f["u"], out_f["p"])
        trace_dir = os.path.join(work, "trace")
        with profiling.Timer("traced step", sync=True) as timer:
            with profiling.trace(trace_dir):
                st.run(Up, Pp, out_f["dt"], 1, dt_max=SEEDED_DT_MAX)
        files = [os.path.join(d, f) for d, _, fs in os.walk(trace_dir) for f in fs]
        check(files and all(os.path.getsize(f) > 0 for f in files),
              "seeding: profiling.trace wrote no trace file")
        log(f"[seeding] profiling.trace of one fine step: {timer.elapsed:.3f} s, "
            f"{len(files)} file(s), {sum(os.path.getsize(f) for f in files)} bytes")
        stats = device_memory_stats()
        key = f"cuda:{torch.cuda.current_device()}"
        check(key in stats and stats[key]["allocated_bytes.all.current"]
              == torch.cuda.memory_allocated(),
              f"seeding: device_memory_stats() does not name {key}: {sorted(stats)}")
        log(f"[seeding] device_memory_stats(): {sorted(stats)}, {key} "
            f"({torch.cuda.get_device_name()}) allocated "
            f"{stats[key]['allocated_bytes.all.current']} bytes, peak "
            f"{stats[key]['allocated_bytes.all.peak']}")
        # (c) the fine state's files
        xdmf = _seeding_io(fine, out_f["u"], out_f["p"], work)
        _writer_routes(xdmf, work)
        del r, out_f, st, Up, Pp
    launches = {name: k.launches for name, k in hand.items()}
    check(not any(launches.values()), f"seeding: a hand kernel was launched: {launches}")
    log(f"[seeding] phase 32 in {time.perf_counter() - t_phase:.1f} s; no hand-kernel "
        f"launch")
    torch.cuda.empty_cache()


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
    if sys.argv[1:] == ["--distributed"]:
        try:
            distributed_main()
        except SmokeFailure as e:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
            return 1
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]} (only --distributed)",
              file=sys.stderr)
        return 2
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
        del st_p, state_p, packed_driver
        torch.cuda.empty_cache()
        # steady Stokes (MINRES): card-vs-CPU parity, then path A, the
        # packed driver from the Stokes bootstrap at the main path's mesh
        phase_stokes_parity()
        prob_boot = phase_karman_bootstrap(prob_p)
        del prob_p
        torch.cuda.empty_cache()
        # the coupled Boussinesq driver (float64, packed NS route, heat on
        # the shifted multigrid): no hand kernel
        phase_boussinesq_parity()
        phase_boussinesq_main()
        torch.cuda.empty_cache()
        # the 3-D driver: card-vs-CPU parity on both routes, path B (the box
        # stepper, K1; host splu heat) and path C (Rotational on tets, the
        # tet heat multigrid)
        phase_boussinesq3d_parity()
        b3_grids, b3_jobs = phase_boussinesq3d_packed()
        phase_boussinesq3d_mg()
        torch.cuda.empty_cache()
        # FastStepper's other routes and options: card-vs-CPU parity of
        # each, DiffStepper, patch mode at 1.9M, the einsum route at 7.6M
        # (its ELL operators join phase 23's rows)
        phase_fast_parity()
        phase_diffstep()
        phase_patch_main()
        # the distributed layer, in a process of its own (phase 31)
        dist = phase_distributed()
        keep7m = phase_karman7m(kell, ell_jobs)
        # the DFG 2D-2 seeding route and the I/O of its fine state (phase
        # 32; no hand kernel), before the profiler phases: its one traced
        # step comes last in it
        phase_seeding_io()
        # device times from the profiler, last: a profiler session slows
        # later host code in the process
        _profile_fast_steps(keep7m)
        del keep7m
        torch.cuda.empty_cache()
        ev, calls = _minres_launches(prob_boot)
        log(f"[profile] bootstrap MINRES ({prob_boot.mesh.dtype}, {prob_boot.n_dofs} DoF): "
            f"{ev:.1f} device events and {calls:.1f} launch calls an iteration")
        del prob_boot
        torch.cuda.empty_cache()
        b3_rows = {g: dict(device_ms=device_ms(job, 100, kernel="stencil27"),
                           bound_ms=_stencil_bound64(g)) for g, job in b3_jobs.items()}
        log("[profile] K1 float64 at the 3-D packed route's grids, device ms a call "
            "(bound): " + ", ".join(f"{g}={r['device_ms']:.5f} ({r['bound_ms']:.6f})"
                                    for g, r in b3_rows.items()))
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
                           "cavity3d_window": launches3["stencil3d"],
                           "boussinesq3d_packed": sum(b3_grids.values())},
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
    # the halo route of the distributed layer (phase 31c): K3 on the window
    # routes, the ELL kernels in the replicated coarse hierarchy
    halo = {}
    for route, counts in dist["halo_launches"].items():
        for name, counter in counter_of.items():
            if counts.get(counter):
                paths[name][route.replace(" ", "_")] = counts[counter]
                halo[name] = halo.get(name, 0) + counts[counter]
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
    by_row = {"momentum_windows (lagged)": "winmom", "momentum_windows (Newton)": "winmom_newton",
              "momentum_windows 3-D (lagged)": "winmom3d",
              "momentum_windows 3-D (Newton)": "winmom3d_newton",
              "ell_apply direct": "ell_direct", "ell_apply window": "ell_window"}
    for r in rows:
        if r["name"] in by_row:
            r["halo_launches"] = halo.get(by_row[r["name"]], 0)
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
    loss = {g: c * 1e3 * (b3_rows[g]["device_ms"] - b3_rows[g]["bound_ms"])
            for g, c in b3_grids.items()}
    log(f"[done] stencil3d boussinesq3d_packed (float64) launches by grid {b3_grids}; "
        "launches x (device - bound) us " + ", ".join(f"{g}={v:.1f}" for g, v in loss.items())
        + f"; sum {sum(loss.values()):.1f}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    # host_us: the host µs per call of the K1, K2, K4b and K3 rows;
    # halo_launches: the launches of K3 and the ELL kernels on the halo route
    print(json.dumps({"kernels": [{k: r[k] for k in keys + ("host_us", "halo_launches")
                                   if k in keys or k in r} for r in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
