#!/usr/bin/env python3
"""Where the Stokes bootstrap converges and how the 3-D Boussinesq routes
scale, on one GPU.

    python3 scripts/torch_bootstrap_3d_probe.py [A|B|C|all] [--n N]

A. KarmanProblem(lcar=0.02).stokes_bootstrap(tol=1e-6, max_iter=2000),
   the bootstrap of run_karman_fast(from_rest=False), at n_refine 5 in
   float32 and at n_refine 5, 4, 3 and 2 in float64: the MINRES
   iterations, the true residual, whether it converged, the seconds of the
   problem's setup and of the solve, and the peak device memory.
B. compute_boussinesq_3d(0.02, n=(N, N, 2N), backend="packed") in float64
   (two steps from rest; N = 16 unless --n): the telemetry of each Banach
   sweep (the heat splu's factor seconds apart) and K1's launches by grid.
C. compute_boussinesq_3d(0.0, n=(8, 8, 16), n_refine=2) in float64 (one
   step from rest, the tet heat multigrid): the dofs, the seconds, the peak
   device memory and the telemetry of each sweep.

Prints one line a run; a failure in B or C propagates (a traceback and a
non-zero exit). A's unconverged MINRES is the result probed there: its
line says converged False. Imports neither jax nor flow_tpu.
"""
import argparse
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from flow_tpu_torch import stokes  # noqa: E402
from flow_tpu_torch.models.boussinesq3d import compute_boussinesq_3d  # noqa: E402
from flow_tpu_torch.models.karman import KarmanProblem  # noqa: E402
from flow_tpu_torch.ops.stencil import GRID_LAUNCHES, STENCIL_3D  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("part", nargs="?", default="all", choices=["A", "B", "C", "all"])
    ap.add_argument("--n", type=int, default=16, help="B's box: n=(N, N, 2N)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_bootstrap_3d_probe: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    part = args.part
    if part in ("A", "all"):
        for dtype, nr in ((torch.float32, 5), (torch.float64, 5), (torch.float64, 4),
                          (torch.float64, 3), (torch.float64, 2)):
            t0 = time.perf_counter()
            prob = KarmanProblem(lcar=0.02, n_refine=nr, dtype=dtype, device="cuda")
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            torch.cuda.reset_peak_memory_stats()
            ok = True
            try:
                prob.stokes_bootstrap(tol=1e-6, max_iter=2000)
            except RuntimeError:  # MINRES unconverged: the result being probed
                ok = False
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            print("A", dtype, nr, prob.n_dofs, ok, stokes.last_info, "setup",
                  round(t1 - t0, 2), "solve", round(t2 - t1, 2), "peak",
                  torch.cuda.max_memory_allocated(), flush=True)
            del prob
            torch.cuda.empty_cache()
    if part in ("B", "all"):
        n = (args.n, args.n, 2 * args.n)
        STENCIL_3D.launches = 0
        GRID_LAUNCHES.clear()
        tel = []
        t0 = time.perf_counter()
        compute_boussinesq_3d(0.02, n=n, backend="packed", device="cuda", telemetry=tel)
        torch.cuda.synchronize()
        print("B", n, "total", round(time.perf_counter() - t0, 2), "K1",
              STENCIL_3D.launches, dict(GRID_LAUNCHES), flush=True)
        for r in tel:
            print("B", r, flush=True)
    if part in ("C", "all"):
        tel = []
        t0 = time.perf_counter()
        u, p, th = compute_boussinesq_3d(0.0, n=(8, 8, 16), n_refine=2, device="cuda",
                                         telemetry=tel)
        print("C dofs", u.space.n_dofs, p.space.n_dofs, th.space.n_dofs)
        torch.cuda.synchronize()
        print("C total", round(time.perf_counter() - t0, 2), "peak",
              torch.cuda.max_memory_allocated(), flush=True)
        for r in tel:
            print("C", r, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
