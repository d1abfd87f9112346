#!/usr/bin/env python3
"""Where the time goes in flow_tpu_torch's Karman step on the window-kernel
route, on one GPU.

    python3 scripts/torch_karman_profile.py [--lcar 0.02] [--n-refine 5]
                                             [--steps 3] [--json PATH]
                                             [--convection lagged|newton]

1. The Karman step (FastStepper, window route) in float32: host-clock time
   of each substep (pressure, correction, and the rest: momentum residual
   and solve, CFL), synchronised at its ends, before any profiler has run in
   the process. --convection lagged (the default) takes the benchmark's
   lagged settings; newton takes run_karman_fast's defaults (Newton,
   backward Euler, the driver's tolerances).
2. The window kernels at the main path's layouts: the momentum kernel (K3,
   lagged, and with --convection newton also Newton, with the tables of the
   run's state) on the velocity layout and the stiffness kernel (K4b) on the
   pressure layout, float32, each against its plain PyTorch version: device
   time per call from torch.profiler, and wall time per call from CUDA
   events over back-to-back calls (which includes the host's launch cost).
3. A torch.profiler window over --steps steps: device busy time, the
   device's idle share, kernel launches per step and the top operators by
   device time.

Prints a summary, and writes the full result as JSON to --json if given.
Imports neither jax nor flow_tpu.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from flow_tpu_torch.attic import winkernel, winmom  # noqa: E402
from flow_tpu_torch.models.karman import KarmanProblem  # noqa: E402
from flow_tpu_torch.navier_stokes.fast import FastStepper  # noqa: E402
from flow_tpu_torch.solvers.multigrid import P1Hierarchy  # noqa: E402

sys.path.insert(0, str(ROOT / "scripts"))
from torch_cavity3d_profile import (  # noqa: E402
    device_us, n_launches, profile, timed, wall_ms,
)

KARMAN_SETTINGS = {
    "lagged": dict(
        convection="lagged", rotational_form=True, momentum_solver="bicgstab",
        newton_tol=0.0, newton_rtol=1e-2, pressure_rtol=3e-4,
        pressure_maxiter=600, correction_rtol=1e-4, cfl_target=1.0, dt_max=1.0,
        packed=False, winkernel=True,
    ),
    # run_karman_fast's defaults (flow_tpu/models/karman.py:301-327)
    "newton": dict(
        convection="newton", rotational_form=True, momentum_solver="bicgstab",
        newton_tol=0.0, newton_rtol=1e-3, newton_maxiter=3, linear_rtol=1e-4,
        pressure_rtol=1e-4, correction_rtol=1e-5, cfl_target=1.0, dt_max=1.0,
        packed=False, winkernel=True,
    ),
}


def build(lcar, n_refine, convection):
    prob = KarmanProblem(lcar=lcar, n_refine=n_refine, dtype=torch.float32,
                         device="cuda")
    st = FastStepper(prob.V, prob.Q, prob.u_bcs, prob.p_bcs, prob.rho, prob.mu,
                     **KARMAN_SETTINGS[convection])
    hier = P1Hierarchy(prob.mesh_hierarchy, bc_mask=st.mask_p, smoother_degree=3,
                       winkernel=True, fine_window=st.K_Q)
    st.pressure_precond = hier.v_cycle
    return prob, st


def kernel_times(st, state):
    rng = np.random.default_rng(0)
    mo, ko = st.winmom, st.K_Q
    T = torch.as_tensor(0.01 * rng.standard_normal((mo.wl.n, 2)), dtype=torch.float32,
                        device="cuda")
    Tq = mo.transport_qp(T)
    xp = torch.zeros((2, mo.wl.n_pad), device="cuda")
    xp[:, :mo.wl.n] = torch.as_tensor(rng.standard_normal((2, mo.wl.n)),
                                      dtype=torch.float32)
    w = (1.0, 1e-3, 1e-3 * st.mu / st.rho)
    scal = mo._scal(*w)
    x = torch.zeros(ko.wl.n_pad, device="cuda")
    x[:ko.wl.n] = torch.as_tensor(rng.standard_normal(ko.wl.n), dtype=torch.float32)
    cases = {
        "winmom": (lambda: mo.windows(xp, Tq, *w),
                   lambda: winmom.momentum_windows_plain(
                       xp, mo.lidx, mo.valid, mo.detj, mo.G4, mo.Cg4, Tq, mo.tabs,
                       scal, mo.wl.S, mo.wl.W)),
        "winstiff": (lambda: ko.windows(x),
                     lambda: winkernel.stiffness_windows_plain(
                         x, ko.lidx, ko.valid, ko.Cg, ko.kref, ko.wl.S, ko.wl.W)),
    }
    if not st.lagged:
        Tn, Un, Gn = mo.state_qp(state[0])
        cases["winmom_newton"] = (
            lambda: mo.windows(xp, Tn, *w, Un, Gn),
            lambda: winmom.momentum_windows_plain(
                xp, mo.lidx, mo.valid, mo.detj, mo.G4, mo.Cg4, Tn, mo.tabs, scal,
                mo.wl.S, mo.wl.W, Un, Gn))
    rows = []
    for name, (kernel, plain) in cases.items():
        row = {"kernel": name}
        for tag, fn in (("kernel", kernel), ("plain", plain)):
            reps = 50 if tag == "kernel" else 5
            fn()
            prof = profile(fn, reps)
            events = prof.events()
            row[f"{tag}_device_ms"] = device_us(events) / reps / 1e3
            row[f"{tag}_device_events_per_call"] = n_launches(events)[0] / reps
            row[f"{tag}_wall_ms"] = wall_ms(fn, reps)
        rows.append(row)
        print("[kernel]", json.dumps(row), flush=True)
    return rows


def step_substeps(st, steps):
    """Warm up 2 steps, then time --steps steps with the pressure and
    correction substeps synchronised at their ends. Returns the state to
    continue from and the timings."""
    U, P = st.zeros()
    U, P, dt, _ = st.run(U, P, 1e-4, n_steps=2)  # warm-up
    torch.cuda.synchronize()
    acc = {}
    plain = {k: getattr(st, k) for k in ("_pressure_solve", "_correction")}
    for k, fn in plain.items():
        setattr(st, k, timed(k, fn, acc))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    U1, P1, dt1, tel = st.run(U, P, dt, n_steps=steps)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    for k in plain:
        delattr(st, k)
    sub = {k: v / steps * 1e3 for k, v in acc.items()}
    sub["momentum_and_cfl"] = total / steps * 1e3 - sum(sub.values())
    print(f"[step] synchronised substeps, ms/step: {json.dumps(sub)} "
          f"total {total / steps * 1e3:.2f} ms/step", flush=True)
    out = {
        "n_dofs": 2 * st.V.n_dofs + st.Q.n_dofs,
        "steps": steps,
        "telemetry": {k: v.tolist() for k, v in tel.items()},
        "substeps_ms_per_step_synchronised": sub,
        "synchronised_ms_per_step": total / steps * 1e3,
    }
    return (U1, P1, dt1), out


def step_profile(st, state, steps):
    """An unsynchronised run of --steps steps under the profiler."""
    U, P, dt = state
    winmom.WINMOM.launches = winmom.WINMOM_NEWTON.launches = 0
    winkernel.WINSTIFF.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prof = profile(lambda: st.run(U, P, dt, n_steps=steps), 1)
    wall = time.perf_counter() - t0
    events = prof.events()
    busy_us = device_us(events)
    n_kernels, n_launch_calls = n_launches(events)
    top = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)[:15]
    top_rows = [{"name": e.key[:80], "device_ms_per_step":
                 e.self_device_time_total / steps / 1e3, "count_per_step":
                 e.count / steps} for e in top]
    out = {
        "profiled_wall_ms_per_step": wall / steps * 1e3,
        "device_busy_ms_per_step": busy_us / steps / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "device_events_per_step": n_kernels / steps,
        "launch_calls_per_step": n_launch_calls / steps,
        "winmom_launches_per_step": winmom.WINMOM.launches / steps,
        "winmom_newton_launches_per_step": winmom.WINMOM_NEWTON.launches / steps,
        "winstiff_launches_per_step": winkernel.WINSTIFF.launches / steps,
        "top_ops": top_rows,
    }
    print("[profile]", json.dumps({k: v for k, v in out.items() if k != "top_ops"}),
          flush=True)
    for r in top_rows:
        print("[top]", json.dumps(r), flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--lcar", type=float, default=0.02)
    ap.add_argument("--n-refine", type=int, default=5)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--json", type=Path, default=None)
    ap.add_argument("--convection", choices=("lagged", "newton"), default="lagged")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print("[device]", smi, flush=True)
    prob, st = build(args.lcar, args.n_refine, args.convection)
    state, step = step_substeps(st, args.steps)
    result = {"device": smi, "convection": args.convection, "step": step,
              "kernels": kernel_times(st, state),
              "profile": step_profile(st, state, args.steps)}
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(result, indent=1))
    print("[device]", smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
