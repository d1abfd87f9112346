#!/usr/bin/env python3
"""Where the time goes in flow_tpu_torch's 3-D cavity step, on one GPU.

    python3 scripts/torch_cavity3d_profile.py [--n 64] [--steps 3] [--json PATH]

1. The stencil kernel against its plain PyTorch version on the V-cycle grids
   of cavity N=64 (65^3, 33^3, 17^3), float32 and float64: device time per
   call from torch.profiler, and wall time per call from CUDA events over
   back-to-back calls (which includes the host's launch cost).
2. The cavity step at --n in float32 with the benchmark's box-path settings:
   host-clock time of each substep (momentum, pressure, correction, CFL),
   synchronised at its ends; then a torch.profiler window over --steps
   steps: device busy time, the device's idle share, kernel launches per
   step and the top operators by device time.

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

from flow_tpu_torch.models.cavity3d import Cavity3DProblem  # noqa: E402
from flow_tpu_torch.navier_stokes.boxfast import BoxPackedStepper  # noqa: E402
from flow_tpu_torch.ops.stencil import (  # noqa: E402
    stencil_apply_3d, stencil_apply_3d_plain,
)

BENCH_SETTINGS = dict(
    newton_tol=0.0, newton_rtol=1.0e-2, linear_rtol=1.0e-1,
    pressure_rtol=1.0e-4, correction_rtol=1.0e-5, cfl_target=1.0, dt_max=0.1,
)


def device_us(events):
    """Device time of the kernels in a profile, microseconds: the kernel
    events' own time where the profiler lists them, else the device time
    that the CPU-side operators carry."""
    cuda = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    if cuda:
        return sum(e.device_time_total for e in cuda)
    return sum(e.self_device_time_total for e in events)


def n_launches(events):
    cuda = sum(1 for e in events if e.device_type == torch.autograd.DeviceType.CUDA)
    launches = sum(1 for e in events if e.name in ("cudaLaunchKernel", "cuLaunchKernel",
                                                  "cudaLaunchKernelExC"))
    return cuda, launches


def profile(fn, reps):
    from torch.profiler import ProfilerActivity, profile as tprofile

    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return prof


def wall_ms(fn, reps):
    for _ in range(3):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def stencil_times():
    rng = np.random.default_rng(0)
    rows = []
    for dtype in (torch.float32, torch.float64):
        for n in (65, 33, 17):
            x = torch.as_tensor(rng.standard_normal((n, n, n)), dtype=dtype,
                                device="cuda")
            k = torch.as_tensor(rng.standard_normal((3, 3, 3)), dtype=dtype,
                                device="cuda")
            row = {"dtype": str(dtype), "grid": n}
            for name, fn in (("kernel", stencil_apply_3d),
                             ("plain", stencil_apply_3d_plain)):
                reps = 100
                fn(x, k)
                prof = profile(lambda: fn(x, k), reps)
                events = prof.events()
                row[f"{name}_device_ms"] = device_us(events) / reps / 1e3
                row[f"{name}_device_events_per_call"] = n_launches(events)[0] / reps
                row[f"{name}_launch_calls_per_call"] = n_launches(events)[1] / reps
                row[f"{name}_wall_ms"] = wall_ms(lambda: fn(x, k), reps)
            rows.append(row)
            print("[stencil]", json.dumps(row), flush=True)
    return rows


def timed(label, fn, acc):
    def wrapper(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        acc[label] = acc.get(label, 0.0) + time.perf_counter() - t0
        return out
    return wrapper


def step_breakdown(n, steps):
    prob = Cavity3DProblem(n=n, mu=0.01, dtype=torch.float32, device="cuda")
    st = BoxPackedStepper(prob.V, prob.Q, prob.u_bcs, prob.p_bcs, prob.rho,
                          prob.mu, **BENCH_SETTINGS)
    Uf, Pf = st.zeros()
    Uf, Pf, dt, _ = st.run(Uf, Pf, 1e-3, n_steps=2)  # warm-up
    torch.cuda.synchronize()

    # host-clock substeps (each synchronised at both ends)
    acc = {}
    plain = {k: getattr(st, k) for k in
             ("_mom_rhs", "_mom_operator", "_mom_krylov", "_pressure_solve",
              "_correction", "_next_dt")}
    for k, fn in plain.items():
        setattr(st, k, timed(k, fn, acc))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Uf, Pf, dt, tel = st.run(Uf, Pf, dt, n_steps=steps)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    for k, fn in plain.items():
        setattr(st, k, fn)
    sub = {k: v / steps * 1e3 for k, v in acc.items()}
    print(f"[step] synchronised substeps, ms/step: {json.dumps(sub)} "
          f"total {total / steps * 1e3:.2f} ms/step", flush=True)

    # unsynchronised run under the profiler
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prof = profile(lambda: st.run(Uf, Pf, dt, n_steps=steps), 1)
    wall = time.perf_counter() - t0
    events = prof.events()
    busy_us = device_us(events)
    n_kernels, n_launch_calls = n_launches(events)
    top = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)[:15]
    top_rows = [{"name": e.key[:80], "device_ms_per_step":
                 e.self_device_time_total / steps / 1e3, "count_per_step":
                 e.count / steps} for e in top]
    out = {
        "n": n,
        "steps": steps,
        "telemetry": {k: v.tolist() for k, v in tel.items()},
        "substeps_ms_per_step_synchronised": sub,
        "synchronised_ms_per_step": total / steps * 1e3,
        "profiled_wall_ms_per_step": wall / steps * 1e3,
        "device_busy_ms_per_step": busy_us / steps / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "device_events_per_step": n_kernels / steps,
        "launch_calls_per_step": n_launch_calls / steps,
        "top_ops": top_rows,
    }
    print("[step]", json.dumps({k: v for k, v in out.items() if k != "top_ops"}),
          flush=True)
    for r in top_rows:
        print("[top]", json.dumps(r), flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--json", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print("[device]", smi, flush=True)
    result = {"device": smi, "stencil": stencil_times(),
              "step": step_breakdown(args.n, args.steps)}
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(result, indent=1))
    print("[device]", smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
