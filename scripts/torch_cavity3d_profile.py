#!/usr/bin/env python3
"""Where the time goes in flow_tpu_torch's 3-D cavity step, on one GPU.

    python3 scripts/torch_cavity3d_profile.py [--route box|window] [--n 64]
        [--steps 3] [--root DIR] [--json PATH]

1. The stencil kernel against its plain PyTorch version on the V-cycle grids
   of cavity N=64 (65^3, 33^3, 17^3), float32 and float64: device time per
   call from torch.profiler, and wall time per call from CUDA events over
   back-to-back calls (which includes the host's launch cost).
2. The cavity step at --n in float32, on the box path (--route box, the
   default: BoxPackedStepper at the benchmark's box-path settings) or on
   FastStepper's window route (--route window: run_cavity3d_fast with
   winkernel=True at its defaults, after 2 warm-up steps): host-clock time
   of each substep, synchronised at its ends (box: momentum, pressure,
   correction, CFL; window: the Newton momentum with its residuals and
   Newton tables, pressure, correction); then a torch.profiler window over
   --steps steps: device busy time, the device's idle share, kernel
   launches per step and the top operators by device time. The window
   route also reports its setup seconds and the window kernels' launches
   per step (K3 3-D lagged and Newton, K4b 3-D, K1).

Prints a summary, and writes the full result as JSON to --json if given.
--root imports flow_tpu_torch from another checkout (the parent commit,
say), so that both trees run the same script. Imports neither jax nor
flow_tpu.
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
# --root DIR, read before the imports below
sys.path.insert(0, sys.argv[sys.argv.index("--root") + 1] if "--root" in sys.argv
                else str(ROOT))

from flow_tpu_torch.models.cavity3d import (  # noqa: E402
    Cavity3DProblem, run_cavity3d_fast,
)
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
    out = profiled_steps(lambda: st.run(Uf, Pf, dt, n_steps=steps), steps)
    out = {"n": n, "steps": steps,
           "telemetry": {k: v.tolist() for k, v in tel.items()},
           "substeps_ms_per_step_synchronised": sub,
           "synchronised_ms_per_step": total / steps * 1e3, **out}
    report(out)
    return out


def profiled_steps(run, steps):
    """Device busy time, idle share, launches and top operators per step of
    `run` (which takes `steps` steps) under torch.profiler."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prof = profile(run, 1)
    wall = time.perf_counter() - t0
    events = prof.events()
    busy_us = device_us(events)
    n_kernels, n_launch_calls = n_launches(events)
    top = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)[:15]
    top_rows = [{"name": e.key[:80], "device_ms_per_step":
                 e.self_device_time_total / steps / 1e3, "count_per_step":
                 e.count / steps} for e in top]
    return {
        "profiled_wall_ms_per_step": wall / steps * 1e3,
        "device_busy_ms_per_step": busy_us / steps / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "device_events_per_step": n_kernels / steps,
        "launch_calls_per_step": n_launch_calls / steps,
        "top_ops": top_rows,
    }


def report(out):
    print("[step]", json.dumps({k: v for k, v in out.items() if k != "top_ops"}),
          flush=True)
    for r in out["top_ops"]:
        print("[top]", json.dumps(r), flush=True)


def window_step_breakdown(n, steps):
    from flow_tpu_torch.attic.winkernel import WINSTIFF3D
    from flow_tpu_torch.attic.winmom import WINMOM3D, WINMOM3D_NEWTON
    from flow_tpu_torch.ops.stencil import STENCIL_3D

    t0 = time.perf_counter()
    warm = run_cavity3d_fast(num_steps=2, n=n, winkernel=True, dtype=torch.float32,
                             device="cuda")
    torch.cuda.synchronize()
    setup = {"setup_s": warm["setup_seconds"], "layouts_s": warm["layout_seconds"],
             "two_warm_up_steps_s": time.perf_counter() - t0 - warm["setup_seconds"]}
    print(f"[setup] {json.dumps(setup)}", flush=True)
    st, U, P, dt = warm["stepper"], warm["U"], warm["P"], warm["dt"]

    # host-clock substeps (each synchronised at both ends); the residuals
    # and the Newton tables run inside the Newton momentum
    acc = {}
    hooks = ((st, "_newton"), (st, "_pressure_solve"), (st, "_correction"),
             (st.ctx, "residual"), (st.winmom, "state_qp"))
    for obj, name in hooks:
        setattr(obj, name, timed(name, getattr(obj, name), acc))
    kernels = (WINMOM3D, WINMOM3D_NEWTON, WINSTIFF3D, STENCIL_3D)
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    U1, P1, dt1, tel = st.run(U, P, dt, n_steps=steps)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    for obj, name in hooks:
        delattr(obj, name)
    launches = {name: k.launches / steps for name, k in zip(
        ("winmom3d_lagged", "winmom3d_newton", "winstiff3d", "stencil3d"), kernels)}
    sub = {k: v / steps * 1e3 for k, v in acc.items()}
    sub["bicgstab_and_rest"] = sub["_newton"] - sub["residual"] - sub["state_qp"]
    print(f"[step] synchronised substeps, ms/step: {json.dumps(sub)} "
          f"total {total / steps * 1e3:.2f} ms/step; launches/step {json.dumps(launches)}",
          flush=True)

    out = profiled_steps(lambda: st.run(U1, P1, dt1, n_steps=steps), steps)
    out = {"n": n, "steps": steps, "route": "window", **setup,
           "telemetry": {k: v.tolist() for k, v in tel.items()},
           "substeps_ms_per_step_synchronised": sub,
           "synchronised_ms_per_step": total / steps * 1e3,
           "launches_per_step": launches,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(), **out}
    report(out)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--route", choices=("box", "window"), default="box")
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--json", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print("[device]", smi, "root", args.root, flush=True)
    if args.route == "window":
        result = {"device": smi, "step": window_step_breakdown(args.n, args.steps)}
    else:
        result = {"device": smi, "stencil": stencil_times(),
                  "step": step_breakdown(args.n, args.steps)}
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(result, indent=1))
    print("[device]", smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
