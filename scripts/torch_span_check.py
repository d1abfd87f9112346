#!/usr/bin/env python3
"""The port's flow.* spans (flow_tpu_torch/message.py) on the card, at the
benchmark cells' configurations.

    python3 scripts/torch_span_check.py [--cells karman-10m-bench cavity3d-n96-bench]
        [--warmup 10] [--steps 2] [--json PATH]

For each cell (built from flowbench/'s cell and configuration files, started
from the seeded state, --warmup steps of run):

1. Device rows: one step profiled with the spans as they are and one with
   each span opened as a record_function range instead (USER_SCOPE); the
   CUDA-typed events of each, counted by name, and those named flow.*. The
   benchmark's yardstick counts every CUDA-typed event as device work.
2. Host reads: --steps profiled steps; the flow.sync.* spans a step beside
   the runtime's synchronising calls a step (cudaStreamSynchronize,
   cudaMemcpyAsync, and the device's DtoH copies), and the per-substep
   metrics of flowbench/spans.py with the window's idle time.
3. The cost of spans under the profiler: the profiled steps' wall time with
   spans on and off, in turns (on, off, off, on).

Prints a summary and writes everything as JSON to --json (default
chiprun_out/span_check.json). Needs a CUDA card; imports neither jax nor
flow_tpu.
"""
import argparse
import collections
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from flowbench import harness, spans, yardstick  # noqa: E402
from flowbench.reference.check import initial_velocity, problem_module  # noqa: E402
from flow_tpu_torch import message  # noqa: E402

SYNC_CALLS = ("cudaStreamSynchronize", "cudaMemcpyAsync", "cudaDeviceSynchronize")


def profiled(st, state, n):
    """n steps of run under the profiler -> (state, prof, wall seconds)."""
    from torch.profiler import ProfilerActivity, profile

    U, P, dt = state
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            U, P, dt, _ = st.run(U, P, dt, 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return (U, P, dt), prof, wall


def device_rows(prof):
    cuda = torch.autograd.DeviceType.CUDA
    names = collections.Counter(e.name for e in prof.events() if e.device_type == cuda)
    return {"n": sum(names.values()),
            "flow": {k: v for k, v in names.items() if k.startswith("flow.")},
            "not_kernels": {k: v for k, v in names.items()
                            if "annotation" in k.lower() or k.startswith("flow.")}}


def check_cell(name, warmup, steps):
    cell, cfg = harness.load_cell(name)
    t0 = time.perf_counter()
    sut = harness.build(cell, cfg, "cuda")
    st = sut["stepper"]
    points = torch.as_tensor(sut["dof_points"], dtype=torch.float64, device="cuda")
    scale = problem_module(cfg["problem"]).velocity_scale(cfg)
    U, P = st.to_packed_state(initial_velocity(points, 3100000001, scale),
                              torch.zeros(sut["problem"].Q.n_dofs, dtype=st.dtype,
                                          device="cuda"))
    del points
    state = (U, P, cell["dt0"])
    for _ in range(warmup):
        U, P, dt, _ = st.run(*state, 1)
        state = (U, P, dt)
    torch.cuda.synchronize()
    out = {"cell": name, "build_and_warmup_s": time.perf_counter() - t0,
           "problem_setup_seconds": getattr(sut["problem"], "setup_seconds", None),
           "stepper_setup_seconds": getattr(st, "setup_seconds", None)}

    # 1. device rows: spans as they are, then as record_function ranges
    state, prof, _ = profiled(st, state, 1)
    out["device_rows_span"] = device_rows(prof)
    fast = message._RecordFunctionFast
    message._RecordFunctionFast = torch.profiler.record_function
    try:
        state, prof, _ = profiled(st, state, 1)
    finally:
        message._RecordFunctionFast = fast
    out["device_rows_record_function"] = device_rows(prof)
    del prof

    # 2. host reads and the substeps' idle time
    state, prof, wall = profiled(st, state, steps)
    host = collections.Counter(e.name for e in prof.events()
                               if e.device_type != torch.autograd.DeviceType.CUDA)
    dtoh = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and "DtoH" in e.name)
    tr = yardstick.Trace.from_profiler(prof, wall)
    del prof
    ctx = {"trace": tr, "profile_steps": steps}
    sync_spans = {k: v / steps for k, v in host.items() if k.startswith("flow.sync.")}
    out["per_step"] = {
        "flow_sync_spans": sum(sync_spans.values()), "by_site": sync_spans,
        **{k: host[k] / steps for k in SYNC_CALLS}, "dtoh_copies": dtoh / steps,
        "flow_vcycle": host["flow.vcycle"] / steps, "flow_step": host["flow.step"] / steps,
        "launches": tr.launches / steps, "wall_ms": 1e3 * wall / steps,
        "busy_ms": 1e3 * tr.busy_s / steps,
        "idle_ms": 1e3 * (wall - tr.busy_s) / steps,
        "device_idle_pct": 100.0 * (1.0 - tr.busy_s / wall),
        "momentum_ms": spans.span_ms_per_step(ctx, "flow.momentum"),
        "pressure_ms": spans.span_ms_per_step(ctx, "flow.pressure"),
        "correction_ms": spans.span_ms_per_step(ctx, "flow.correction"),
        "cfl_ms": spans.span_ms_per_step(ctx, "flow.cfl"),
        "momentum_idle_ms": spans.idle_ms_per_step(ctx, "flow.momentum"),
        "pressure_idle_ms": spans.idle_ms_per_step(ctx, "flow.pressure"),
        "correction_idle_ms": spans.idle_ms_per_step(ctx, "flow.correction"),
        "cfl_idle_ms": spans.idle_ms_per_step(ctx, "flow.cfl"),
        "vcycle_launches": spans.launches_per_span(ctx, "flow.vcycle"),
    }
    out["idle_gaps"] = tr.idle_gaps()
    del tr

    # 3. the profiled step's wall time with spans on and off, in turns
    walls = {"on": [], "off": []}
    for mode in ("on", "off", "off", "on"):
        message._RecordFunctionFast = fast if mode == "on" else None
        try:
            state, prof, wall = profiled(st, state, steps)
        finally:
            message._RecordFunctionFast = fast
        del prof
        walls[mode].append(1e3 * wall / steps)
    out["profiled_step_ms"] = walls
    # unprofiled steps, spans off (no profiler): the time loop as the
    # benchmark's window runs it
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    U, P, dt = state
    U, P, dt, tel = st.run(U, P, dt, steps)
    torch.cuda.synchronize()
    out["plain_step_ms"] = 1e3 * (time.perf_counter() - t0) / steps
    out["telemetry_last"] = {k: v.reshape(-1).tolist() for k, v in tel.items()
                             if k.endswith("iters")}
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", nargs="+", default=["karman-10m-bench", "cavity3d-n96-bench"])
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--json", default=str(ROOT / "chiprun_out" / "span_check.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card: nothing measured", file=sys.stderr)
        return 2
    name, limit = harness.card_info()
    results = {"card": name, "power_limit": limit, "torch": torch.__version__,
               "cells": []}
    print(f"{name}, power limit {limit}, torch {torch.__version__}", flush=True)
    for cell in args.cells:
        r = check_cell(cell, args.warmup, args.steps)
        results["cells"].append(r)
        print(json.dumps({k: r[k] for k in ("cell", "device_rows_span",
                                            "device_rows_record_function",
                                            "per_step", "profiled_step_ms",
                                            "plain_step_ms", "telemetry_last")}),
              flush=True)
        torch.cuda.empty_cache()
    path = Path(args.json)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(results, indent=1))
    found = harness.forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
