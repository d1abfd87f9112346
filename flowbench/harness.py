"""One run of one cell: set up the program from the cell's files, warm up
through the CFL controller's ramp, step for the window, read the trace
(with --trace 1), check two steps against the plain reference, and print
the result line.

Everything that belongs to one cell, configuration or per-layer metric
sits in a file of its own, found by name:

  flowbench/workloads/<cell>.json   configuration, system, stepper settings,
                                    start, warm-up, profiled steps, limits
  flowbench/configs/<config>.json   the problem as it is run
  flowbench/sut/<system>.py         builds the program's problem and stepper
  flowbench/reference/<problem>.py  the reference's mesh and conditions
  flowbench/metrics/<metric>.py     read(ctx) -> number, or None

and BENCHMARK.json names the metrics each cell reports.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import torch

from . import yardstick
from .reference.check import NAMES, Reference, initial_velocity, problem_module, verdict

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "flow_tpu")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_cell(name):
    cell = load_json(BENCH / "workloads" / f"{name}.json")
    cfg = load_json(BENCH / "configs" / f"{cell['config']}.json")
    return cell, cfg


def cell_metrics(name):
    """(end-to-end, per-layer) metric entries of BENCHMARK.json that cell
    `name` reports."""
    spec = load_json(ROOT / "BENCHMARK.json")

    def mine(m):
        return name in m.get("workloads", [name])

    return ([m for m in spec["end_to_end"] if mine(m)],
            [m for m in spec["per_layer"] if mine(m)])


def metric_reader(name):
    path = BENCH / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"flowbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_info():
    """(name, power limit) of card 0; the limit as nvidia-smi reads it."""
    name = torch.cuda.get_device_name(0)
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        limit = "not read"
    return name, limit or "not read"


def log(*a):
    print(*a, file=sys.stderr, flush=True)


class Substeps:
    """The stepper's substep calls, wrapped on the instance: each records
    the arguments and result of its last call and, with timing, its
    seconds between device syncs."""

    NAMES = ("_pressure_solve", "_correction")

    def __init__(self, stepper, timing, sync):
        self.st, self.timing, self.sync = stepper, timing, sync
        self.last, self.seconds = {}, Counter()

    def __enter__(self):
        for name in self.NAMES:
            plain = getattr(self.st, name)

            def wrapper(*a, _plain=plain, _name=name):
                if self.timing:
                    self.sync()
                    t0 = time.perf_counter()
                out = _plain(*a)
                if self.timing:
                    self.sync()
                    self.seconds[_name] += time.perf_counter() - t0
                self.last[_name] = (a, out)
                return out

            setattr(self.st, name, wrapper)
        return self

    def __exit__(self, *exc):
        for name in self.NAMES:
            delattr(self.st, name)


def checked_step(st, U, P, dt, sync):
    """One step through the stepper's run, with its substeps captured ->
    ((U1, P1, dt1, telemetry), the step in the global layout on the host)."""
    with Substeps(st, False, sync) as sub:
        out = st.run(U, P, dt, 1)
    U1, P1, dt1, _ = out
    Ui = sub.last["_pressure_solve"][0][0]
    host = lambda t: t.detach().to("cpu", torch.float64)  # noqa: E731
    U0g, P0g = st.from_packed_state(U, P)
    U1g, P1g = st.from_packed_state(U1, P1)
    step = {"U0": host(U0g), "P0": host(P0g), "Ui": host(st.from_packed_state(Ui, P1)[0]),
            "U1": host(U1g), "P1": host(P1g), "dt": float(dt), "dt_next": float(dt1)}
    return out, step


def step_failed(tel, settings):
    """Steps of a telemetry whose solves did not converge (by their flags,
    or by an iteration count at its cap) or whose dt is not finite."""
    n = len(tel["dt"])
    bad = ~torch.isfinite(tel["dt"].to("cpu", torch.float64))
    for key in ("momentum_converged", "pressure_converged", "correction_converged"):
        if key in tel:
            bad |= ~tel[key].to("cpu").bool().reshape(n)
    caps = {"linear_iters": 300, "pressure_iters": settings.get("pressure_maxiter", 600),
            "correction_iters": 500}
    for key, cap in caps.items():
        bad |= tel[key].to("cpu") >= cap
    return int(bad.sum())


def build(cell, cfg, device):
    """The system under test of a cell (flowbench/sut/<system>.py)."""
    return importlib.import_module(f"flowbench.sut.{cell['system']}").build(
        cfg, cell["stepper"], device)


def start_and_warm_up(sut, cell, cfg, seed, sync):
    """The start from the seed, its first step checked, then the rest of the
    cell's warm-up steps -> (U, P, dt, the start in the global layout on
    the host, the first step, the warm-up's dt)."""
    st = sut["stepper"]
    dev = st.device
    points = torch.as_tensor(sut["dof_points"], dtype=torch.float64, device=dev)
    scale = problem_module(cfg["problem"]).velocity_scale(cfg)
    U, P = st.to_packed_state(initial_velocity(points, seed, scale),
                              torch.zeros(sut["problem"].Q.n_dofs, dtype=st.dtype, device=dev))
    del points
    U0 = st.from_packed_state(U, P)[0].detach().to("cpu", torch.float64)
    (U, P, dt, _), first = checked_step(st, U, P, cell["dt0"], sync)
    dts = [cell["dt0"], dt]
    for _ in range(cell["warmup_steps"] - 1):
        U, P, dt, _ = st.run(U, P, dt, 1)
        dts.append(dt)
    sync()
    return U, P, dt, U0, first, [float(d) for d in dts]


def run_cell(name, cell, cfg, seed, seconds, trace, device="cuda", t_start=None):
    """One run -> the result dict (its keys in the order they print)."""
    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    e2e, per_layer = cell_metrics(name)
    settings = cell["stepper"]

    # -- set-up: the program, its start from the seed, the warm-up ramp --------
    sut = build(cell, cfg, device)
    st = sut["stepper"]
    U, P, dt, U0_prog, first, warm_dt = start_and_warm_up(sut, cell, cfg, seed, sync)
    setup_s = time.perf_counter() - t_start
    log(f"[setup] {setup_s:.3f} s; warm-up dt {warm_dt}")

    # -- the measured window ----------------------------------------------------
    sub = Substeps(st, True, sync) if trace else None
    if sub:
        sub.__enter__()
    steps, wdts, wtels = 0, [], []
    sync()
    t0 = time.perf_counter()
    while True:
        U, P, dt_next, tel = st.run(U, P, dt, 1)
        wdts.append(dt if torch.is_tensor(dt) else torch.tensor(dt))
        wtels.append(tel)
        dt = dt_next
        steps += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync()
    window_s = time.perf_counter() - t0
    if sub:
        sub.__exit__()
    window_tel = {k: torch.cat([t[k].reshape(-1).to("cpu") for t in wtels])
                  for k in wtels[0]}
    sim_s = float(torch.stack([d.to("cpu", torch.float64) for d in wdts]).sum())
    failed = step_failed(window_tel, settings)
    log(f"[window] {steps} steps in {window_s:.3f} s, simulated {sim_s:.6g} s, "
        f"dt {float(wdts[0]):.6g} .. {float(wdts[-1]):.6g}")

    # -- the trace: a bounded number of profiled steps after the window ----------
    ctx = {"sut": sut, "stepper": st, "state": (U, P, dt), "window_tel": window_tel,
           "steps": steps, "window_s": window_s, "sync": sync,
           "substep_seconds": dict(sub.seconds) if sub else {}, "trace": None}
    device_info = {"platform": "gpu" if on_card else dev.type,
                   "kind": card_info()[0] if on_card else "cpu", "count": 1}
    breakdown = None
    if trace:
        from flow_tpu_torch.ops import stencil

        grid0 = Counter(stencil.GRID_LAUNCHES)
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        n_prof = cell["profile_steps"]
        with profile(activities=acts) as prof:
            sync()
            tp = time.perf_counter()
            for _ in range(n_prof):
                U, P, dt, _ = st.run(U, P, dt, 1)
            sync()
            prof_wall = time.perf_counter() - tp
        tr = yardstick.Trace.from_profiler(prof, prof_wall)
        del prof
        ctx.update(trace=tr, profile_steps=n_prof, state=(U, P, dt),
                   grid_launches=Counter(stencil.GRID_LAUNCHES) - grid0)
        device_info.update(busy_s=tr.busy_s, window_s=prof_wall)
        breakdown = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
        metrics = {}
        for m in per_layer:
            value = metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        del tr
        ctx["trace"] = None

    # -- the step checked after the window, and the peak ------------------------
    (U, P, dt, _), last = checked_step(st, U, P, dt, sync)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    device_info["memory_peak_bytes"] = peak
    if on_card:
        device_info["power_limit"] = card_info()[1]
    if not trace:
        values = {"steps_per_s": steps / window_s, "sim_s_per_s": sim_s / window_s,
                  "peak_mem_gib": peak / 2**30, "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in e2e}

    # -- free the program, then the reference judges ------------------------------
    prog_points = sut["dof_points"]
    stepper_settings = {"cfl_target": settings["cfl_target"], "dt_max": settings["dt_max"]}
    del sut, st, U, P, dt, ctx
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    tr0 = time.perf_counter()
    ref = Reference(cfg, dev)
    if ref.attach(prog_points):
        checks = ref.judge(U0_prog, seed, first, last, stepper_settings)
    else:
        checks = {k: math.inf for k in NAMES}
        log("[check] the program's dofs do not match the reference mesh")
    sync()
    log(f"[check] reference {time.perf_counter() - tr0:.3f} s")
    limits = cell["limits"]
    correct = verdict(checks, limits)

    result = {"correct": correct, "attempted": steps, "failed": failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": checks[k], "limit": limits[k]} for k in NAMES}
    return result


def main(args, t_start):
    cell, cfg = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"[run] needs {cell['chips']} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result")
        return 2
    name, limit = card_info()
    log(f"[run] {args.workload} seed {args.seed} on {name}, power limit {limit}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    result = run_cell(args.workload, cell, cfg, args.seed, args.seconds, args.trace,
                      "cuda", t_start)
    found = forbidden_modules()
    if found:
        log(f"[run] modules of JAX or the JAX package were loaded: {found}: no result")
        return 3
    for k, v in result["checks"].items():
        log(f"{k} {v['value']:.6e} limit {v['limit']:.6e}")
    print(json.dumps(result), flush=True)
    return 0
