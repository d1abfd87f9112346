#!/usr/bin/env python3
"""Readings from which a cell's limits are set, many seeds in one process:

    python3 flowbench/calibrate.py --workload <name> --seeds 1,2,... \
        [--control-seeds 7,8,9] [--tf32-seeds 4,5,6] [--seconds 20]

For each seed of --seeds: the program's start from the seed, its first
step, the warm-up, a window of --seconds and the step after it, judged as
a run judges them (Reference.judge and verdict of
flowbench/reference/check.py). For each seed of --control-seeds the same
run of the program, and then the control in its place: the reference
computing each checked step from the program's state in CONTROL_DTYPE (and
the start rounded to it). For each seed of --tf32-seeds the program itself
with its float32 matmuls and convolutions in TF32, judged alike. One JSON
line per seed on standard output, with the cell's verdict on it. The
program is built once; its states are judged with the reference beside it
on the card.
"""
import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from flowbench import harness  # noqa: E402
from flowbench.reference.check import CONTROL_DTYPE, Reference, verdict  # noqa: E402


def run_seed(sut, cell, cfg, seed, seconds, sync):
    """The program from `seed`: its start, the two checked steps, the
    window's step count."""
    st = sut["stepper"]
    U, P, dt, U0, first, _ = harness.start_and_warm_up(sut, cell, cfg, seed, sync)
    t0, steps = time.perf_counter(), 0
    while time.perf_counter() - t0 < seconds:
        U, P, dt, _ = st.run(U, P, dt, 1)
        steps += 1
    (U, P, dt, _), last = harness.checked_step(st, U, P, dt, sync)
    return U0, [first, last], steps


@contextlib.contextmanager
def tf32():
    """The program one rung below its stated float32 with TF32 off (which
    flow_tpu_torch sets on import): its matmuls and cuDNN convolutions in
    TF32."""
    flags = torch.backends.cuda.matmul, torch.backends.cudnn
    old = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = True
    try:
        yield
    finally:
        for f, v in zip(flags, old):
            f.allow_tf32 = v


def control_settings(cell):
    """What the control takes of the cell's stepper settings."""
    s = cell["stepper"]
    return {"cfl_target": s["cfl_target"], "dt_max": s["dt_max"],
            "momentum_rtol": s["newton_rtol"], "pressure_rtol": s["pressure_rtol"],
            "pressure_maxiter": s["pressure_maxiter"], "correction_rtol": s["correction_rtol"]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--tf32-seeds", default="")
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    cell, cfg = harness.load_cell(args.workload)
    sync = torch.cuda.synchronize
    sut = harness.build(cell, cfg, "cuda")
    ref = Reference(cfg, "cuda")
    if not ref.attach(sut["dof_points"]):
        print("the program's dofs do not match the reference mesh", file=sys.stderr)
        return 1
    settings = control_settings(cell)
    seeds = [int(x) for x in args.seeds.split(",") if x]
    control = [int(x) for x in args.control_seeds.split(",") if x]
    tf32_seeds = [int(x) for x in args.tf32_seeds.split(",") if x]

    def emit(seed, t, U0, steps, **extra):
        checks = ref.judge(U0, seed, *steps, settings)
        row = {"seed": seed, "t": t, **extra, **checks,
               "correct": verdict(checks, cell["limits"])}
        print(json.dumps(row), flush=True)

    for seed in tf32_seeds:
        with tf32():
            U0, steps, n = run_seed(sut, cell, cfg, seed, args.seconds, sync)
        emit(seed, "control tf32 (the program)", U0, steps, window_steps=n)
    for seed in seeds + control:
        U0, steps, n = run_seed(sut, cell, cfg, seed, args.seconds, sync)
        emit(seed, "program", U0, steps, window_steps=n)
        if seed in control:
            lowp = [ref.control_step(st["U0"], st["P0"], st["dt"], settings) for st in steps]
            emit(seed, f"control {CONTROL_DTYPE}", U0.to(CONTROL_DTYPE), lowp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
