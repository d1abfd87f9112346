#!/usr/bin/env python3
"""Device times of the structured stencils K1 (csrc/stencil3d.cu, 27
points) and K2 (csrc/stencil2d.cu, 9 points) at the grids of their paths,
for an A/B between two checkouts and a sweep of their tile plans.

    python3 scripts/torch_stencil_bench.py [--root DIR] [--save F]
        [--compare F] [--sweep] [--only TEXT] [--json F]

Grids: K1 at 65^3 and 33^3 (the box cavity's and the 3-D window route's
pressure grid at N=64 and the next multigrid level), K2 at 2,049^2 down to
129^2 (the structured2d hierarchy's levels), float32; inputs and
coefficients made from a seed. For each: device µs a call from
torch.profiler with the L2 cache warm and cold (after a 64 MB write, as
chip_smoke.py flushes it, whose dirty lines the kernel then evicts; and
after a 64 MB read, which leaves clean ones), wall
µs from CUDA events over back-to-back calls, host µs a call (perf_counter
over 200 calls enqueued with no synchronisation, the least of five loops,
taken before any profiler session) of the checked wrapper
stencil_apply_{2,3}d and, where the checkout has it, of the operator's
launch (ops/stencil.StencilLaunch, fixed at construction); the bound
(float32 bytes of x and y over 3.35 TB/s). --only keeps the grids whose
name holds TEXT ("2049", "x65", ...).

--root imports flow_tpu_torch from another checkout (the parent commit,
say) through the public stencil_apply_{2,3}d, so both trees run the same
script; --save writes the outputs at every level grid and at ragged grids
(partial tiles, strips and chunks; sides of 1, 2 and 3) in float32 and
float64, --compare holds them bitwise against a saved run. --sweep (this
tree only) times the tile plans of plan_2d (columns a tile x rows a strip)
and plan_3d ((y, z) tile x planes a chunk) at each grid against the rule's
choice and checks that every plan gives the same outputs bitwise. Needs the
card; imports neither jax nor flow_tpu.
"""
import argparse
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
LEVELS = [(65, 65, 65), (33, 33, 33),
          (2049, 2049), (1025, 1025), (513, 513), (257, 257), (129, 129)]
RAGGED = [(17, 17, 17), (5, 6, 7), (2, 7, 9), (1, 4, 3), (3, 1, 70), (1, 1, 1),
          (40, 30, 100), (65, 65), (1, 257), (257, 1), (7, 13), (2, 3), (3, 2), (1, 1),
          (1000, 777)]
# the sweep: (tile, rows) of each grid; 2-D tiles are columns (a thread
# each), 3-D tiles (y, z) points
SWEEP = {
    (65, 65, 65): [(t, r) for t in ((1, 65), (2, 65), (3, 65), (4, 33), (7, 33))
                   for r in (2, 3, 4, 5, 6, 8, 13)],
    (33, 33, 33): [(t, r) for t in ((1, 33), (2, 33), (4, 33), (7, 33), (3, 17))
                   for r in (1, 2, 3, 4, 6, 11)],
    **{(n, n): [(t, r) for t in (64, 128, 256) for r in (1, 2, 4, 8, 16, 24, 32)]
       for n in (2049, 1025, 513, 257, 129)},
}
KERNEL_NAMES = {3: "stencil27_kernel", 2: "stencil9_kernel"}
HBM_BYTES_PER_S = 3.35e12


def name_of(shape):
    return "x".join(str(s) for s in shape)


def device_us(fn, name, reps=50):
    """Mean device µs a call of the kernels whose name holds `name`, over
    the events the profiler kept (it drops some in a long session; a session
    that kept none is run again, at most three times)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name]
        if ev:
            return sum(e.device_time_total for e in ev) / len(ev)
    raise RuntimeError(f"the profiler shows no event of {name}")


def wall_us(fn, reps=200):
    for _ in range(3):
        fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return 1e3 * a.elapsed_time(b) / reps


def host_us(fn, calls=200, loops=5):
    """Host µs a call: perf_counter over `calls` calls enqueued back to back
    with no synchronisation, divided by the count; the least of `loops`
    such loops (the host's clock spreads more than the device's)."""
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


def inputs(shape, dtype):
    """x and the coefficients of a grid, made from a seed of its shape."""
    rng = np.random.default_rng(sum(shape) * 131 + len(shape))
    x = torch.as_tensor(rng.standard_normal(shape), dtype=dtype, device="cuda")
    k = torch.as_tensor(rng.standard_normal((3,) * len(shape)), dtype=dtype, device="cuda")
    return x, k


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--save")
    ap.add_argument("--compare")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--only")
    ap.add_argument("--json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_stencil_bench: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, args.root)
    from flow_tpu_torch.ops import stencil

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"[device] {smi.stdout.strip()} root={args.root}", flush=True)
    apply = {3: stencil.stencil_apply_3d, 2: stencil.stencil_apply_2d}
    lean = getattr(stencil, "StencilLaunch", None)

    # the outputs, for --save / --compare
    outputs = {}
    for shape in LEVELS + RAGGED:
        for dtype in (torch.float32, torch.float64):
            x, k = inputs(shape, dtype)
            y = apply[len(shape)](x, k)
            if not torch.equal(apply[len(shape)](x, k), y):
                raise SystemExit(f"{shape} {dtype}: two calls differ")
            outputs[f"{name_of(shape)} {dtype}"] = y.cpu()

    flush = torch.empty(16 << 20, device="cuda")
    report = []
    grids = [s for s in LEVELS if args.only is None or args.only in name_of(s)]
    for shape in grids:
        dim = len(shape)
        x, k = inputs(shape, torch.float32)
        fn = functools.partial(apply[dim], x, k)
        kname = KERNEL_NAMES[dim]
        n = x.numel()
        row = dict(grid=name_of(shape), kernel=kname,
                   bound_us=1e6 * (2 * 4 * n + 4 * 3**dim) / HBM_BYTES_PER_S)
        # the host clocks first: a profiler session slows later host code
        row.update(wall_us=wall_us(fn), host_us=host_us(fn))
        if lean is not None:
            launch = lean(k, shape)
            xf = x.reshape(-1)
            if not torch.equal(launch(xf).reshape(shape), fn()):
                raise SystemExit(f"{shape}: StencilLaunch differs from stencil_apply")
            row.update(plan=str(launch.plan), lean_wall_us=wall_us(lambda: launch(xf)),
                       lean_host_us=host_us(lambda: launch(xf)))
        row.update(device_us=device_us(fn, kname),
                   device_cold_us=device_us(lambda: (flush.zero_(), fn()), kname),
                   device_cold_read_us=device_us(lambda: (flush.sum(), fn()), kname))
        print(json.dumps(row), flush=True)
        report.append(row)
        if not args.sweep:
            continue
        planner = "plan_3d" if dim == 3 else "plan_2d"
        rule = getattr(stencil, planner)
        y = fn()
        try:
            for tile, rows in SWEEP[shape]:
                setattr(stencil, planner, functools.partial(rule, tile=tile, rows=rows))
                plan = stencil.plan(shape, 132)
                same = torch.equal(fn(), y)
                point = dict(grid=name_of(shape), sweep=True, tile=tile, rows=rows,
                             grid_dims=plan.grid, threads=plan.threads,
                             device_us=device_us(fn, kname), bitwise_equal=same)
                print(json.dumps(point), flush=True)
                report.append(point)
                if not same:
                    raise SystemExit(f"{shape}: tile {tile} rows {rows} differs bitwise")
        finally:
            setattr(stencil, planner, rule)
    if args.save:
        torch.save(outputs, args.save)
    if args.compare:
        ref = torch.load(args.compare)
        diff = [key for key in outputs if not torch.equal(outputs[key], ref[key])]
        print(f"[compare] against {args.compare}: {len(outputs)} outputs "
              + ("bitwise equal" if not diff else f"differ: {diff}"), flush=True)
        if diff:
            return 1
    if args.json:
        Path(args.json).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
