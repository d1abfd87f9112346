#!/usr/bin/env python3
"""Device times of the cluster kernels K4a (csrc/winmass.cu), K5
(csrc/winform.cu), K4b 3-D P1 and K4b P2 (csrc/winstiff.cu's winstiff_p1_3d,
winstiff_p2_2d and winstiff_p2_3d) and K3 (csrc/winmom.cu in 2-D,
winmom3d.cu in 3-D, lagged and Newton) at the layouts of their paths, for
an A/B between two checkouts and a sweep of the cluster launch of K4a, K5,
K4b P2 and K3.

    python3 scripts/torch_window_cluster_bench.py [--root DIR] [--save F]
        [--compare F] [--sweep] [--only TEXT] [--json F]

Layouts: the NL = 10 P2 tet layout of box_mesh N=32 (nb = 68, C = 3,038)
for K4a, K5 and K4b 3-D P2, the NL = 6 formwin2d layout of
unit_square_mesh(1024, "right") P2 (nb = 1,026, C = 2,048) for K4a and K5,
the NL = 6 layout of unit_square_mesh(256, "right") P2 (nb = 121, C =
1,086) for K4b 2-D P2 (the layouts of chip_smoke.py's P2 Poisson solves),
the cavity's N=64 P1 pressure layout (nb = 68, C = 23,958) for K4b 3-D
P1, the cavity's vector-P2 velocity layouts at N=64 (nb = 525, C =
3,063) and N=32 (nb = 68, C = 3,038) for K3 3-D, whose tables come from a
random velocity field (0.1 x a standard normal) and the weights of a
momentum matvec at dt = 1e-3, and the Karman 1.9M velocity layout
(KarmanProblem(lcar=0.02, n_refine=5): nb = 552, C = 771) for K3 2-D,
from a random velocity field (0.01 x a standard normal) and the weights
of a momentum matvec at dt = 1e-3; float32, inputs and element matrices
made from a seed. --only keeps the layouts whose name holds TEXT.
For each kernel: device µs per call from torch.profiler with the L2 cache
warm and cold (after a 64 MB write), wall µs from CUDA events over
back-to-back calls, and host µs per call (perf_counter over 200 calls
enqueued with no synchronisation, the least of five loops, taken before
any profiler session). --root imports flow_tpu_torch from
another checkout (the parent commit, say) through the operators' public
windows(), so both trees run the same script; --save writes the windows,
--compare holds them bitwise against a saved run. --sweep (this tree only)
times every cluster size and block size of the launch against the rule's
choice and checks that all give the same windows bitwise. Needs the card;
imports neither jax nor flow_tpu.
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
# (blocks a cluster, threads a block) of each layout's sweep
SWEEP = {"tets N=32": ((1, 1024), (1, 512), (2, 512), (2, 256), (4, 256), (2, 1024)),
         "formwin2d": ((1, 512), (1, 256), (1, 1024), (2, 512)),
         "tri n=256": ((1, 1024), (1, 512), (1, 256), (2, 512), (2, 1024)),
         "cavity N=64 velocity": ((2, 512), (2, 384), (2, 256), (3, 512), (3, 384),
                                  (3, 256), (4, 512), (4, 256)),
         "cavity N=32 velocity": ((2, 512), (2, 384), (2, 256), (3, 512), (3, 384),
                                  (3, 256), (4, 512), (4, 256)),
         "karman 1.9M velocity": ((1, 512), (1, 416), (2, 512), (2, 416), (2, 384),
                                  (3, 288), (3, 512), (4, 256), (6, 160), (8, 128))}
# the name of each operator's kernel in the profiler (K4b P2: the scratch
# kernel winstiff_kernel of an earlier checkout, or the cluster kernel)
KERNEL_NAMES = {"winmass": "winmass_kernel", "winform": "winform_kernel",
                "winstiff_cluster": "winstiff_cluster_kernel", "winstiff_p2": "winstiff",
                "winmom3d": "winmom3d_kernel", "winmom3d_newton": "winmom3d_kernel",
                "winmom": "winmom_kernel", "winmom_newton": "winmom_kernel"}


def device_us(fn, name, reps=30):
    """Mean device µs per call of the kernels whose name holds `name`."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name]
    if not ev:
        raise RuntimeError(f"the profiler shows no event of {name}")
    return sum(e.device_time_total for e in ev) / len(ev)


def wall_us(fn, reps=100):
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
    """Host µs per call: perf_counter over `calls` calls enqueued back to
    back with no synchronisation, divided by the count; the least of
    `loops` such loops (the host's clock spreads more than the device's)."""
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


def counter_of(name, NL):
    """The launch counter (a Kernel) of an operator of layouts()."""
    from flow_tpu_torch.attic import winform, winkernel, winmom

    if name.startswith("winmom3d"):
        return winmom.WINMOM3D_NEWTON if name.endswith("newton") else winmom.WINMOM3D
    if name.startswith("winmom"):
        return winmom.WINMOM_NEWTON if name.endswith("newton") else winmom.WINMOM
    if name == "winstiff_p2":
        return winkernel.WINSTIFF_P2 if NL == 6 else winkernel.WINSTIFF3D_P2
    return {"winmass": winkernel.WINMASS, "winform": winform.WINFORM,
            "winstiff_cluster": winkernel.WINSTIFF3D}[name]


def _padded(op, seed):
    x = torch.zeros(op.wl.n_pad, device="cuda")
    x[:op.wl.n] = torch.as_tensor(np.random.default_rng(seed).standard_normal(op.wl.n),
                                  dtype=torch.float32)
    return x


class Momentum:
    """K3 at a layout, as the bench takes an operator: windows(x) of one
    variant with fixed tables, and the layout's lidx, valid, wl and lists."""

    def __init__(self, op, Tq, weights, extra=()):
        self.op, self.Tq, self.weights, self.extra = op, Tq, weights, extra
        self.lidx, self.valid, self.wl = op.lidx, op.valid, op.wl
        self.positions = getattr(op, "positions", None)

    def windows(self, x):
        return self.op.windows(x, self.Tq, *self.weights, *self.extra)


def _momentum3d(n):
    from flow_tpu_torch.attic import winmom
    from flow_tpu_torch.fem.spaces import VectorFunctionSpace
    from flow_tpu_torch.mesh3d import box_mesh

    V = VectorFunctionSpace(box_mesh((0, 0, 0), (1, 1, 1), n, n, n, dtype=torch.float32,
                                     device="cuda"), 2, n_components=3)
    op = winmom.WindowLaggedMomentum(V)
    rng = np.random.default_rng(n)
    U = torch.as_tensor(0.1 * rng.standard_normal((V.n_dofs, 3)), dtype=torch.float32,
                        device="cuda")
    Tq, Uq, Gu = op.state_qp(U)
    x = torch.zeros((3, op.wl.n_pad), device="cuda")
    x[:, :op.wl.n] = torch.as_tensor(rng.standard_normal((3, op.wl.n)),
                                     dtype=torch.float32)
    # the weights of a momentum matvec at dt = 1e-3 (rho = 1, mu = 1e-2)
    weights = (1.0, 1e-3, 1e-5)
    return x, {"winmom3d": Momentum(op, Tq, weights),
               "winmom3d_newton": Momentum(op, Tq, weights, (Uq, Gu))}


def _momentum2d():
    from flow_tpu_torch.attic import winmom
    from flow_tpu_torch.models.karman import KarmanProblem

    prob = KarmanProblem(lcar=0.02, n_refine=5, dtype=torch.float32, device="cuda")
    op = winmom.WindowLaggedMomentum(prob.V)
    rng = np.random.default_rng(11)
    U = torch.as_tensor(0.01 * rng.standard_normal((prob.V.n_dofs, 2)), dtype=torch.float32,
                        device="cuda")
    Tq, Uq, Gu = op.state_qp(U)
    x = torch.zeros((2, op.wl.n_pad), device="cuda")
    x[:, :op.wl.n] = torch.as_tensor(rng.standard_normal((2, op.wl.n)),
                                     dtype=torch.float32)
    # the weights of a momentum matvec at dt = 1e-3
    weights = (1.0, 1e-3, 1e-3 * prob.mu / prob.rho)
    return x, {"winmom": Momentum(op, Tq, weights),
               "winmom_newton": Momentum(op, Tq, weights, (Uq, Gu))}


def layouts(only=None):
    """{layout: (input, {name: operator})} of the layouts whose name holds
    `only` (all by default), each built when it is asked for."""
    from flow_tpu_torch.attic import winform, winkernel
    from flow_tpu_torch.fem.spaces import FunctionSpace
    from flow_tpu_torch.mesh import unit_square_mesh
    from flow_tpu_torch.mesh3d import box_mesh

    def scalar(tag, mesh):
        V = FunctionSpace(mesh(), 2)
        M = winkernel.WindowMassOperator(V)
        nb, NL, C = M.lidx.shape
        g = torch.Generator(device="cuda").manual_seed(7)
        loc = torch.randn((V.mesh.n_cells, NL, NL), generator=g, device="cuda")
        K = winform.WindowElementOperator(V, loc=loc)
        ops = {"winmass": M, "winform": K}
        if tag == "tets N=32":
            ops["winstiff_p2"] = winkernel.WindowStiffnessOperator(V)
        return _padded(M, 4), ops

    def stiffness(mesh, degree, name, seed):
        op = winkernel.WindowStiffnessOperator(FunctionSpace(mesh, degree))
        return _padded(op, seed), {name: op}

    makers = {
        "tets N=32": lambda: scalar("tets N=32", lambda: box_mesh(
            (0, 0, 0), (1, 1, 1), 32, 32, 32, dtype=torch.float32, device="cuda")),
        "formwin2d": lambda: scalar("formwin2d", lambda: unit_square_mesh(
            1024, "right", dtype=torch.float32, device="cuda")),
        "tri n=256": lambda: stiffness(unit_square_mesh(
            256, "right", dtype=torch.float32, device="cuda"), 2, "winstiff_p2", 6),
        "cavity N=64 pressure": lambda: stiffness(box_mesh(
            (0, 0, 0), (1, 1, 1), 64, 64, 64, dtype=torch.float32, device="cuda"), 1,
            "winstiff_cluster", 5),
        "cavity N=64 velocity": lambda: _momentum3d(64),
        "cavity N=32 velocity": lambda: _momentum3d(32),
        "karman 1.9M velocity": _momentum2d,
    }
    for tag, make in makers.items():
        if only is None or only in tag:
            yield tag, make()


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
        print("torch_window_cluster_bench: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, args.root)
    from flow_tpu_torch.attic import winkernel

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"[device] {smi.stdout.strip()} root={args.root}", flush=True)
    flush = torch.empty(16 << 20, device="cuda")
    report, windows = [], {}
    for tag, (x, ops) in layouts(args.only):
        for name, op in ops.items():
            nb, NL, C = op.lidx.shape
            kname = KERNEL_NAMES[name]
            y = op.windows(x)
            windows[f"{tag} {name}"] = y.cpu()
            # the host clocks first: a profiler session slows later host code
            row = dict(layout=tag, kernel=name, nb=nb, C=C, NL=NL, W=op.wl.W,
                       wall_us=wall_us(lambda: op.windows(x)),
                       host_us=host_us(lambda: op.windows(x)),
                       device_us=device_us(lambda: op.windows(x), kname),
                       device_cold_us=device_us(lambda: (flush.zero_(), op.windows(x)),
                                                kname))
            kernel = counter_of(name, NL)
            # a cluster kernel's launch (an earlier checkout's K4b P2 sums
            # from a device scratch, and holds no positions)
            if getattr(op, "positions", None) is not None:
                row.update(winkernel.cluster_launch(kernel, nb, C, NL, "cuda")._asdict())
            print(json.dumps(row), flush=True)
            report.append(row)
            if args.sweep and name != "winstiff_cluster":
                # K3 follows momentum_plan, the others window_plan
                rule_name = "momentum_plan" if name.startswith("winmom") else "window_plan"
                rule = getattr(winkernel, rule_name)
                try:
                    for cl, threads in SWEEP[tag]:
                        setattr(winkernel, rule_name,
                                lambda nb_, C_, NL_, sms, *_, cl=cl, threads=threads, **__:
                                (cl, threads, -(-C_ * NL_ // cl)))
                        plan = winkernel.cluster_launch(kernel, nb, C, NL, "cuda")
                        same = torch.equal(op.windows(x), y)
                        point = dict(layout=tag, kernel=name, sweep=True, **plan._asdict(),
                                     device_us=device_us(lambda: op.windows(x), kname),
                                     bitwise_equal=same)
                        print(json.dumps(point), flush=True)
                        report.append(point)
                        if not same:
                            raise SystemExit(f"{tag} {name}: cl={cl} threads={threads} "
                                             "differs bitwise")
                finally:
                    setattr(winkernel, rule_name, rule)
    if args.save:
        torch.save(windows, args.save)
    if args.compare:
        ref = torch.load(args.compare)
        diff = [k for k in windows if not torch.equal(windows[k], ref[k])]
        print(f"[compare] against {args.compare}: "
              + ("bitwise equal" if not diff else f"differ: {diff}"), flush=True)
        if diff:
            return 1
    if args.json:
        Path(args.json).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
