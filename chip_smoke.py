#!/usr/bin/env python3
"""Smoke run of flow_tpu_torch on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. device and build: the card's name and power limit from nvidia-smi, then
   the CUDA stencil kernel built from flow_tpu_torch/csrc with nvcc;
2. kernel against plain: the stencil kernel against its plain PyTorch
   version on the 3-D cavity path's grids plus ragged ones, in float64
   (relative error <= 1e-13) and float32 (<= 1e-5: another summation order),
   with both times from CUDA events;
3. on-card parity: Cavity3DProblem(n=8) in float64 for 3 steps on the card
   and on the CPU (plain path): equal per-step iteration counts, U within
   1e-10 and the mean-removed P within 1e-8;
4. main path: Cavity3DProblem(n=64), 6,714,692 DoF, in float32 with the
   benchmark's box-path settings: 1 warm-up step and 5 timed steps. Fails on
   a non-finite state, an unconverged pressure or correction solve, or a
   stencil launch count of 0.

The line before the last holds the kernel report and the card; the last
line is {"ok": true, "device": {...}}. Imports neither jax nor flow_tpu.
"""
import json
import subprocess
import sys
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


def phase_build():
    from flow_tpu_torch import _build
    from flow_tpu_torch.ops.stencil import STENCIL_3D

    t0 = time.perf_counter()
    STENCIL_3D.lib()
    log(f"[build] stencil3d ready in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds.get('stencil3d', 0.0):.2f} s) "
        f"into {_build.BUILD_DIR}")


def phase_kernel():
    import torch
    from flow_tpu_torch.ops.stencil import stencil_apply_3d, stencil_apply_3d_plain

    shapes = [(65, 65, 65), (33, 33, 33), (17, 17, 17), (9, 9, 9), (5, 5, 5),
              (5, 6, 7), (2, 7, 9), (1, 4, 3), (1, 1, 1)]
    tols = {torch.float64: 1e-13, torch.float32: 1e-5}
    rng = np.random.default_rng(0)
    report = {}
    for dtype, tol in tols.items():
        for shape in shapes:
            x = torch.as_tensor(rng.standard_normal(shape), dtype=dtype, device="cuda")
            k = torch.as_tensor(rng.standard_normal((3, 3, 3)), dtype=dtype,
                                device="cuda")
            y = stencil_apply_3d(x, k)
            y_plain = stencil_apply_3d_plain(x, k)
            torch.cuda.synchronize()
            abs_err = float((y - y_plain).abs().max())
            rel_err = abs_err / max(float(y_plain.abs().max()), 1e-300)
            reps = 200 if x.numel() > 1000 else 50
            ms = cuda_time_ms(lambda: stencil_apply_3d(x, k), reps)
            plain_ms = cuda_time_ms(lambda: stencil_apply_3d_plain(x, k), reps)
            log(f"[kernel] {str(dtype):13s} {str(shape):15s} max_abs_err={abs_err:.3e} "
                f"rel_err={rel_err:.3e} kernel_ms={ms:.5f} plain_ms={plain_ms:.5f}")
            check(rel_err <= tol, f"stencil {shape} {dtype}: rel err {rel_err} > {tol}")
            report[(dtype, shape)] = (abs_err, ms, plain_ms)
    return report


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


def phase_parity():
    import torch

    cpu, U_c, P_c, tel_c = _cavity_run(8, torch.float64, "cpu", 3)
    lmax = [L.lmax for L in cpu.hierarchy.levels]
    gpu, U_g, P_g, tel_g = _cavity_run(8, torch.float64, "cuda", 3, lmax=lmax)
    for key in ("linear_iters", "pressure_iters", "correction_iters"):
        a, b = tel_g[key].tolist(), tel_c[key].tolist()
        log(f"[parity] {key}: cuda={a} cpu={b}")
        check(a == b, f"parity: {key} differ (cuda {a}, cpu {b})")
    du = float((U_g.cpu() - U_c).abs().max())
    dp = (P_g.cpu() - P_c)
    dp = float((dp - dp.mean()).abs().max())
    log(f"[parity] max|dU|={du:.3e} max|dP - mean|={dp:.3e} "
        f"dt cuda={tel_g['dt'].tolist()} cpu={tel_c['dt'].tolist()}")
    check(du <= 1e-10, f"parity: U differs by {du}")
    check(dp <= 1e-8, f"parity: P differs by {dp}")


def phase_main():
    import torch
    from flow_tpu_torch.models.cavity3d import Cavity3DProblem
    from flow_tpu_torch.navier_stokes.boxfast import BoxPackedStepper
    from flow_tpu_torch.ops.stencil import STENCIL_3D

    t0 = time.perf_counter()
    prob = Cavity3DProblem(n=64, mu=0.01, dtype=torch.float32, device="cuda")
    st = BoxPackedStepper(prob.V, prob.Q, prob.u_bcs, prob.p_bcs, prob.rho,
                          prob.mu, **BENCH_SETTINGS)
    n_dofs = 3 * prob.V.n_dofs + prob.Q.n_dofs
    torch.cuda.synchronize()
    log(f"[main] n=64 n_dofs={n_dofs} setup {time.perf_counter() - t0:.1f} s, "
        f"levels {[L.grid for L in st.hierarchy.levels]}")
    check(n_dofs == 6714692, f"unexpected n_dofs {n_dofs}")

    Uf, Pf = st.zeros()
    torch.cuda.reset_peak_memory_stats()
    STENCIL_3D.launches = 0
    Uf, Pf, dt, tel_w = st.run(Uf, Pf, DT0, n_steps=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Uf, Pf, dt, tel = st.run(Uf, Pf, dt, n_steps=5)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = STENCIL_3D.launches
    peak = torch.cuda.max_memory_allocated()

    tel_all = {k: tel_w[k].tolist() + tel[k].tolist() for k in tel}
    log(f"[main] steps/s={5 / elapsed:.4f} (5 steps in {elapsed:.3f} s, "
        f"after 1 warm-up step)")
    for k in ("dt", "linear_iters", "pressure_iters", "correction_iters"):
        log(f"[main] {k}: {tel_all[k]}")
    log(f"[main] peak_mem_bytes={peak} stencil_launches={launches}")
    check(bool(torch.isfinite(Uf).all()) and bool(torch.isfinite(Pf).all()),
          "main: non-finite state")
    check(bool(torch.isfinite(dt)), "main: non-finite dt")
    check(max(tel_all["pressure_iters"]) < PRESSURE_MAXITER,
          "main: a pressure solve did not converge")
    check(max(tel_all["correction_iters"]) < CORRECTION_MAXITER,
          "main: a correction solve did not converge")
    check(launches > 0, "main: the stencil kernel was never launched")
    umax = float(Uf.abs().max())
    check(abs(umax - 1.0) < 1e-6, f"main: max |u| {umax} is not the lid speed")
    return launches


def main():
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
    try:
        phase_build()
        kreport = phase_kernel()
        phase_parity()
        launches = phase_main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    abs_err, ms, plain_ms = kreport[(torch.float32, (65, 65, 65))]
    print(json.dumps({"kernels": [{
        "name": "stencil_apply_3d",
        "route": "cuda",
        "source": "flow_tpu_torch/csrc/stencil3d.cu",
        "replaces": "flow_tpu/ops/pallas_stencil.py:71",
        "launches": launches,
        "max_abs_err": abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
