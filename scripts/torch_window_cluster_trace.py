#!/usr/bin/env python3
"""Where a window kernel's time goes, phase by phase, on the card.

    python3 scripts/torch_window_cluster_trace.py [--only TEXT] [--json F]

Builds csrc/winmass.cu, winform.cu, winstiff.cu, winmom.cu and winmom3d.cu with
-DWINCLUSTER_TRACE (the phase marks of csrc/wincluster.cuh: thread 0 of each
block reads %globaltimer at each phase of its first window block's first
pass) into a temporary directory, runs K4a, K5, K4b 3-D P1, K4b P2 and K3
2-D and 3-D (lagged and Newton) once at the layouts of
scripts/torch_window_cluster_bench.py (--only: those whose name holds TEXT)
through that build, and prints the
share of each layout's window rows that no local result lands on and, over
the blocks, the median and the largest µs of each phase: setup (the
kernel's tables and the first cluster barrier), cells (the local results
stored at their list positions and, where the walk takes compressed rows,
the zeros of the window's empty rows), wait (the cluster barrier after
them), split (the row range of the block), rows (the row sums) and the last
barrier. A block's marks wait for all its threads (a __syncthreads() in
the traced build only), so the traced kernel runs a little slower than the
real one. Needs the card; imports neither jax nor flow_tpu.
"""
import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from flow_tpu_torch import _build  # noqa: E402
from flow_tpu_torch.attic import winform, winkernel, winmom  # noqa: E402
import torch_window_cluster_bench as bench  # noqa: E402

PHASES = ("setup", "cells", "wait", "split", "rows", "last_wait")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only")
    ap.add_argument("--json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_window_cluster_trace: needs a CUDA device", file=sys.stderr)
        return 2
    names = ("winmass", "winform", "winstiff", "winmom", "winmom3d")
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for name in names:
            cmd = _build.nvcc_command(_build._nvcc(), _build.CSRC_DIR / f"{name}.cu",
                                      Path(tmp) / f"lib{name}.so")
            cmd[1:1] = ["-DWINCLUSTER_TRACE"]
            procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
        for proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                print(log, file=sys.stderr)
                return 1
        libs = {name: ctypes.CDLL(str(Path(tmp) / f"lib{name}.so")) for name in names}
    # the kernels' launches go through the traced build
    _build.load = lambda name: libs[name]
    for kernel in (winkernel.WINMASS, winform.WINFORM, winkernel.WINSTIFF3D,
                   winkernel.WINSTIFF_P2, winkernel.WINSTIFF3D_P2, winmom.WINMOM,
                   winmom.WINMOM_NEWTON, winmom.WINMOM3D, winmom.WINMOM3D_NEWTON):
        kernel._lib = None
    winkernel._cluster_launch.cache_clear()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"[device] {smi.stdout.strip()}", flush=True)
    report = []
    for tag, (x, ops) in bench.layouts(args.only):
        for name, op in ops.items():
            nb, NL, C = op.lidx.shape
            kernel = bench.counter_of(name, NL)
            plan = winkernel.cluster_launch(kernel, nb, C, NL, "cuda")
            for _ in range(3):
                op.windows(x)
            torch.cuda.synchronize()
            blocks = plan.clusters * plan.cl
            marks = np.zeros(blocks * 8, dtype=np.uint64)
            err = libs[kernel.name].wincluster_trace_read(ctypes.c_void_p(marks.ctypes.data),
                                                          blocks * 8)
            if err != 0:
                raise RuntimeError(f"wincluster_trace_read failed with CUDA error {err}")
            t = marks.reshape(blocks, 8)[:, :7].astype(np.int64)
            us = np.diff(t, axis=1) / 1e3
            # the window rows that some real cell's local result lands on
            hit = torch.zeros(nb * op.wl.W, dtype=torch.bool, device="cuda")
            rows = (torch.arange(nb, device="cuda") * op.wl.W)[:, None, None] + op.lidx
            hit[rows[(op.valid > 0)[:, None, :].expand_as(rows)].long()] = True
            row = dict(layout=tag, kernel=name, nb=nb, C=C, NL=NL, W=op.wl.W,
                       empty_rows=1.0 - float(hit.float().mean()),
                       **plan._asdict(),
                       first_window_us=float((t[:, 6].max() - t[:, 0].min()) / 1e3),
                       phases_us={p: [float(np.median(us[:, i])), float(us[:, i].max())]
                                  for i, p in enumerate(PHASES)})
            print(json.dumps(row), flush=True)
            report.append(row)
    if args.json:
        Path(args.json).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
