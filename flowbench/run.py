#!/usr/bin/env python3
"""The benchmark of flow_tpu_torch, one run of one cell:

    python3 flowbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints the result as one JSON line on standard output (the last line) and
the compared numbers beside their limits as the last lines on standard
error. Exits 2 without a result where the cell's CUDA cards are absent.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "flowbench" / ".cache"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    # kernel caches at fixed paths inside the checkout; the program's own
    # nvcc and g++ libraries go to flow_tpu_torch/build/, also inside it
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    sys.path.insert(0, str(ROOT))
    from flowbench import harness

    return harness.main(args, T_START)


if __name__ == "__main__":
    sys.exit(main())
