"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``flow_tpu_torch/build/``, a directory
that git ignores. The library's file name carries a hash of its source, so an
edited source is rebuilt and a built one is reused. No PyTorch headers are
included, which keeps a build to seconds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["BUILD_DIR", "CSRC_DIR", "load", "nvcc_command", "build_seconds"]

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

# seconds spent in nvcc per library name, for the smoke run's report
build_seconds: dict = {}
_loaded: dict = {}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
        "kernels of flow_tpu_torch are built from source on the machine "
        "with the card"
    )


def nvcc_command(nvcc, src, out):
    return [
        nvcc,
        "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-o", str(out), str(src),
    ]


def load(name):
    """Return the ctypes library built from csrc/<name>.cu, building it if
    no library of the current source exists yet."""
    if name in _loaded:
        return _loaded[name]
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            nvcc_command(_nvcc(), src, tmp), capture_output=True, text=True
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src.name} (exit {proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, out)  # atomic: a concurrent build sees a whole file
        build_seconds[name] = time.perf_counter() - t0
    lib = ctypes.CDLL(str(out))
    _loaded[name] = lib
    return lib
