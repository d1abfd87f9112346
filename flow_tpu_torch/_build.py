"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``flow_tpu_torch/build/``, a directory
that git ignores. The library's file name carries a hash of its source and of
the shared headers ``csrc/*.cuh``, so an edited source is rebuilt and a built
one is reused. No PyTorch headers are included, which keeps a build to
seconds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["BUILD_DIR", "CSRC_DIR", "Kernel", "load", "build_all",
           "nvcc_command", "build_seconds"]

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


def _library_path(name):
    # the hash covers the shared headers too, which any source may include
    src = CSRC_DIR / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    return src, BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names):
    """Build the libraries of csrc/<name>.cu for every name that has none of
    its current source yet, one nvcc per source, all started together."""
    procs = []
    for name in names:
        src, out = _library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            nvcc_command(_nvcc(), src, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        )
        procs.append((name, src, out, tmp, proc, time.perf_counter()))
    failures = []
    for name, src, out, tmp, proc, t0 in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {src.name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent build sees a whole file
        build_seconds[name] = time.perf_counter() - t0
    if failures:
        raise RuntimeError("\n".join(failures))


def load(name):
    """Return the ctypes library built from csrc/<name>.cu, building it if
    no library of the current source exists yet."""
    if name in _loaded:
        return _loaded[name]
    build_all([name])
    lib = ctypes.CDLL(str(_library_path(name)[1]))
    _loaded[name] = lib
    return lib


class Kernel:
    """Launch count and lazily built library of one csrc/<name>.cu.

    `signatures` maps each C entry point to its ctypes argtypes; every entry
    returns the cudaError_t of its launch. launch() raises on a non-zero
    code and counts only launches that were accepted."""

    def __init__(self, name, signatures):
        self.name = name
        self.signatures = signatures
        self.launches = 0
        self._lib = None
        self._entries = {}

    def lib(self):
        if self._lib is None:
            lib = load(self.name)
            entries = {}
            for fn, argtypes in self.signatures.items():
                entry = entries[fn] = getattr(lib, fn)
                entry.argtypes = argtypes
                entry.restype = ctypes.c_int
            self._entries = entries
            self._lib = lib
        return self._lib

    def launch(self, fn, *args):
        if self._lib is None:
            self.lib()
        err = self._entries[fn](*args)
        if err != 0:
            raise RuntimeError(f"{fn} launch failed with CUDA error {err}")
        self.launches += 1
