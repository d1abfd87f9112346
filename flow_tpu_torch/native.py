# ctypes bindings for the mesh-topology library native/meshkit.cpp. Port of
# flow_tpu/native.py.
#
# The library is built at first use from the C++ source with g++ into
# flow_tpu_torch/build/ (git-ignored), under a name that carries a hash of
# the source. The tracked native/libmeshkit.so is not loaded: it is built
# with -march=native and may not run on another machine's CPU. There is no
# numpy or scipy fallback: the window layouts (attic/window.py) need the
# library's exact RCM permutation, so a failed build raises.
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

__all__ = ["build_edges", "rcm_order", "library_path", "SOURCE"]

SOURCE = Path(__file__).resolve().parents[1] / "native" / "meshkit.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "build"

_LIB = None


def library_path():
    """Path of the built library for the current source (built if absent)."""
    if not SOURCE.is_file():
        raise RuntimeError(f"meshkit source not found: {SOURCE}")
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"libmeshkit-{digest}.so"
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: meshkit is built from source")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [cxx, "-O3", "-fPIC", "-std=c++17", "-shared", "-o", str(tmp),
         str(SOURCE)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"building meshkit failed (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent build sees a whole file
    return out


def _load():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(library_path()))
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
        lib.meshkit_build_edges.restype = ctypes.c_int64
        lib.meshkit_build_edges.argtypes = [
            i32p, ctypes.c_int64, i32p, i32p, i8p,
        ]
        lib.meshkit_rcm.restype = None
        lib.meshkit_rcm.argtypes = [ctypes.c_int64, i32p, ctypes.c_int64, i32p]
        _LIB = lib
    return _LIB


def build_edges(cells: np.ndarray):
    """(edges [ne,2], cell_edges [nc,3], boundary_edge_ids [nb]) for CCW
    triangle cells [nc,3]; edges sorted lexicographically, local edge k
    opposite vertex k."""
    cells = np.ascontiguousarray(cells, dtype=np.int32)
    nc = len(cells)
    lib = _load()
    edges_buf = np.empty((3 * nc, 2), dtype=np.int32)
    cell_edges = np.empty((nc, 3), dtype=np.int32)
    bnd = np.empty(3 * nc, dtype=np.int8)
    ne = lib.meshkit_build_edges(cells, nc, edges_buf, cell_edges, bnd)
    edges = edges_buf[:ne].copy()
    bnd_ids = np.where(bnd[:ne] == 1)[0].astype(np.int32)
    return edges, cell_edges, bnd_ids


def rcm_order(n_vertices: int, edges: np.ndarray):
    """Reverse Cuthill-McKee permutation (perm[i] = old id at new slot i)."""
    edges = np.ascontiguousarray(edges, dtype=np.int32)
    perm = np.empty(n_vertices, dtype=np.int32)
    _load().meshkit_rcm(n_vertices, edges, len(edges), perm)
    return perm
