"""Carry state and setup results from the JAX package into the port.

Every function here takes plain numpy arrays or floats (``np.asarray`` of a
JAX array, ``float`` of a JAX scalar), so this module imports neither JAX nor
``flow_tpu``.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["packed_state_to_torch", "packed_state_to_numpy",
           "load_hierarchy_lmax"]


def packed_state_to_torch(Uf, Pf, dtype=torch.float64, device="cpu"):
    """Packed (Uf [3*n2], Pf [n1]) numpy arrays -> tensors on `device`.

    The box layout of fem/boxpack.py is the JAX package's, so a packed state
    of one package is a packed state of the other."""
    return (
        torch.tensor(np.asarray(Uf), dtype=dtype, device=device),
        torch.tensor(np.asarray(Pf), dtype=dtype, device=device),
    )


def packed_state_to_numpy(Uf, Pf):
    """Packed (Uf, Pf) tensors -> float numpy arrays on the host."""
    return Uf.detach().cpu().numpy(), Pf.detach().cpu().numpy()


def load_hierarchy_lmax(hierarchy, lmax):
    """Set a StructuredHierarchy's per-level lambda_max estimates (coarse to
    fine, as floats) and recompute each level's Chebyshev theta and delta.

    The power iteration starts from a random vector, and torch.Generator
    cannot reproduce jax.random's bits: without this the Chebyshev
    coefficients differ slightly and iteration counts can drift."""
    lmax = [float(v) for v in lmax]
    if len(lmax) != len(hierarchy.levels):
        raise ValueError(
            f"{len(lmax)} lmax values for {len(hierarchy.levels)} levels"
        )
    for level, value in zip(hierarchy.levels, lmax):
        hierarchy.set_lmax(level, value)
