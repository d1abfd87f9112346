"""Carry state and setup results from the JAX package into the port.

Every function here takes plain numpy arrays or floats (``np.asarray`` of a
JAX array, ``float`` of a JAX scalar), so this module imports neither JAX nor
``flow_tpu``.
"""
from __future__ import annotations

import numpy as np
import torch

from .mesh3d import _device

__all__ = ["state_to_torch", "state_to_numpy", "load_hierarchy_lmax"]


def state_to_torch(U, P, dtype=torch.float64, device=None, Um1=None):
    """(U, P) numpy arrays -> tensors on `device` (None: the card; raises
    where there is none); with the BDF2 state's previous velocity Um1,
    (U, P, Um1).

    The port numbers dofs as the JAX package does, so a state of one
    package is a state of the other: the states (U [n_V, dim], P [n_Q]) of
    navier_stokes/fast.py (Karman in 2-D, the cavity in 3-D), the packed
    box state (Uf [3*n2], Pf [n1]) of fem/boxpack.py and the packed patch
    state (Uf [2*n2], Pf [n1]) of navier_stokes/patchfast.py."""
    device = _device(device)
    out = tuple(torch.tensor(np.asarray(a), dtype=dtype, device=device)
                for a in (U, P) + (() if Um1 is None else (Um1,)))
    return out


def state_to_numpy(U, P, Um1=None):
    """(U, P) tensors -> float numpy arrays on the host; with Um1,
    (U, P, Um1)."""
    return tuple(a.detach().cpu().numpy()
                 for a in (U, P) + (() if Um1 is None else (Um1,)))


def load_hierarchy_lmax(hierarchy, lmax):
    """Set the per-level lambda_max estimates (coarse to fine, as floats) of
    a StructuredHierarchy, P1Hierarchy or PackedPatchP1Hierarchy (the packed
    stepper's `hierarchy`) and recompute each level's Chebyshev theta and
    delta.

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
