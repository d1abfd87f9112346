# Chebyshev smoothing support. Port of flow_tpu/solvers/chebyshev.py
# (power_iteration_lmax only).
from __future__ import annotations

import torch

__all__ = ["power_iteration_lmax"]


def power_iteration_lmax(A, diag, n, iters=30, generator=None, dtype=None):
    """Estimate lambda_max of diag^{-1} A by power iteration.

    `n` is the vector shape (int or tuple). The start vector is drawn on the
    host from `generator` (default: a CPU generator seeded 0) and moved to
    diag's device, so CPU and CUDA runs start from the same vector. It does
    not reproduce the bits of jax.random; interop.load_hierarchy_lmax carries
    the JAX package's estimates across where a run must match it exactly.
    Returns a python float.
    """
    shape = (n,) if isinstance(n, int) else tuple(n)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    x = torch.randn(shape, generator=generator, dtype=dtype or diag.dtype)
    x = x.to(diag.device)
    for _ in range(iters):
        y = A(x) / diag
        x = y / torch.sqrt(torch.sum(y * y))
    y = A(x) / diag
    return float(torch.sum(x * y) / torch.sum(x * x))
