# Chebyshev polynomial preconditioning and its eigenvalue bound. Port of
# flow_tpu/solvers/chebyshev.py: a fixed-degree Chebyshev polynomial in the
# Jacobi-scaled operator is a linear SPD preconditioner (valid inside
# CG/MINRES); lambda_max comes from a short power iteration at setup.
from __future__ import annotations

import torch

__all__ = ["power_iteration_lmax", "chebyshev_preconditioner"]


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


def chebyshev_preconditioner(A, diag, lmax, degree=5, lmin_ratio=0.25):
    """M(r) ~ A^{-1} r: `degree` Chebyshev iterations from zero on the
    Jacobi-scaled operator, targeting [lmin_ratio*lmax, 1.05*lmax]. Linear
    and symmetric in the diag inner product, so valid inside CG/MINRES."""
    lmax_s = 1.05 * lmax
    lmin_s = lmin_ratio * lmax
    theta = 0.5 * (lmax_s + lmin_s)
    delta = 0.5 * (lmax_s - lmin_s)
    sigma = theta / delta

    def M(b):
        rho = 1.0 / sigma
        d = (b / diag) / theta
        x = d
        r = b - A(d)
        for _ in range(degree - 1):
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = rho_new * rho * d + (2.0 * rho_new / delta) * (r / diag)
            x = x + d
            r = r - A(d)
            rho = rho_new
        return x

    return M
