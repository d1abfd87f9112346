# Matrix-free Krylov solvers. Port of flow_tpu/solvers/krylov.py (cg and
# bicgstab; gmres and minres are not ported yet).
#
# The JAX solvers run inside lax.while_loop. Here the loop is a Python loop
# whose stopping test reads one boolean from the device per iteration; the
# rest of the iteration stays on the device. The order of operations and the
# division guards are the JAX package's, so the iteration counts match it.
#
# All solvers take the operator A as a callable x -> A x and return
# (x, SolveInfo); the stopping rule is the unpreconditioned residual 2-norm,
# ||r|| <= max(rtol * ||b||, atol).
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

__all__ = ["SolveInfo", "cg", "bicgstab"]


class SolveInfo(NamedTuple):
    iters: int
    resnorm: torch.Tensor
    converged: torch.Tensor


def _dot(x, y):
    return torch.sum(x * y)


def _identity(x):
    return x


def _nz(x):
    # guard divisions; finfo.tiny stays representable in f32
    return torch.where(x == 0, torch.finfo(x.dtype).tiny, x)


def _make_project(nullspace, dot=None):
    if nullspace is None:
        return _identity
    _dot_ = dot or _dot
    ns = [v / torch.sqrt(_dot_(v, v)) for v in nullspace]

    def proj(x):
        for v in ns:
            x = x - _dot_(v, x) * v
        return x

    return proj


def cg(
    A: Callable,
    b,
    x0=None,
    M: Optional[Callable] = None,
    rtol=1e-10,
    atol=0.0,
    maxiter=1000,
    nullspace=None,
    dot: Optional[Callable] = None,
):
    """Preconditioned conjugate gradients for SPD (or consistent singular
    semidefinite) systems. `dot` overrides the inner product (norms,
    orthogonality and the nullspace projection)."""
    M = M or _identity
    _dot_ = dot or _dot
    proj = _make_project(nullspace, dot=dot)
    b = proj(b)

    bnorm = torch.sqrt(_dot_(b, b))
    target = torch.clamp(rtol * bnorm, min=atol)

    # x0 None: r = b directly, one matvec saved
    if x0 is None:
        x = torch.zeros_like(b)
        r = b
    else:
        x = proj(x0)
        r = proj(b - A(x))
    z = proj(M(r))
    p = z
    rz = _dot_(r, z)
    rnorm = torch.sqrt(_dot_(r, r))

    k = 0
    while k < maxiter and bool(rnorm > target):
        Ap = proj(A(p))
        pAp = _dot_(p, Ap)
        alpha = rz / torch.where(pAp == 0, 1.0, pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        z = proj(M(r))
        rz_new = _dot_(r, z)
        beta = rz_new / torch.where(rz == 0, 1.0, rz)
        p = z + beta * p
        rz = rz_new
        rnorm = torch.sqrt(_dot_(r, r))
        k += 1
    return x, SolveInfo(k, rnorm, rnorm <= target)


def bicgstab(
    A: Callable,
    b,
    x0=None,
    M: Optional[Callable] = None,
    rtol=1e-10,
    atol=0.0,
    maxiter=1000,
    dot: Optional[Callable] = None,
):
    """Preconditioned BiCGStab for nonsymmetric systems (momentum)."""
    M = M or _identity
    _dot_ = dot or _dot
    bnorm = torch.sqrt(_dot_(b, b))
    target = torch.clamp(rtol * bnorm, min=atol)

    if x0 is None:  # skip the initial matvec (see cg)
        x = torch.zeros_like(b)
        r = b
    else:
        x = x0
        r = b - A(x)
    rhat = r
    rnorm = torch.sqrt(_dot_(r, r))
    one = torch.ones((), dtype=r.dtype, device=r.device)
    rho, alpha, omega = one, one, one
    v = torch.zeros_like(r)
    p = torch.zeros_like(r)
    tiny = torch.finfo(r.dtype).tiny
    stall = torch.zeros((), dtype=torch.bool, device=r.device)

    k = 0
    while k < maxiter and bool((rnorm > target) & ~stall):
        rho_new = _dot_(rhat, r)
        beta = (rho_new / _nz(rho)) * (alpha / _nz(omega))
        p = r + beta * (p - omega * v)
        phat = M(p)
        v = A(phat)
        denom = _dot_(rhat, v)
        alpha = rho_new / _nz(denom)
        s_vec = r - alpha * v
        shat = M(s_vec)
        t = A(shat)
        tt = _dot_(t, t)
        omega = _dot_(t, s_vec) / _nz(tt)
        x = x + alpha * phat + omega * shat
        r = s_vec - omega * t
        rnorm = torch.sqrt(_dot_(r, r))
        stall = (torch.abs(rho_new) < tiny) | (torch.abs(omega) < tiny)
        rho = rho_new
        k += 1
    return x, SolveInfo(k, rnorm, rnorm <= target)
