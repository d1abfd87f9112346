# Matrix-free Krylov solvers. Port of flow_tpu/solvers/krylov.py (cg,
# bicgstab, minres and gmres).
#
# The JAX solvers run inside lax.while_loop. Here the loop is a Python loop
# whose stopping test reads from the device once per iteration; the rest of
# the iteration stays on the device (GMRES keeps its small Givens
# bookkeeping on the host, in the working precision). The order of
# operations and the division guards are the JAX package's, so the
# iteration counts match it. Every blocking read goes through
# message.host_read, a flow.sync.<solver> span in profiler traces: cg,
# bicgstab and minres read once an iteration and once more for the test
# that stops them (unless at maxiter).
#
# All solvers take the operator A as a callable x -> A x and return
# (x, SolveInfo); the stopping rule is the unpreconditioned residual 2-norm,
# ||r|| <= max(rtol * ||b||, atol).
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..message import host_read

__all__ = ["SolveInfo", "cg", "bicgstab", "minres", "gmres"]


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
    while k < maxiter and host_read("cg", bool, rnorm > target):
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
    while k < maxiter and host_read("bicgstab", bool, (rnorm > target) & ~stall):
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


def minres(
    A: Callable,
    b,
    x0=None,
    M: Optional[Callable] = None,
    rtol=1e-10,
    atol=0.0,
    maxiter=1000,
    nullspace=None,
):
    """Preconditioned MINRES for symmetric (possibly indefinite) systems,
    the Stokes saddle point; M must be SPD. The Lanczos and Givens
    recurrences and their division guards are the JAX package's. The loop
    stops on the recurrence's residual estimate |phibar| (the preconditioned
    one); the reported residual is the true one, b - A x, and `converged`
    compares it with the target."""
    M = M or _identity
    proj = _make_project(nullspace)
    b = proj(b)
    if x0 is None:  # b - A(0) is b: one matvec saved
        x = torch.zeros_like(b)
        r1 = b
    else:
        x = proj(x0)
        r1 = proj(b - A(x))
    y = proj(M(r1))
    beta1 = torch.sqrt(torch.clamp(_dot(r1, y), min=0.0))
    bnorm = torch.sqrt(_dot(b, b))
    target = torch.clamp(rtol * bnorm, min=atol)

    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    r2 = r1
    w = torch.zeros_like(b)
    w2 = torch.zeros_like(b)
    beta, betal = beta1, zero
    c, s = -torch.ones_like(zero), zero
    dbar, epsln = zero, zero
    phibar = beta1
    rnorm = torch.sqrt(_dot(r1, r1))

    k = 0
    while k < maxiter and host_read("minres", bool, rnorm > target):
        v = y / _nz(beta)
        yv = proj(A(v))
        if k >= 1:
            yv = yv - (beta / _nz(betal)) * r1
        alfa = _dot(v, yv)
        yv = yv - (alfa / _nz(beta)) * r2
        r1, r2 = r2, yv
        y = proj(M(yv))
        betal, beta = beta, torch.sqrt(torch.clamp(_dot(yv, y), min=0.0))

        oldeps = epsln
        delta = c * dbar + s * alfa
        gbar = s * dbar - c * alfa
        epsln = s * beta
        dbar = -c * beta
        gamma = _nz(torch.sqrt(gbar**2 + beta**2))
        c = gbar / gamma
        s = beta / gamma
        phi = c * phibar
        phibar = s * phibar

        w1, w2 = w2, w
        w = (v - oldeps * w1 - delta * w2) / gamma
        x = x + phi * w
        rnorm = torch.abs(phibar)
        k += 1
    rtrue = b - A(x)
    rnorm = torch.sqrt(_dot(rtrue, rtrue))
    return x, SolveInfo(k, rnorm, rnorm <= target)


def gmres(
    A: Callable,
    b,
    x0=None,
    M: Optional[Callable] = None,
    rtol=1e-10,
    atol=0.0,
    maxiter=1000,
    restart=40,
    dot: Optional[Callable] = None,
    basis_dtype=None,
    reduce: Optional[Callable] = None,
):
    """Restarted GMRES(m) with right preconditioning (A M z = b, x = M z),
    so that the Givens recurrence tracks the true residual norm.

    Arnoldi by batched modified Gram-Schmidt against the stored basis
    [m+1, N] with one re-orthogonalisation pass; Givens rotations; a cycle
    stops when |g_j| <= max(rtol |b|, atol), after m iterations, or on a
    breakdown (h_{j+1,j} <= 10 tiny). `iters` is the sum of the cycles'
    iterations, and the reported residual is the true one, b - A x. `dot`
    overrides the inner product of the norms (the projections are plain
    sums, as in the JAX package; a weighted metric is conjugated by its
    square root by the caller). `reduce` sums the projections' [m+1]
    vector across devices where the vectors are sharded (identity by
    default). One device->host read per iteration carries the new Hessenberg
    column; the rotations and the triangular solve run on the host in the
    working precision. basis_dtype (e.g. torch.bfloat16) stores the
    Arnoldi basis in a reduced precision, as the JAX package's: the
    projections read it upcast and accumulate in the working precision,
    and each restart cycle re-measures the true residual before deciding
    to stop (the Givens estimate drifts with a reduced basis)."""
    M = M or _identity
    _dot_ = dot or _dot
    _red_ = reduce or _identity
    x = torch.zeros_like(b) if x0 is None else x0
    shape = b.shape
    N = b.numel()
    m = int(restart)
    real = np.float32 if b.dtype == torch.float32 else np.float64
    tiny10 = real(np.finfo(real).tiny) * real(10.0)

    def host(t):
        return real(host_read("gmres", torch.Tensor.item, t))

    bnorm = torch.sqrt(_dot_(b, b))
    target = max(real(rtol) * host(bnorm), real(atol))
    r0 = b if x0 is None else b - A(x)
    rnorm = host(torch.sqrt(_dot_(r0, r0)))
    dtype = b.dtype
    bd = dtype if basis_dtype is None else basis_dtype
    V = torch.empty((m + 1, N), dtype=bd, device=b.device)
    if bd == dtype:
        def basis(rows):
            return rows
    else:
        def basis(rows):
            # the reduced basis (and what meets it) in the working precision:
            # products of reduced values are exact there, as in the JAX
            # package's preferred_element_type accumulation
            return rows.to(dtype)

    def cycle(x, r, beta):
        """One restart cycle from residual r of norm beta (a 0-d tensor)
        -> (x, |g_j|, j)."""
        beta_h = host(beta)
        V[0] = (r.reshape(N) / _nz(beta)).to(bd)
        R = np.zeros((m + 1, m), dtype=real)  # rotated Hessenberg columns
        cs = np.zeros(m, dtype=real)
        sn = np.zeros(m, dtype=real)
        g = np.zeros(m + 1, dtype=real)
        g[0] = beta_h
        j, brk = 0, False
        while j < m and abs(g[j]) > target and not brk:
            Vj = basis(V[: j + 1])
            w = A(M(basis(V[j]).view(shape))).reshape(N)
            h = _red_(Vj @ basis(w.to(bd)))
            w = w - basis(h.to(bd)) @ Vj
            h2 = _red_(Vj @ basis(w.to(bd)))
            w = w - basis(h2.to(bd)) @ Vj
            h = h + h2
            hj1 = torch.sqrt(_dot_(w.view(shape), w.view(shape)))
            col = host_read("gmres", torch.Tensor.cpu,
                            torch.cat([h, hj1.reshape(1)])).numpy().astype(real)
            brk = bool(col[j + 1] <= tiny10)
            V[j + 1] = torch.where(hj1 <= float(tiny10), torch.zeros_like(w),
                                   w / _nz(hj1)).to(bd)
            for i in range(j):
                hi, hi1 = col[i], col[i + 1]
                col[i] = cs[i] * hi + sn[i] * hi1
                col[i + 1] = -sn[i] * hi + cs[i] * hi1
            hj = col[j]
            denom = np.sqrt(hj * hj + col[j + 1] * col[j + 1])
            denom = denom if denom != 0 else real(np.finfo(real).tiny)
            cs[j] = hj / denom
            sn[j] = col[j + 1] / denom
            col[j] = cs[j] * hj + sn[j] * col[j + 1]
            col[j + 1] = 0
            R[: j + 2, j] = col
            g[j + 1] = -sn[j] * g[j]
            g[j] = cs[j] * g[j]
            j += 1
        if j:
            y = np.zeros(j, dtype=real)
            for i in range(j - 1, -1, -1):  # back substitution, R[:j, :j] y = g[:j]
                y[i] = (g[i] - np.dot(R[i, i + 1: j], y[i + 1:])) / R[i, i]
            yt = torch.as_tensor(y, dtype=dtype, device=b.device)
            dx = basis(yt.to(bd)) @ basis(V[:j])
            x = x + M(dx.view(shape))
        return x, abs(g[j]), j

    iters, it_prev = 0, -1
    while rnorm > target and iters < maxiter and it_prev != 0:
        r = b - A(x)
        x, rnorm, it_prev = cycle(x, r, torch.sqrt(_dot_(r, r)))
        if bd != dtype:
            rt = b - A(x)
            rnorm = host(torch.sqrt(_dot_(rt, rt)))
        iters += it_prev
    # the true residual (the Givens estimate can drift over restarts)
    rtrue = b - A(x)
    rnorm_t = torch.sqrt(_dot_(rtrue, rtrue))
    return x, SolveInfo(iters, rnorm_t, rnorm_t <= target)
