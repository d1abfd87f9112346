# Quadrature rules on the reference simplices. Port of
# flow_tpu/fem/quadrature.py (host numpy + scipy, unchanged), cut to what the
# 3-D box path calls: simplex_rule -> tet_rule.
#
# Weights sum to the reference-cell measure (1/6 for the tetrahedron), so
# physical integrals are sum_q w_q * |detJ| * f(x_q).
from __future__ import annotations

import numpy as np

__all__ = ["tet_rule", "simplex_rule"]


def tet_rule(degree):
    """Quadrature on the reference tetrahedron {x,y,z>=0, x+y+z<=1}: a
    conical-product Gauss-Jacobi rule, exact for polynomials of `degree` by
    construction (collapsed-coordinate map with Jacobi(2,0) and Jacobi(1,0)
    weights absorbing the Duffy Jacobian). Weights sum to 1/6."""
    from scipy.special import roots_jacobi

    n = max(1, (degree + 2) // 2)
    # 1-D rules on [0,1]: Legendre, Jacobi(1,0), Jacobi(2,0)
    x0, w0 = np.polynomial.legendre.leggauss(n)
    x0 = 0.5 * (x0 + 1.0)
    w0 = 0.5 * w0
    x1, w1 = roots_jacobi(n, 1.0, 0.0)
    x1 = 0.5 * (x1 + 1.0)
    w1 = w1 / 2.0**2  # weight function (1-x)^1 on [-1,1] -> [0,1] scaling
    x2, w2 = roots_jacobi(n, 2.0, 0.0)
    x2 = 0.5 * (x2 + 1.0)
    w2 = w2 / 2.0**3

    pts = []
    wts = []
    for i in range(n):
        for j in range(n):
            for k in range(n):
                a, b, c = x2[i], x1[j], x0[k]
                # Duffy map: x = a, y = b(1-a), z = c(1-a)(1-b)
                x = a
                y = b * (1.0 - a)
                z = c * (1.0 - a) * (1.0 - b)
                pts.append((x, y, z))
                wts.append(w2[i] * w1[j] * w0[k])
    return np.array(pts), np.array(wts)


def simplex_rule(degree, dim):
    if dim != 3:
        raise NotImplementedError("the port carries the tetrahedron rules only")
    return tet_rule(degree)
