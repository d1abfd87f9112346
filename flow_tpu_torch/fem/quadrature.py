# Quadrature rules on the reference simplices and the reference edge. Port
# of flow_tpu/fem/quadrature.py (host numpy + scipy, unchanged).
#
# Weights sum to the reference-cell measure (1/2 for the triangle, 1/6 for
# the tetrahedron, 1 for the edge), so physical integrals are
# sum_q w_q * |detJ| * f(x_q).
from __future__ import annotations

import numpy as np

__all__ = ["triangle_rule", "edge_rule", "tet_rule", "simplex_rule", "VERTEX"]

# the vertex rule (mass lumping), selected by this degree
VERTEX = "vertex"


def _perm3(a):
    b = 1.0 - 2.0 * a
    return [(b, a, a), (a, b, a), (a, a, b)]


def _perm_full(a, b):
    c = 1.0 - a - b
    return [(a, b, c), (a, c, b), (b, a, c), (b, c, a), (c, a, b), (c, b, a)]


def triangle_rule(degree):
    """(points [nq,2], weights [nq]) on the reference triangle, exact for
    polynomials of `degree` (Strang-Fix/Dunavant rules up to degree 6);
    degree=VERTEX gives the 3-point vertex rule."""
    if degree == VERTEX:
        bary = [(1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0)]
        w = [1.0 / 3.0] * 3
    elif degree <= 1:
        bary = [(1 / 3, 1 / 3, 1 / 3)]
        w = [1.0]
    elif degree == 2:
        bary = _perm3(1.0 / 6.0)
        w = [1.0 / 3.0] * 3
    elif degree == 3:
        bary = [(1 / 3, 1 / 3, 1 / 3)] + _perm3(0.2)
        w = [-27.0 / 48.0] + [25.0 / 48.0] * 3
    elif degree == 4:
        bary = _perm3(0.445948490915965) + _perm3(0.091576213509771)
        w = [0.223381589678011] * 3 + [0.109951743655322] * 3
    elif degree == 5:
        bary = (
            [(1 / 3, 1 / 3, 1 / 3)]
            + _perm3(0.470142064105115)
            + _perm3(0.101286507323456)
        )
        w = [0.225] + [0.132394152788506] * 3 + [0.125939180544827] * 3
    else:
        # Dunavant degree 6, 12 points
        bary = (
            _perm3(0.249286745170910)
            + _perm3(0.063089014491502)
            + _perm_full(0.310352451033785, 0.053145049844816)
        )
        w = (
            [0.116786275726379] * 3
            + [0.050844906370207] * 3
            + [0.082851075618374] * 6
        )
    bary = np.array(bary, dtype=np.float64)
    pts = bary[:, 1:3]  # (x, y) = (lambda_1, lambda_2)
    wts = 0.5 * np.array(w, dtype=np.float64)
    return pts, wts


def edge_rule(degree):
    """Gauss-Legendre on [0,1]: (points [nq], weights [nq])."""
    n = max(1, (degree + 2) // 2)
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


def tet_rule(degree):
    """Quadrature on the reference tetrahedron {x,y,z>=0, x+y+z<=1}: a
    conical-product Gauss-Jacobi rule, exact for polynomials of `degree` by
    construction (collapsed-coordinate map with Jacobi(2,0) and Jacobi(1,0)
    weights absorbing the Duffy Jacobian). Weights sum to 1/6.
    degree=VERTEX gives the 4-point vertex rule."""
    if degree == VERTEX:
        pts = np.array(
            [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
        )
        return pts, np.full(4, 1.0 / 24.0)

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
    return triangle_rule(degree) if dim == 2 else tet_rule(degree)
