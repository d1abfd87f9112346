# A small form-to-kernel compiler: symbolic weak-form integrands compiled to
# batched einsum element kernels. Port of flow_tpu/fem/formlang.py (v1 scalar
# and component-diagonal forms, v2 coupled vector forms).
#
# The user writes the integrand of a bilinear or linear form symbolically
# (TestFunction/TrialFunction/Coefficient plus grad/div/dot/inner/sym/
# transpose/lap and arithmetic), and compile_form emits the element kernel: a
# labelled-tensor einsum chain over all cells at once, computed on the
# mesh's device in the mesh's dtype. Tabulations and the geometry stay host
# numpy (fem/assembly.py) and move to the device once per (dtype, device).
#
# Semantics: an expression labels every tensor axis with one of
#   e  cells                    q  quadrature points
#   i  test local dof           j  trial local dof
#   a  test component           b  trial component
#   m  value axis of a vector-valued expression
#   d  spatial derivative axis  c  coefficient component axis
# Products align shared labels (element-wise) and keep the union, a shared
# value axis m contracting; dot() contracts the trailing spatial/component
# label shared by its operands; inner() contracts m and d. Integration
# multiplies by the quadrature weights * |detJ| and sums over q, leaving the
# element kernel:
#   bilinear  -> local matrices  [nc, nl_i, nl_j(,a)(,b)]
#   linear    -> local vectors   [nc, nl_i(,a|c)]
from __future__ import annotations

import numpy as np
import torch

from . import assembly, elements, quadrature
from .spaces import Function, FunctionSpace

__all__ = [
    "TestFunction",
    "TrialFunction",
    "Coefficient",
    "grad",
    "div",
    "dot",
    "inner",
    "sym",
    "transpose",
    "lap",
    "compile_form",
    "CompiledForm",
]

# canonical axis order of labelled tensors
CANON = "eqijabmdc"


# ---------------------------------------------------------------------------
# Expression nodes
# ---------------------------------------------------------------------------
class Expr:
    def __add__(self, other):
        return Sum(self, _wrap(other))

    def __radd__(self, other):
        return Sum(_wrap(other), self)

    def __sub__(self, other):
        return Sum(self, Product(Const(-1.0), _wrap(other)))

    def __rsub__(self, other):
        return Sum(_wrap(other), Product(Const(-1.0), self))

    def __mul__(self, other):
        return Product(self, _wrap(other))

    def __rmul__(self, other):
        return Product(_wrap(other), self)

    def __neg__(self):
        return Product(Const(-1.0), self)


def _wrap(x):
    if isinstance(x, Expr):
        return x
    if np.isscalar(x):
        return Const(float(x))
    raise TypeError(f"cannot use {type(x)} in a form")


class Const(Expr):
    def __init__(self, value):
        self.value = float(value)


class TestFunction(Expr):
    def __init__(self, space: FunctionSpace):
        self.space = space


class TrialFunction(Expr):
    def __init__(self, space: FunctionSpace):
        self.space = space


class Coefficient(Expr):
    """A known field in the integrand.

    kind 'function': an FE Function (tabulated at quadrature points);
    kind 'callable': f(x [nc,nq,dim] tensor) -> [nc,nq] or [nc,nq,c]
    (evaluated at the physical quadrature points, on the mesh's device in
    its dtype); kind 'qp': a precomputed [nc,nq(,c)] array or tensor.
    """

    def __init__(self, value, vector=False):
        self.vector = vector
        if isinstance(value, Function):
            self.kind = "function"
            self.fn = value
            self.vector = value.space.n_components > 1
        elif callable(value):
            self.kind = "callable"
            self.fn = value
        else:
            self.kind = "qp"
            self.fn = value


class Grad(Expr):
    def __init__(self, arg):
        self.arg = arg


class Div(Expr):
    """Divergence of a vector test/trial function or vector Function."""

    def __init__(self, arg):
        self.arg = arg


class Transpose(Expr):
    """Swap the value (m) and derivative (d) axes of a matrix-valued
    expression: grad(u)^T."""

    def __init__(self, arg):
        self.arg = arg


class Inner(Expr):
    """Double contraction A:B of matrix-valued expressions."""

    def __init__(self, a, b):
        self.a = a
        self.b = b


class Lap(Expr):
    """Basis Laplacian tr(hessian) of a trial/test function: the SUPG
    strong-residual term (constant per element for P2, zero for P1)."""

    def __init__(self, arg):
        assert isinstance(arg, (TrialFunction, TestFunction))
        self.arg = arg


class Dot(Expr):
    def __init__(self, a, b):
        self.a = a
        self.b = b


class Sum(Expr):
    def __init__(self, a, b):
        self.a = a
        self.b = b


class Product(Expr):
    def __init__(self, a, b):
        self.a = a
        self.b = b


def grad(e):
    return Grad(e)


def div(e):
    return Div(e)


def transpose(e):
    return Transpose(e)


def sym(e):
    """Symmetric gradient part: sym(g) = 0.5 (g + g^T)."""
    return Product(Const(0.5), Sum(e, Transpose(e)))


def inner(a, b):
    return Inner(_wrap(a), _wrap(b))


def lap(e):
    return Lap(e)


def dot(a, b):
    return Dot(_wrap(a), _wrap(b))


# ---------------------------------------------------------------------------
# Labelled-tensor evaluation
# ---------------------------------------------------------------------------
class _LT:
    """A tensor with per-axis labels from CANON."""

    def __init__(self, data, dims: str):
        assert data.dim() == len(dims), (tuple(data.shape), dims)
        self.data = data
        self.dims = dims


def _canon_sort(lt: _LT) -> _LT:
    """Reorder axes into canonical label order."""
    want = "".join(l for l in CANON if l in lt.dims)
    if want == lt.dims:
        return lt
    return _LT(torch.einsum(f"{lt.dims}->{want}", lt.data), want)


def _lt_mul(a: _LT, b: _LT) -> _LT:
    # a shared value axis 'm' contracts: u * v == dot(u, v) for vectors
    drop = "m" if ("m" in a.dims and "m" in b.dims) else ""
    out = "".join(d for d in CANON if (d in a.dims or d in b.dims) and d != drop)
    return _LT(torch.einsum(f"{a.dims},{b.dims}->{out}", a.data, b.data), out)


# value-like axes a dot() may contract, in preference order: the derivative
# axis first (dot(w, grad(u)) is (w.grad)u), then the vector value axis,
# then the coefficient component axis
_VALUE_AXES = ("d", "m", "c")


def _lt_contract(a: _LT, b: _LT) -> _LT:
    # contract ONE value-like label both operands share; where they carry
    # different ones, the lower-preference label is renamed to the higher
    # one first (a vector coefficient's components are spatial directions)
    for hi in _VALUE_AXES:
        ha, hb = hi in a.dims, hi in b.dims
        if ha and hb:
            break
        if ha or hb:
            other = b if ha else a
            for lo in _VALUE_AXES:
                if lo != hi and lo in other.dims and hi not in other.dims:
                    renamed = _canon_sort(_LT(other.data, other.dims.replace(lo, hi)))
                    if ha:
                        b = renamed
                    else:
                        a = renamed
                    break
            if hi in a.dims and hi in b.dims:
                break
    for lab in _VALUE_AXES:
        if lab in a.dims and lab in b.dims:
            keep = "".join(x for x in CANON
                           if (x in a.dims or x in b.dims) and x != lab)
            data = torch.einsum(f"{a.dims},{b.dims}->{keep}", a.data, b.data)
            return _LT(data, keep)
    raise ValueError(
        f"dot() operands share no spatial/component axis: {a.dims},{b.dims}"
    )


def _lt_inner(a: _LT, b: _LT) -> _LT:
    # double contraction over the matrix value axes (m, d) both share; a
    # coefficient's component axis 'c' pairs against the other operand's 'm'
    if "c" in a.dims and "m" not in a.dims and "m" in b.dims:
        a = _canon_sort(_LT(a.data, a.dims.replace("c", "m")))
    if "c" in b.dims and "m" not in b.dims and "m" in a.dims:
        b = _canon_sort(_LT(b.data, b.dims.replace("c", "m")))
    labs = [l for l in ("m", "d") if l in a.dims and l in b.dims]
    if not labs:
        raise ValueError(f"inner() operands share no m/d axes: {a.dims},{b.dims}")
    keep = "".join(x for x in CANON
                   if (x in a.dims or x in b.dims) and x not in labs)
    return _LT(torch.einsum(f"{a.dims},{b.dims}->{keep}", a.data, b.data), keep)


def _lt_add(a: _LT, b: _LT) -> _LT:
    out = "".join(d for d in CANON if d in a.dims or d in b.dims)

    def expand(t: _LT):
        # t.dims is a subsequence of out: insert the missing axes
        x = t.data
        for pos, lab in enumerate(out):
            if lab not in t.dims:
                x = x.unsqueeze(pos)
        return x

    return _LT(expand(a) + expand(b), out)


class _Ctx:
    """What _eval reads: the host geometry (physical points), its device
    copy, the quadrature rule and the dtype and device of the result."""

    def __init__(self, geom, mesh, rule, dtype, device):
        self.geom = geom
        self.dgeom = assembly.geometry_on(mesh, dtype, device)
        self.rule = rule
        self.dtype = dtype
        self.device = device
        self.dim = geom.dim
        self._xq = None

    def tab(self, space):
        """Device copies of the tabulation of `space` at the form's rule."""
        return assembly._tab_cached(space.degree, self.rule, self.dim).on(
            self.dtype, self.device)

    def tensor(self, a):
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    def eye(self, n):
        return torch.eye(n, dtype=self.dtype, device=self.device)

    def xq(self):
        """Physical quadrature points [nc, nq, dim]."""
        if self._xq is None:
            ref_pts, _ = quadrature.simplex_rule(self.rule, self.dim)
            self._xq = self.tensor(self.geom.physical_points(ref_pts))
        return self._xq

    def ref_grads(self, space):
        """Physical basis gradients [e,q,l,d]."""
        t = self.tab(space)
        return torch.einsum("qlk,edk->eqld", t.dphi, self.dgeom.G)


def _eval(node, ctx: _Ctx) -> _LT:
    if isinstance(node, Const):
        return _LT(ctx.tensor(node.value), "")

    if isinstance(node, (TestFunction, TrialFunction)):
        t = ctx.tab(node.space)
        test = isinstance(node, TestFunction)
        if node.space.n_components > 1:
            # vector basis (i, a): phi_i e_a, value axis m through a delta
            eye = ctx.eye(node.space.n_components)
            dims = "qiam" if test else "qjbm"
            return _LT(torch.einsum(f"{dims[:2]},{dims[2:]}->{dims}", t.phi, eye), dims)
        return _LT(t.phi, "qi" if test else "qj")

    if isinstance(node, Coefficient):
        if node.kind == "function":
            f = node.fn
            t = ctx.tab(f.space)
            vals = assembly.values_at_qp(t, f.space.gather(ctx.tensor(f.vector)))
            return _LT(vals, "eqc" if node.vector else "eq")
        if node.kind == "callable":
            vals = ctx.tensor(node.fn(ctx.xq()))
            if node.vector and vals.dim() == 2:
                raise ValueError("vector callable must return [nc,nq,c]")
            return _LT(vals, "eqc" if vals.dim() == 3 else "eq")
        vals = ctx.tensor(node.fn)
        return _LT(vals, "eqc" if vals.dim() == 3 else "eq")

    if isinstance(node, Grad):
        arg = node.arg
        if isinstance(arg, (TestFunction, TrialFunction)):
            g = ctx.ref_grads(arg.space)
            test = isinstance(arg, TestFunction)
            if arg.space.n_components > 1:
                eye = ctx.eye(arg.space.n_components)
                dims = "eqiamd" if test else "eqjbmd"
                return _LT(torch.einsum(f"eq{dims[2]}d,{dims[3:5]}->{dims}", g, eye),
                           dims)
            return _LT(g, "eqid" if test else "eqjd")
        if isinstance(arg, Coefficient) and arg.kind == "function":
            f = arg.fn
            t = ctx.tab(f.space)
            g = assembly.grads_at_qp(t, ctx.dgeom, f.space.gather(ctx.tensor(f.vector)))
            # vector Function gradients use the value axis m (so inner()
            # against test/trial gradients pairs correctly)
            return _LT(g, "eqmd" if arg.vector else "eqd")
        raise ValueError("grad() supports test/trial functions and FE Functions")

    if isinstance(node, Div):
        arg = node.arg
        if isinstance(arg, (TestFunction, TrialFunction)):
            assert arg.space.n_components > 1, "div() needs a vector function"
            # div of basis (l, comp) = d_comp phi_l: the derivative axis IS
            # the dof-component axis
            g = ctx.ref_grads(arg.space)
            return _LT(g, "eqia" if isinstance(arg, TestFunction) else "eqjb")
        if isinstance(arg, Coefficient) and arg.kind == "function":
            f = arg.fn
            assert arg.vector
            t = ctx.tab(f.space)
            g = assembly.grads_at_qp(t, ctx.dgeom, f.space.gather(ctx.tensor(f.vector)))
            return _LT(torch.diagonal(g, dim1=2, dim2=3).sum(-1), "eq")
        raise ValueError("div() supports test/trial functions and FE Functions")

    if isinstance(node, Transpose):
        lt = _eval(node.arg, ctx)
        if "m" not in lt.dims or "d" not in lt.dims:
            raise ValueError(f"transpose() needs a matrix-valued operand, got {lt.dims}")
        data = torch.swapaxes(lt.data, lt.dims.index("m"), lt.dims.index("d"))
        return _LT(data, lt.dims)

    if isinstance(node, Inner):
        return _lt_inner(_eval(node.a, ctx), _eval(node.b, ctx))

    if isinstance(node, Lap):
        arg = node.arg
        Href = ctx.tensor(elements.hessian_ref(arg.space.degree, ctx.dim))
        G = ctx.dgeom.G
        lapv = torch.einsum("eak,lkm,eam->el", G, Href, G)
        return _LT(lapv, "ei" if isinstance(arg, TestFunction) else "ej")

    if isinstance(node, Dot):
        return _lt_contract(_eval(node.a, ctx), _eval(node.b, ctx))

    if isinstance(node, Sum):
        return _lt_add(_eval(node.a, ctx), _eval(node.b, ctx))

    if isinstance(node, Product):
        return _lt_mul(_eval(node.a, ctx), _eval(node.b, ctx))

    raise TypeError(f"unknown node {type(node)}")


# ---------------------------------------------------------------------------
# Compilation
# ---------------------------------------------------------------------------
class CompiledForm:
    """The emitted element kernel.

    bilinear: local() -> [nc, nl_i, nl_j(,a)(,b)] (a/b = test/trial
              component axes of coupled vector forms); apply(U) -> K U
              matrix-free (scalar U, component-diagonal [n, m] U, or the
              coupled vector cases); assemble_diag() -> operator diagonal.
    linear:   local() -> [nc, nl_i(,a|c)]; assemble() -> global vector.
    """

    def __init__(self, space_i, space_j, loc, axes=""):
        self.space_i = space_i
        self.space_j = space_j
        self._loc = loc
        self.axes = axes  # extra component labels beyond eij/ei

    def local(self):
        return self._loc

    # -- linear forms --------------------------------------------------------
    def assemble(self):
        assert self.space_j is None, "assemble() is for linear forms"
        return self.space_i.dof_sum(self._loc)

    # -- bilinear forms ------------------------------------------------------
    def apply(self, U):
        assert self.space_j is not None
        Uloc = self.space_j.gather(U)
        if self.axes == "":
            eq = "eij,ej->ei" if Uloc.dim() == 2 else "eij,ejm->eim"
        elif self.axes == "ab":  # vector test x vector trial coupling
            eq = "eijab,ejb->eia"
        elif self.axes == "b":  # scalar test x vector trial (q div u)
            eq = "eijb,ejb->ei"
        else:  # "a": vector test x scalar trial (p div v)
            assert self.axes == "a"
            eq = "eija,ej->eia"
        return self.space_i.dof_sum(torch.einsum(eq, self._loc, Uloc))

    def assemble_diag(self):
        assert self.space_j is not None and self.space_i is self.space_j
        if self.axes == "":
            return self.space_i.dof_sum(torch.einsum("eii->ei", self._loc))
        assert self.axes == "ab"
        d = torch.diagonal(self._loc, dim1=1, dim2=2)  # [e, a, b, i]
        d = torch.diagonal(d, dim1=1, dim2=2)  # [e, i, a]
        return self.space_i.dof_sum(d)


def _find_spaces(node, out):
    if isinstance(node, TestFunction):
        out["i"] = node.space
    elif isinstance(node, TrialFunction):
        out["j"] = node.space
    elif isinstance(node, (Grad, Lap, Div, Transpose)):
        _find_spaces(node.arg, out)
    elif isinstance(node, (Sum, Product, Dot, Inner)):
        _find_spaces(node.a, out)
        _find_spaces(node.b, out)
    return out


def compile_form(integrand: Expr, geom, rule_degree):
    """Compile `integrand` (a volume-form density) into its element kernel.

    The integral is sum_e int_e integrand dx, evaluated with a simplex rule
    of the given degree (or quadrature.VERTEX); test/trial spaces are
    discovered from the expression. `geom` is the mesh's host Geometry
    (assembly.geometry). Bilinear (test+trial) -> local matrices; linear
    (test only) -> local load vectors; both on the mesh's device in its
    dtype.
    """
    spaces = _find_spaces(integrand, {})
    assert "i" in spaces, "form must contain a TestFunction"
    space_i = spaces["i"]
    space_j = spaces.get("j")

    mesh = space_i.mesh
    ctx = _Ctx(geom, mesh, rule_degree, mesh.dtype, mesh.device)

    lt = _eval(integrand, ctx)
    comp = "".join(l for l in "ab" if l in lt.dims)
    if space_j is not None:
        want = "eij" + comp
    else:
        want = "ei" + comp + ("c" if "c" in lt.dims else "")
    assert "d" not in lt.dims, "unbalanced derivative axis: missing dot()?"
    assert "m" not in lt.dims, "unbalanced value axis: missing dot()/inner()?"

    # integrate: multiply by w_q * detJ_e and sum over q (or by the cell
    # volume if the integrand is q-independent)
    t = ctx.tab(space_i)
    detJ = ctx.dgeom.detJ
    if "q" in lt.dims:
        wd = t.w[None, :] * detJ[:, None]
        out = torch.einsum(f"{lt.dims},eq->{want}", lt.data, wd)
    else:
        vol = torch.sum(t.w) * detJ
        out = torch.einsum(f"{lt.dims},e->{want}", lt.data, vol)
    return CompiledForm(space_i, space_j, out, axes=want[2 + (space_j is not None):])
