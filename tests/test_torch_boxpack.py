# flow_tpu_torch.fem.boxpack.BoxPack against the JAX package's BoxPack on
# the anisotropic box of tests/test_boxpack.py, in float64 on the CPU, at
# that file's tolerances.
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from flow_tpu.fem.boxpack import BoxPack as JaxBoxPack
from flow_tpu.mesh3d import box_mesh as jax_box_mesh
from flow_tpu_torch.fem.boxpack import BoxPack
from flow_tpu_torch.mesh3d import box_mesh
from flow_tpu_torch.ops import boxmom

torch.set_num_threads(1)

BOX = ((0, 0, 0), (1.0, 1.1, 0.9), 4, 5, 6)


@pytest.fixture(scope="module")
def packs():
    jbp = JaxBoxPack(jax_box_mesh(*BOX, dtype=jnp.float64))
    tbp = BoxPack(box_mesh(*BOX, dtype=torch.float64, device="cpu"))
    rng = np.random.default_rng(0)
    data = {
        "U": rng.standard_normal(3 * tbp.n2),
        "T": rng.standard_normal(3 * tbp.n2),
        "p": rng.standard_normal(tbp.n1),
    }
    return jbp, tbp, data


def _both(data, key):
    return jnp.asarray(data[key]), torch.as_tensor(data[key])


def test_layout_maps_match_jax(packs):
    jbp, tbp, _ = packs
    assert tbp.block_dims == jbp.block_dims
    np.testing.assert_array_equal(tbp.offsets, jbp.offsets)
    np.testing.assert_array_equal(tbp.slot_of_dof, jbp.slot_of_dof)
    x = np.random.default_rng(1).standard_normal(tbp.n2)
    np.testing.assert_array_equal(
        tbp.from_packed(tbp.to_packed(x)).numpy(), x
    )
    np.testing.assert_array_equal(
        tbp.to_packed(x).numpy(), np.asarray(jbp.to_packed(jnp.asarray(x)))
    )


def _apply(bp, name, U, T, p, xp):
    if name == "mass_apply_vec":
        return bp.mass_apply_vec(U)
    if name == "div_rhs":
        return bp.div_rhs(U)
    if name == "pressure_grad_rhs":
        return bp.pressure_grad_rhs(p)
    if name == "grad_div_cell":
        return bp.grad_div_cell(U)
    if name == "grad_div_rhs":
        return bp.grad_div_rhs(U)
    if name == "grad_phi_rhs":
        return bp.grad_phi_rhs(p)
    if name == "grad_phi_rhs_div":
        return bp.grad_phi_rhs(p, div_part=bp.grad_div_cell(U), mu=0.013)
    if name == "conv_tables":
        return bp.conv_tables(T)
    if name == "momentum_apply":
        return bp.momentum_apply(bp.conv_tables(T), U, 0.017, 0.6)
    if name == "momentum_apply_tensor_scales":
        # the stepper passes s*mu and s*rho as 0-d tensors of the state dtype
        return bp.momentum_apply(
            bp.conv_tables(T), U, xp.asarray(0.017, dtype=xp.float64),
            xp.asarray(0.6, dtype=xp.float64),
        )
    if name == "momentum_operator":
        if xp is jnp:  # the JAX package has the plain composition only
            return bp.momentum_apply(bp.conv_tables(T), U, 0.017, 0.6)
        return bp.momentum_operator(T, 0.017, 0.6)(U)
    if name == "momentum_operator_tensor_scales":
        if xp is jnp:
            return _apply(bp, "momentum_apply_tensor_scales", U, T, p, xp)
        return bp.momentum_operator(T, torch.tensor(0.017, dtype=torch.float64),
                                    torch.tensor(0.6, dtype=torch.float64))(U)
    raise KeyError(name)


@pytest.mark.parametrize(
    "name,atol",
    [
        ("mass_apply_vec", 1e-13),
        ("div_rhs", 1e-13),
        ("pressure_grad_rhs", 1e-13),
        ("grad_div_cell", 1e-11),
        ("grad_div_rhs", 1e-11),
        ("grad_phi_rhs", 1e-13),
        ("grad_phi_rhs_div", 1e-11),
        ("conv_tables", 1e-11),
        ("momentum_apply", 1e-11),
        ("momentum_apply_tensor_scales", 1e-11),
        ("momentum_operator", 1e-11),
        ("momentum_operator_tensor_scales", 1e-11),
    ],
)
def test_operator_matches_jax(packs, name, atol):
    jbp, tbp, data = packs
    (Uj, Ut), (Tj, Tt), (pj, pt) = (_both(data, k) for k in ("U", "T", "p"))
    y_jax = _apply(jbp, name, Uj, Tj, pj, jnp)
    y = _apply(tbp, name, Ut, Tt, pt, torch)
    if isinstance(y, list):
        assert len(y) == len(y_jax) == 6
        for a, b in zip(y, y_jax):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=atol)
    else:
        assert tuple(y.shape) == tuple(y_jax.shape)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_jax), rtol=0, atol=atol)


@pytest.mark.parametrize("scales", ["float", "tensor"])
def test_momentum_operator_is_the_plain_composition_on_the_cpu(packs, scales):
    _, tbp, data = packs
    U, T = (torch.as_tensor(data[k]) for k in ("U", "T"))
    s_mu, s_rho = 0.017, 0.6
    if scales == "tensor":
        s_mu, s_rho = torch.tensor(s_mu, dtype=torch.float64), torch.tensor(s_rho, dtype=torch.float64)
    y = tbp.momentum_apply(tbp.conv_tables(T), U, s_mu, s_rho)
    assert torch.equal(tbp.momentum_operator(T, s_mu, s_rho)(U), y)
    assert torch.equal(boxmom.box_momentum_apply(tbp, T, U, s_mu, s_rho), y)


def test_momentum_wrapper_refuses_a_device_without_the_kernel(packs):
    _, tbp, data = packs
    U, T = (torch.as_tensor(data[k]).to("meta") for k in ("U", "T"))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        boxmom.box_momentum_apply(tbp, T, U, 0.017, 0.6)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tbp.momentum_operator(T, 0.017, 0.6)(U)


def test_momentum_kernel_tables_give_the_plain_operator(packs):
    # the arithmetic of csrc/boxmom.cu on its constant records
    # (boxmom.momentum_constants), vectorised over the cubes of each tet type
    # and added into the packed output as the plain version adds: the mass
    # and skew convection on the convection rule, the stress on
    # boxmom.stress_rule, T taken into the reference frame first
    _, tbp, data = packs
    U, T = (torch.as_tensor(data[k]) for k in ("U", "T"))
    s_mu, s_rho = 0.017, 0.6
    cs = boxmom.momentum_constants(tbp)
    nq, ns = len(tbp.qw), len(boxmom.stress_rule()[1])
    q = cs[:nq * 52].reshape(nq, 52)
    s = cs[nq * 52:nq * 52 + ns * 32].reshape(ns, 32)
    types = cs[nq * 52 + ns * 32:].reshape(6, 12)
    Xb = [tbp.unflatten(c) for c in tbp.comps(U)]
    Tb = [tbp.unflatten(c) for c in tbp.comps(T)]
    out, accs = tbp._zeros_vec(U.dtype)
    c = 0.5 * s_rho
    for t in range(6):
        G = torch.as_tensor(types[t, :9].reshape(3, 3))
        x = tbp._stack_comps(Xb, t)  # [3(b), 10(j), ...]
        Tp = torch.einsum("dk,dl...->kl...", G, tbp._stack_comps(Tb, t))
        y = torch.zeros_like(x)
        for r in torch.as_tensor(q):
            phi, dphi, wphi, w = r[:10], r[10:40].reshape(10, 3), r[40:50], r[50]
            A = torch.einsum("mk,k...->m...", dphi, torch.einsum("l,kl...->k...", phi, Tp))
            xa = torch.einsum("j...,bj...->b...", A, x)
            xp = torch.einsum("j,bj...->b...", phi, x)
            y += wphi[None, :, None, None, None] * (xp + c * xa)[:, None]
            y -= A[None] * (c * w * xp)[:, None]
        for r in torch.as_tensor(s):
            d2, w2 = r[:30].reshape(10, 3), r[30]
            gp = torch.einsum("dk,jk,bj...->bd...", G, d2, x)  # d_d u_b
            h = (w2 * s_mu) * torch.einsum("ab...,bl->al...", gp + gp.transpose(0, 1), G)
            y += torch.einsum("al...,il->ai...", h, d2)
        y *= float(types[t, 9])
        for a in range(3):
            tbp.acc_stack2(accs[a], t, y[a])
    y_plain = tbp.momentum_apply(tbp.conv_tables(T), U, s_mu, s_rho)
    np.testing.assert_allclose(out.numpy(), y_plain.numpy(), rtol=0, atol=1e-12)


def test_momentum_launch_struct_mirrors_the_c_struct():
    # csrc/boxmom.cu's BoxMomArgs and ops/boxmom.py's _BoxMomArgs: the same
    # fields in the same order and sizes
    import ctypes
    import math
    import re

    from flow_tpu_torch import _build

    text = (_build.CSRC_DIR / "boxmom.cu").read_text()
    start = text.index("struct BoxMomArgs {")
    body = text[start:text.index("};", start)]
    size = {"int": 4, "double": 8, "const void*": 8, "unsigned char": 1}
    want = []
    for ctype, names in re.findall(r"^\s*(int|double|const void\*|unsigned char)\s+([^;]+);",
                                   body, re.M):
        for name in names.split(","):
            dims = [int(d) for d in re.findall(r"\[(\d+)\]", name)]
            want.append((name.split("[")[0].strip(), size[ctype] * math.prod(dims)))
    got = [(name, ctypes.sizeof(t)) for name, t in boxmom._BoxMomArgs._fields_]
    assert got == want
