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
