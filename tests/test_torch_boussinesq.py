# The coupled Boussinesq driver of flow_tpu_torch against the JAX
# package's on the CPU in float64 (lcar = 0.03 + one uniform refinement:
# 456 temperature dofs, so the heat solve takes the dense path in both).
# The packed route to t = 0.3 (5 steps, 6 Banach sweeps: the heater ramp
# moves the fluid from the third step on; before it the momentum residual
# is below the absolute tolerance and every solve takes 0 iterations):
# equal Picard, GMRES, pressure and correction iterations a sweep, u and
# theta within 1e-8 (the JAX route test's standard); every packed step
# the JAX driver took replayed through the port's
# Rotational(backend="packed") (the public scheme on the packed route
# against the JAX package's packed route, same counts, u within 1e-12,
# p within 1e-10 of max|p|); the einsum route (backend=None) without
# refinement to the same time, equal Newton, pressure and correction
# iterations, u and theta within 1e-8. Each package's packed run writes its
# steps through its XDMFFile: the same XML text, the same datasets, values
# within 1e-8 of their largest entries. The goldens of
# tests/test_boussinesq.py (lcar = 0.01, t = 1.0, 1e-6 relative) are
# slow-marked, as the JAX package's are.
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import flow_tpu.navier_stokes.packedapi as jpa
import flow_tpu.navier_stokes.pressure_correction as jpc
from flow_tpu.models.boussinesq import compute_boussinesq as jax_boussinesq
from flow_tpu.navier_stokes import patchfast as jpf

import flow_tpu_torch
from flow_tpu_torch import norm
from flow_tpu_torch.models.boussinesq import compute_boussinesq
from flow_tpu_torch.navier_stokes import Rotational

torch.set_num_threads(1)
KW = dict(target_time=0.3, lcar=0.03, supg=False, dt0=1e-2)
PACKED_KEYS = ("newton_iters", "linear_iters", "pressure_iters", "correction_iters")


@pytest.fixture(scope="module")
def packed_runs(tmp_path_factory):
    """The JAX driver's packed run with its packed steps recorded (inputs,
    outputs and StepStats), and the port's with its telemetry; each writes
    its steps to <dir>/jax/b.xdmf and <dir>/port/b.xdmf."""
    from flow_tpu.io import XDMFFile as JaxXDMFFile
    from flow_tpu_torch.io import XDMFFile

    out_dir = tmp_path_factory.mktemp("boussinesq")
    (out_dir / "jax").mkdir()
    (out_dir / "port").mkdir()
    steps, stats = [], []
    mp = pytest.MonkeyPatch()
    orig_try, orig_api = jpa.try_packed_step, jpf.PackedPatchStepper.step_api

    def try_packed_step(dt, u, p0, u_bcs, p_bcs, rho, mu, method, f, rot, tol,
                        cfg, **kw):
        out = orig_try(dt, u, p0, u_bcs, p_bcs, rho, mu, method, f, rot, tol, cfg,
                       **kw)
        steps.append(dict(dt=dt, u0=np.asarray(u[0].vector),
                          p0=np.asarray(p0.vector), f=np.asarray(f[1].vector),
                          rho=rho, mu=mu, u1=np.asarray(out[0].vector),
                          p1=np.asarray(out[1].vector)))
        return out

    def step_api(self, *a, **k):
        out = orig_api(self, *a, **k)
        stats.append(tuple(int(getattr(out[2], key)) for key in PACKED_KEYS))
        return out

    mp.setattr(jpa, "try_packed_step", try_packed_step)
    mp.setattr(jpf.PackedPatchStepper, "step_api", step_api)
    try:
        with JaxXDMFFile(str(out_dir / "jax" / "b.xdmf")) as jxf:
            ju, _, jt = jax_boussinesq(backend="packed", n_refine=1, writer=jxf, **KW)
    finally:
        mp.undo()
    tel = []
    with XDMFFile(str(out_dir / "port" / "b.xdmf")) as txf:
        tu, _, tt = compute_boussinesq(backend="packed", n_refine=1, device="cpu",
                                       telemetry=tel, writer=txf, **KW)
    return (ju, jt, steps, stats), (tu, tt, tel), out_dir


def test_packed_driver_matches_jax(packed_runs):
    (ju, jt, _, jstats), (tu, tt, tel), _ = packed_runs
    assert [tuple(r[k] for k in PACKED_KEYS) for r in tel] == jstats
    assert [r["heat_solver"] for r in tel] == ["dense"] * len(tel)
    assert len({r["step"] for r in tel}) == 5 and len(tel) == 6
    assert sum(r["linear_iters"] for r in tel) > 0
    du = np.abs(tu.vector.numpy() - np.asarray(ju.vector)).max()
    dth = np.abs(tt.vector.numpy() - np.asarray(jt.vector)).max()
    assert du < 1e-8 and dth < 1e-8, (du, dth)
    assert np.abs(np.asarray(ju.vector)).max() > 1e-6


def test_packed_scheme_matches_jax_packed_route(packed_runs):
    (_, _, steps, jstats), _, _ = packed_runs
    mesh = flow_tpu_torch.rectangle_with_hole_mesh(
        0.0, 0.1, 0.0, 0.2, cx=0.05, cy=0.05, r=0.02, lcar=KW["lcar"],
        dtype=torch.float64, device="cpu")
    mesh = flow_tpu_torch.refine_uniform(mesh)
    V = flow_tpu_torch.VectorFunctionSpace(mesh, 2)
    Q = flow_tpu_torch.FunctionSpace(mesh, 1)
    u_bcs = [flow_tpu_torch.DirichletBC(V, (0.0, 0.0), "on_boundary")]
    stepper = Rotational(backend="packed")
    moved = 0
    for rec, counts in zip(steps, jstats):
        F = flow_tpu_torch.Function(V, torch.as_tensor(rec["f"]))
        u1, p1 = stepper.step(
            rec["dt"], {0: flow_tpu_torch.Function(V, torch.as_tensor(rec["u0"]))},
            flow_tpu_torch.Function(Q, torch.as_tensor(rec["p0"])), u_bcs, [],
            rec["rho"], rec["mu"], f={0: F, 1: F}, verbose=False, tol=1e-10)
        assert tuple(stepper.last_stats[k] for k in PACKED_KEYS) == counts
        np.testing.assert_allclose(u1.vector.numpy(), rec["u1"], rtol=0, atol=1e-12)
        np.testing.assert_allclose(p1.vector.numpy(), rec["p1"], rtol=0,
                                   atol=1e-10 * np.abs(rec["p1"]).max())
        moved += counts[1] > 0
    assert moved >= 3


def test_packed_driver_writes_the_jax_series(packed_runs):
    import h5py

    _, (tu, tt, tel), out_dir = packed_runs
    text = (out_dir / "port" / "b.xdmf").read_text()
    assert text == (out_dir / "jax" / "b.xdmf").read_text()
    n_steps = len({r["step"] for r in tel})
    with h5py.File(out_dir / "jax" / "b.h5") as jh, h5py.File(out_dir / "port" / "b.h5") as th:
        names = []
        jh.visit(names.append)
        other = []
        th.visit(other.append)
        assert sorted(names) == sorted(other)
        data = [k for k in names if isinstance(jh[k], h5py.Dataset) and "/" in k
                and not k.startswith("mesh/")]
        assert len(data) == 3 * n_steps  # temperature, velocity, pressure a step
        np.testing.assert_array_equal(th["mesh/cells"][...], jh["mesh/cells"][...])
        for k in data:
            a, b = th[k][...], jh[k][...]
            assert a.shape == b.shape, k
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-8 * max(np.abs(b).max(), 1e-300),
                                       err_msg=k)
        last_theta = max((k for k in data if int(k.split("/")[1]) % 3 == 0),
                         key=lambda k: int(k.split("/")[1]))
        npts = th["mesh/points"].shape[0]
        np.testing.assert_array_equal(th[last_theta][...], tt.vector.numpy()[:npts])


def test_einsum_driver_matches_jax(monkeypatch):
    rec = []
    orig_get = jpc._get_ctx

    def get_ctx(V, Q):
        ctx = orig_get(V, Q)
        if not getattr(ctx, "_counted", False):
            for name, k in (("_tentative_newton", 2), ("_pressure_solve", 1),
                            ("_velocity_correction", 1)):
                fn = getattr(ctx, name)

                def wrapped(*a, fn=fn, k=k, **kw):
                    out = fn(*a, **kw)
                    rec.append(int(out[k]))
                    return out

                setattr(ctx, name, wrapped)
            ctx._counted = True
        return ctx

    monkeypatch.setattr(jpc, "_get_ctx", get_ctx)
    ju, _, jt = jax_boussinesq(n_refine=0, **KW)
    tel = []
    tu, _, tt = compute_boussinesq(n_refine=0, device="cpu", telemetry=tel, **KW)
    counts = [n for r in tel for n in (r["newton_iters"], r["pressure_iters"],
                                       r["correction_iters"])]
    assert counts == rec and sum(counts) > 0
    du = np.abs(tu.vector.numpy() - np.asarray(ju.vector)).max()
    dth = np.abs(tt.vector.numpy() - np.asarray(jt.vector)).max()
    assert du < 1e-8 and dth < 1e-8, (du, dth)


# the goldens of tests/test_boussinesq.py (made on the JAX package)
@pytest.mark.slow
@pytest.mark.parametrize("supg,u_ref,theta_ref", [
    (False, 4.770048096036418e-06, 40.18227533538666),
    (True, 4.770047249301352e-06, 40.18227533334490),
])
def test_boussinesq_goldens(supg, u_ref, theta_ref):
    u1, _, theta1 = compute_boussinesq(target_time=1.0, lcar=0.01, supg=supg,
                                       device="cpu")
    assert abs(norm(u1, "L2") - u_ref) < 1.0e-6 * u_ref
    assert abs(norm(theta1, "L2") - theta_ref) < 1.0e-6 * theta_ref
