# Steady Stokes and the 3-D Boussinesq driver of flow_tpu_torch on the card
# against the CPU, in float64:
# - stokes.solve on Guermond1 at n = 16 on the MINRES path (DENSE_THRESHOLD
#   = 0, the CPU run's lambda_max carried to the card; rtol 3e-9, where the
#   recurrence's residual falls 1.9x across the stop, so both sides' last
#   bits stop it at the same iteration): equal iterations, u within 1e-9
#   and p within 1e-7 of their largest entries (the solve's own error
#   against the dense LU is 5.0e-10 and 1.15e-7 on the CPU; card against
#   CPU measured 2.1e-10 and 1.5e-8); the same solve twice on the card is
#   bitwise equal (the operator sums read member tables);
# - compute_boussinesq_3d at n = (4, 4, 8) to t = 0.02 on both routes, and
#   on the packed route at n = (2, 2, 4) to t = 0.62 (the fluid moves in
#   the last step): equal counts a Banach sweep, u within 1e-8 and theta
#   within 1e-10 of their largest entries; the packed route launches K1
#   (its pressure operator and V-cycle levels are StructuredLaplacian);
# - K1 against its plain version in float64 at the packed route's grids.
# Skips without a CUDA device. Imports no JAX, so it runs on the machine
# with the card:
#   python -m pytest --noconftest -q tests/test_torch_boussinesq3d_cuda.py
import numpy as np
import pytest
import torch

import flow_tpu_torch as ft
from flow_tpu_torch import stokes
from flow_tpu_torch.models.boussinesq3d import compute_boussinesq_3d
from flow_tpu_torch.ops import stencil

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)
KEYS = ("heat_solver", "heat_iters", "newton_iters", "linear_iters",
        "pressure_iters", "correction_iters")
PI = np.pi


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the card runs of Stokes and the 3-D driver)")


def _host(fn):
    """A callable of host points [..., 2] as one of host points or tensors."""
    def f(x):
        if isinstance(x, torch.Tensor):
            return torch.as_tensor(fn(x.cpu().numpy()), dtype=x.dtype, device=x.device)
        return fn(x)

    return f


# Guermond1 (tests/test_stokes.py) with mu = 1, written out
U_EXACT = (_host(lambda x: PI * np.sin(2 * PI * x[..., 1]) * np.sin(PI * x[..., 0]) ** 2),
           _host(lambda x: -PI * np.sin(2 * PI * x[..., 0]) * np.sin(PI * x[..., 1]) ** 2))
P_EXACT = _host(lambda x: np.cos(PI * x[..., 0]) * np.sin(PI * x[..., 1]))
F_EXACT = (_host(lambda x: -2 * PI**3 * np.sin(2 * PI * x[..., 1])
                 * (1 - 4 * np.sin(PI * x[..., 0]) ** 2)
                 - PI * np.sin(PI * x[..., 0]) * np.sin(PI * x[..., 1])),
           _host(lambda x: 2 * PI**3 * np.sin(2 * PI * x[..., 0])
                 * (1 - 4 * np.sin(PI * x[..., 1]) ** 2)
                 + PI * np.cos(PI * x[..., 0]) * np.cos(PI * x[..., 1])))


def _stokes(device):
    mesh = ft.unit_square_mesh(16, diagonal="left/right", dtype=torch.float64,
                               device=device)
    WP = stokes.TaylorHood(mesh)
    bcs = [ft.DirichletBC(WP.sub(0), U_EXACT), ft.DirichletBC(WP.sub(1), P_EXACT)]
    u, p = stokes.solve(WP, bcs, 1.0, F_EXACT, verbose=False, tol=3e-9, max_iter=3000)
    return u, p, dict(stokes.last_info)


def test_stokes_minres_card_matches_cpu(card, monkeypatch):
    monkeypatch.setattr(stokes, "DENSE_THRESHOLD", 0)
    seen = {}
    orig = stokes.power_iteration_lmax

    def lmax(*a, **k):
        seen.setdefault("lmax", orig(*a, **k))
        return seen["lmax"]

    monkeypatch.setattr(stokes, "power_iteration_lmax", lmax)
    uc, pc, ic = _stokes("cpu")
    ug, pg, ig = _stokes("cuda")
    assert ig["solver"] == "minres" and ig["iters"] == ic["iters"] > 20
    for a, b, tol in ((ug.vector.cpu(), uc.vector, 1e-9), (pg.vector.cpu(), pc.vector, 1e-7)):
        assert float((a - b).abs().max()) <= tol * float(b.abs().max())
    assert ft.errornorm(U_EXACT, ug) < 1e-2
    ug2, _, ig2 = _stokes("cuda")
    assert ig2["iters"] == ig["iters"] and torch.equal(ug2.vector, ug.vector)


def _run(device, backend, **kw):
    tel = []
    u, _, th = compute_boussinesq_3d(backend=backend, device=device, telemetry=tel, **kw)
    return (u.vector.cpu(), th.vector.cpu(),
            [tuple(r.get(k) for k in ("step", "sweep", "failed") + KEYS) for r in tel])


@pytest.mark.parametrize("backend, kw", [
    (None, dict(target_time=0.02, n=(4, 4, 8))),
    ("packed", dict(target_time=0.02, n=(4, 4, 8))),
    ("packed", dict(target_time=0.62, n=(2, 2, 4))),
], ids=["rotational", "packed", "packed-moving"])
def test_driver_card_matches_cpu(card, backend, kw):
    uc, thc, cc = _run("cpu", backend, **kw)
    stencil.STENCIL_3D.launches = 0
    ug, thg, cg = _run("cuda", backend, **kw)
    assert cg == cc
    assert (stencil.STENCIL_3D.launches > 0) == (backend == "packed")
    # at rest u stays 0 on both: the floor keeps the bound absolute there
    scale = max(float(uc.abs().max()), 1e-8)
    assert float((ug - uc).abs().max()) <= 1e-8 * scale
    assert float((thg - thc).abs().max()) <= 1e-10 * float(thc.abs().max())


@pytest.mark.parametrize("shape", [(17, 17, 33), (9, 9, 17), (15, 15, 29), (8, 8, 15),
                                   (13, 13, 25), (7, 7, 13), (5, 5, 9), (3, 3, 5)])
def test_k1_at_the_packed_route_grids(card, shape):
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal(shape), device="cuda")
    k = torch.as_tensor(rng.standard_normal((3, 3, 3)), device="cuda")
    y, ref = stencil.stencil_apply_3d(x, k), stencil.stencil_apply_3d_plain(x, k)
    assert float((y - ref).abs().max()) <= 1e-13 * float(ref.abs().max())
