# The recorded physics guard on the port: the DFG 2D-2 (Schaefer-Turek,
# Re=100) force series of tests/data/schafer_turek_*.npz, recorded by the
# JAX package's campaigns, through the port's force post-processing
# (flow_tpu_torch.models.karman.strouhal_number). Its Strouhal number equals
# the JAX package's to 1e-12 on all ten series, and each series holds the
# published corridors tests/test_shedding_validation.py holds it to (St,
# Cd_max, Cd_mean, the lift extremes, a saturated amplitude). Pure numpy.
import os

import numpy as np
import pytest

from flow_tpu.models import karman as jax_karman
from flow_tpu_torch.models import karman

DATA = os.path.join(os.path.dirname(__file__), "data")
DIAMETER = 0.1
U_REF = 1.0  # mean inflow velocity
FORCE_SCALE = 0.5 * 1.0 * U_REF**2 * DIAMETER

# the corridors of tests/test_shedding_validation.py, by series: St,
# Cd_max, Cd_mean, Cl_max, Cl_min (None: not held there)
_STAGE2 = dict(st=(0.295, 0.305), cd_max=(3.20, 3.27), cl_max=(0.95, 1.03),
               cl_min=(-1.03, -0.95))
_STAGE3 = dict(st=(0.297, 0.303), cd_max=(3.23, 3.26), cd_mean=(3.20, 3.23),
               cl_max=(0.97, 1.01), cl_min=(-1.04, -0.99))
CORRIDORS = {
    "stage1": dict(st=(0.27, 0.36), cd_max=(3.10, 3.35)),
    "stage2": dict(_STAGE2, cd_max=(3.20, 3.26)),
    "stage2_lagged": _STAGE2,
    "stage2_pcstop": _STAGE2,
    "stage2_gmres": _STAGE2,
    "stage2_packed": _STAGE2,
    "stage3": _STAGE3,
    "stage3_packed": _STAGE3,
    "stage3_dt1e3": dict(st=(0.297, 0.303), cd_max=(3.22, 3.24), cl_max=(0.96, 1.01),
                         cl_min=(-1.04, -0.99)),
    "stage3_dt5e4": dict(st=(0.297, 0.303), cd_max=(3.22, 3.24)),
}


def _inside(value, corridor, what):
    lo, hi = corridor
    assert lo <= value <= hi, (what, value, corridor)


@pytest.mark.parametrize("series", list(CORRIDORS))
def test_recorded_series_through_the_port(series):
    with np.load(os.path.join(DATA, f"schafer_turek_{series}.npz")) as d:
        t, fx, fy = d["t"], d["fx"], d["fy"]
    k0 = len(t) // 2  # the settled half
    st = karman.strouhal_number(t[k0:], fy[k0:], diameter=DIAMETER, u_ref=U_REF)
    st_jax = jax_karman.strouhal_number(t[k0:], fy[k0:], diameter=DIAMETER, u_ref=U_REF)
    assert st is not None and st_jax is not None
    assert abs(st - st_jax) <= 1e-12 * abs(st_jax), (st, st_jax)
    # the full series too, and the defaults (the reference geometry)
    for args, kw in (((t, fy), dict(diameter=DIAMETER, u_ref=U_REF)), ((t[k0:], fy[k0:]), {})):
        a, b = karman.strouhal_number(*args, **kw), jax_karman.strouhal_number(*args, **kw)
        assert (a is None) == (b is None) and (a is None or abs(a - b) <= 1e-12 * abs(b))
    cd = fx[k0:] / FORCE_SCALE
    cl = fy[k0:] / FORCE_SCALE
    c = CORRIDORS[series]
    _inside(st, c["st"], "St")
    _inside(cd.max(), c["cd_max"], "Cd_max")
    if "cd_mean" in c:
        _inside(cd.mean(), c["cd_mean"], "Cd_mean")
    if "cl_max" in c:
        _inside(cl.max(), c["cl_max"], "Cl_max")
        _inside(cl.min(), c["cl_min"], "Cl_min")
    if series == "stage1":
        # the wake oscillates, with a roughly antisymmetric lift
        assert cl.max() - cl.min() > 1.0
        assert abs(np.mean(cl)) < 0.5 * (cl.max() - cl.min())
    elif series == "stage3_dt5e4":
        # the dt ladder 3.2476 / 3.2380 / 3.2341 falls monotonically
        assert cd.max() < 3.2380 + 1e-9
    else:
        # saturated: the last quarter's amplitude is the settled half's
        q0 = 3 * len(t) // 4
        assert abs(fy[q0:].max() - fy[k0:].max()) < 0.02 * FORCE_SCALE
