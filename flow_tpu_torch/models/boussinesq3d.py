# The 3-D Boussinesq driver (flow_tpu/models/boussinesq3d.py): not ported
# yet (ROADMAP queue 1 item 4: models/boussinesq3d.py, after stokes.py).
from __future__ import annotations

__all__ = ["compute_boussinesq_3d"]


def compute_boussinesq_3d(*args, **kwargs):
    raise NotImplementedError(
        "flow_tpu_torch.models.boussinesq3d is not ported yet (ROADMAP queue "
        "1 item 4: models/boussinesq3d.py)"
    )
