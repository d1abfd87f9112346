# Steady Stokes (flow_tpu/stokes.py): not ported yet. ROADMAP queue 1 item
# 3 (stokes.py with krylov.minres and chebyshev_preconditioner, and the
# Stokes bootstrap run_karman_fast(from_rest=False)) is the next slice.
from __future__ import annotations

__all__ = ["TaylorHood", "solve"]

_WHERE = ("flow_tpu_torch.stokes is not ported yet (ROADMAP queue 1 item 3: "
          "stokes.py with MINRES and chebyshev_preconditioner)")


class TaylorHood:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_WHERE)


def solve(*args, **kwargs):
    raise NotImplementedError(_WHERE)
