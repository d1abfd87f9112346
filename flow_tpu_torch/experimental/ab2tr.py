# The adaptive AB2/trapezoid integrator (flow_tpu/experimental/ab2tr.py):
# not ported yet (ROADMAP queue 1 item 4: experimental/ab2tr.py).
from __future__ import annotations

__all__ = ["AB2TR"]


class AB2TR:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "flow_tpu_torch.experimental.ab2tr is not ported yet (ROADMAP "
            "queue 1 item 4: experimental/ab2tr.py)"
        )
