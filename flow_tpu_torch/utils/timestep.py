# Adaptive time-step control. Port of flow_tpu/utils/timestep.py (host
# floats only).
from __future__ import annotations

__all__ = ["AdaptiveTimeController", "step_with_retry"]


class AdaptiveTimeController:
    """Smooth approach to a target dt with growth cap and ceiling:

        dt <- min(dt_max, dt * min(growth, 1 + alpha*(target - dt)/dt))

    `backoff(factor)` is the failure response (dt *= factor, retry the
    step)."""

    def __init__(self, dt0, dt_max=1.0, alpha=0.5, growth=2.0, dt_min=0.0):
        self.dt = float(dt0)
        self.dt_max = float(dt_max)
        self.alpha = float(alpha)
        self.growth = float(growth)
        self.dt_min = float(dt_min)

    def propose(self, target_dt):
        """Advance toward target_dt; returns the new dt."""
        dt = self.dt
        dt = min(
            self.dt_max,
            dt * min(self.growth, 1.0 + self.alpha * (target_dt - dt) / dt),
        )
        self.dt = max(dt, self.dt_min)
        return self.dt

    def backoff(self, factor=0.5):
        self.dt = max(self.dt * factor, self.dt_min)
        if self.dt_min and self.dt <= self.dt_min:
            raise RuntimeError(
                f"time step collapsed to dt_min={self.dt_min}"
            )
        return self.dt


def step_with_retry(step_fn, controller, backoff_factor=0.5, max_retries=8):
    """Run step_fn(dt) with dt-halving retries on RuntimeError (the solver
    nonconvergence signal). Returns (result, dt_used). step_fn must be pure
    with respect to retried state."""
    for _ in range(max_retries + 1):
        dt = controller.dt
        try:
            return step_fn(dt), dt
        except RuntimeError:
            controller.backoff(backoff_factor)
    raise RuntimeError(
        f"step failed after {max_retries} dt backoffs (dt={controller.dt})"
    )
