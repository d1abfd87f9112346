"""Milliseconds a step in the velocity correction (the stepper's
_correction, synchronised at both ends) over the traced window."""


def read(ctx):
    s = ctx["substep_seconds"].get("_correction")
    return None if s is None else 1e3 * s / ctx["steps"]
