"""Milliseconds a step in the pressure substep (the stepper's
_pressure_solve, synchronised at both ends) over the traced window."""


def read(ctx):
    s = ctx["substep_seconds"].get("_pressure_solve")
    return None if s is None else 1e3 * s / ctx["steps"]
