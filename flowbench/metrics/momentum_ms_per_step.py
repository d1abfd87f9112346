"""Milliseconds a profiled step inside the momentum substep: the union of
the program's flow.momentum spans (right-hand side, operator build,
diagonal and Krylov solve) over the profiled steps."""
from flowbench import spans


def read(ctx):
    return spans.span_ms_per_step(ctx, "flow.momentum")
