"""Milliseconds a profiled step inside the momentum substep (flow.momentum
spans) in which no operation ran on the device."""
from flowbench import spans


def read(ctx):
    return spans.idle_ms_per_step(ctx, "flow.momentum")
