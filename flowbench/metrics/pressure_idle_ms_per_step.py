"""Milliseconds a profiled step inside the pressure substep (flow.pressure
spans) in which no operation ran on the device."""
from flowbench import spans


def read(ctx):
    return spans.idle_ms_per_step(ctx, "flow.pressure")
