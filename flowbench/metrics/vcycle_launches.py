"""Kernel-launch API calls a pressure V-cycle: the launch calls that start
inside the program's flow.vcycle spans over the number of those spans."""
from flowbench import spans


def read(ctx):
    return spans.launches_per_span(ctx, "flow.vcycle")
