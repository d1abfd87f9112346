"""Blocking device-to-host reads a profiled step: the program's flow.sync.*
spans (the Krylov and Picard stopping tests, GMRES's Hessenberg columns)
over the profiled steps."""
from flowbench import spans


def read(ctx):
    return spans.syncs_per_step(ctx)
