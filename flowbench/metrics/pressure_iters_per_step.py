"""Pressure CG iterations a step over the window (the run's telemetry,
pressure_iters)."""


def read(ctx):
    return float(ctx["window_tel"]["pressure_iters"].sum()) / ctx["steps"]
