"""Momentum Krylov iterations a step over the window (the run's
telemetry, linear_iters)."""


def read(ctx):
    return float(ctx["window_tel"]["linear_iters"].sum()) / ctx["steps"]
