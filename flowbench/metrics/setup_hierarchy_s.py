"""Seconds to build the stepper's pressure multigrid hierarchy (its levels
and their lambda_max): the stepper's setup_seconds["hierarchy"]. None for a
stepper that does not time it."""


def read(ctx):
    return getattr(ctx["stepper"], "setup_seconds", {}).get("hierarchy")
