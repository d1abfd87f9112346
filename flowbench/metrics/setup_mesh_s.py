"""Seconds to build the problem's meshes (generation, refinements,
snapping): the problem's setup_seconds["mesh"], host clock between device
syncs. None for a problem that does not time it."""


def read(ctx):
    return getattr(ctx["sut"]["problem"], "setup_seconds", {}).get("mesh")
