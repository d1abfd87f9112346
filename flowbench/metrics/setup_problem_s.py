"""Seconds to build the problem (meshes, spaces, boundary conditions),
host clock between device syncs."""


def read(ctx):
    return ctx["sut"]["setup"]["problem"]
