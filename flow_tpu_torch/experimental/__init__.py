from . import ab2tr  # noqa: F401
