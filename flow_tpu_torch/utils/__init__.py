from .config import SchemeConfig, SolverConfig  # noqa: F401
