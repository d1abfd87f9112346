# Typed solver and scheme configuration. Port of flow_tpu/utils/config.py,
# cut to SolverConfig (the fields stokes.solve reads, with the JAX
# package's defaults) and SchemeConfig (the fields the projection step
# (_step) and the packed route (navier_stokes/packedapi.py) read).
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["SolverConfig", "SchemeConfig"]


@dataclass(frozen=True)
class SolverConfig:
    """Krylov solve configuration: the relative tolerance, the iteration
    cap and whether to log the solve, as stokes.solve reads them."""

    rtol: float = 1.0e-10
    maxiter: int = 1000
    monitor_convergence: bool = False


@dataclass(frozen=True)
class SchemeConfig:
    """Projection-scheme configuration: the tentative velocity's absolute
    Newton tolerance (on the residual 2-norm) and iteration cap, the
    fields the public schemes read. The JAX package's other fields select
    paths of its fast steppers."""

    newton_tol: float = 1.0e-10
    newton_maxiter: int = 10
