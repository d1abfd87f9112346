from . import plotting, profiling  # noqa: F401
from .config import SchemeConfig, SolverConfig  # noqa: F401
from .expression import Expression  # noqa: F401
from .metrics import MetricsLogger  # noqa: F401
from .profiling import Timer, cost_report, device_memory_stats  # noqa: F401
from .timestep import AdaptiveTimeController, step_with_retry  # noqa: F401
