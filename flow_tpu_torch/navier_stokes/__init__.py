# The pressure-correction schemes (the JAX package's navier_stokes
# exports), the fused stepper of navier_stokes/fast.py and its
# reverse-mode differentiable counterpart (navier_stokes/diffstep.py).
from .pressure_correction import IPCS, Chorin, Rotational  # noqa: F401
from .fast import FastStepper  # noqa: F401
from .diffstep import DiffStepper  # noqa: F401
