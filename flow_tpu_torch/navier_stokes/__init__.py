# The pressure-correction schemes (the JAX package's navier_stokes
# exports), and the fused stepper of navier_stokes/fast.py.
from .pressure_correction import IPCS, Chorin, Rotational  # noqa: F401
from .fast import FastStepper  # noqa: F401
