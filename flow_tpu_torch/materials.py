# Material properties. Port of flow_tpu/materials.py, cut to what the
# Karman model reads: the density of liquid water (Kell 1975), host numpy.
from __future__ import annotations

import numpy as np

__all__ = ["water"]


class _Water:
    """Liquid water, 273.15 K .. 373.15 K."""

    @staticmethod
    def density(T):
        """kg/m^3 - Kell (1975) correlation. density(293.15) ~ 998.2."""
        t = np.asarray(T) - 273.15
        num = (
            999.83952
            + 16.945176 * t
            - 7.9870401e-3 * t**2
            - 46.170461e-6 * t**3
            + 105.56302e-9 * t**4
            - 280.54253e-12 * t**5
        )
        return num / (1.0 + 16.879850e-3 * t)


water = _Water()
