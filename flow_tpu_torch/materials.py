# Material properties. Port of flow_tpu/materials.py: the density,
# viscosity, heat capacity and conductivity of liquid water and dry air
# from standard correlations, host numpy. Temperatures in Kelvin, SI units
# throughout.
from __future__ import annotations

import numpy as np

__all__ = ["water", "air"]


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

    @staticmethod
    def dynamic_viscosity(T):
        """Pa s - Vogel equation. dynamic_viscosity(293.15) ~ 1.00e-3."""
        return 1.0e-3 * np.exp(-3.7188 + 578.919 / (-137.546 + np.asarray(T)))

    @staticmethod
    def specific_heat_capacity(T):
        """J/(kg K) - weak T-dependence around 4187."""
        t = np.asarray(T) - 273.15
        return (4217.4 - 3.720283 * t + 0.1412855 * t**2 - 2.654387e-3 * t**3
                + 2.093236e-5 * t**4)

    @staticmethod
    def thermal_conductivity(T):
        """W/(m K) - Ramires et al. (1995). thermal_conductivity(293.15) ~ 0.598."""
        tr = np.asarray(T) / 298.15
        return 0.6065 * (-1.48445 + 4.12292 * tr - 1.63866 * tr**2)


water = _Water()



class _Air:
    """Dry air at atmospheric pressure, 250 K .. 400 K."""

    @staticmethod
    def density(T):
        """kg/m^3 - ideal gas at 101325 Pa."""
        return 101325.0 / (287.058 * np.asarray(T))

    @staticmethod
    def dynamic_viscosity(T):
        """Pa s - Sutherland's law."""
        T = np.asarray(T)
        return 1.716e-5 * (T / 273.15) ** 1.5 * (273.15 + 110.4) / (T + 110.4)

    @staticmethod
    def specific_heat_capacity(T):
        return 1006.0 + 0.0 * np.asarray(T)

    @staticmethod
    def thermal_conductivity(T):
        """W/(m K) - Sutherland-type correlation."""
        T = np.asarray(T)
        return 2.624e-2 * (T / 300.0) ** 1.5 * (300.0 + 245.4) / (T + 245.4)


air = _Air()
