# Coordinate expressions with settable parameters. Port of
# flow_tpu/utils/expression.py: the counterpart of dolfin.Expression with
# user parameters (the reference sets `sol_u.t = dt` between steps),
# evaluated in PyTorch on the points it is given.
from __future__ import annotations

__all__ = ["Expression"]


class Expression:
    """Wraps fn(x, **params) -> values; the parameters are settable
    attributes.

        e = Expression(lambda x, t: torch.sin(x[..., 0] - t), t=0.0)
        e.t = 0.5
        vals = e(points)
    """

    def __init__(self, fn, **params):
        object.__setattr__(self, "_fn", fn)
        object.__setattr__(self, "_params", dict(params))

    def __setattr__(self, name, value):
        self._params[name] = value

    def __getattr__(self, name):
        try:
            return object.__getattribute__(self, "_params")[name]
        except KeyError:
            raise AttributeError(name)

    def __call__(self, x):
        return self._fn(x, **self._params)
