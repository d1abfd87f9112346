from . import assembly, bc, elements, interpolate, quadrature, spaces, transfer  # noqa: F401
from .bc import DirichletBC, combine_bcs  # noqa: F401
from .interpolate import errornorm, interpolate, norm, project  # noqa: F401,F811
from .spaces import Function, FunctionSpace, SubSpace, VectorFunctionSpace  # noqa: F401
from .transfer import prolong, prolong_vector  # noqa: F401
