"""flow_tpu_torch: the PyTorch/CUDA port of flow_tpu.

The module tree mirrors ``flow_tpu`` so each port module sits at the same
relative path as its JAX counterpart. The port imports neither ``jax`` nor
``flow_tpu``. Setup (meshes, dof maps, reference tensors) runs in numpy on the
host; the finished tables move to the device once.

The public surface is the JAX package's for what is ported: meshes, spaces,
Dirichlet conditions, projection and norms, the Chorin/IPCS/Rotational
schemes, the heat operator with SUPG, the parabolic steppers and the
materials. Meshes (and so everything built on them) live on the card unless
given ``device="cpu"``.

TF32 is switched off here for the whole process: cuDNN would otherwise run the
float32 multigrid transfer convolutions with about three decimal digits, the
same trap as the TPU's default bf16 convolution passes.
"""
import torch

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

from . import message  # noqa: E402,F401
from . import mesh  # noqa: E402,F401
from .mesh import (  # noqa: E402,F401
    Mesh,
    rectangle_mesh,
    rectangle_with_hole_mesh,
    refine_uniform,
    reorder_rcm,
    unit_square_mesh,
)
from .fem import formlang  # noqa: E402,F401
from .fem.spaces import Function, FunctionSpace, VectorFunctionSpace  # noqa: E402,F401
from .fem.bc import DirichletBC  # noqa: E402,F401
from .fem.interpolate import errornorm, interpolate, norm, project  # noqa: E402,F401
from . import navier_stokes  # noqa: E402,F401
from . import heat  # noqa: E402,F401
from . import stabilization  # noqa: E402,F401
from . import materials  # noqa: E402,F401
from . import parabolic  # noqa: E402,F401
from . import stokes  # noqa: E402,F401

__all__ = [
    "message", "mesh", "Mesh", "rectangle_mesh", "rectangle_with_hole_mesh",
    "refine_uniform", "reorder_rcm", "unit_square_mesh", "formlang",
    "Function", "FunctionSpace", "VectorFunctionSpace", "DirichletBC",
    "errornorm", "interpolate", "norm", "project", "navier_stokes", "heat",
    "stabilization", "materials", "parabolic", "stokes",
]
