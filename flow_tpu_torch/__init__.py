"""flow_tpu_torch: the PyTorch/CUDA port of flow_tpu.

The module tree mirrors ``flow_tpu`` so each port module sits at the same
relative path as its JAX counterpart. The port imports neither ``jax`` nor
``flow_tpu``. Setup (meshes, dof maps, reference tensors) runs in numpy on the
host; the finished tables move to the device once.

The public surface is the JAX package's: meshes (2-D and tets), spaces,
Dirichlet conditions, projection and norms, the Chorin/IPCS/Rotational
schemes, steady Stokes, the heat operator with SUPG, the parabolic steppers,
the materials, mesh and field I/O (``io``: checkpoints, XDMF, gmsh .msh,
DOLFIN XML) and the utilities. Meshes (and so everything built on them) live
on the card unless given ``device="cpu"``.

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
from .io import read_msh  # noqa: E402,F401
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
from . import io  # noqa: E402,F401
from . import utils  # noqa: E402,F401
from . import native  # noqa: E402,F401
from . import mesh3d  # noqa: E402,F401
from .mesh3d import TetMesh, box_mesh, refine_uniform_tet  # noqa: E402,F401
from . import experimental  # noqa: E402,F401

__version__ = "0.1.0"

__all__ = [
    "message", "mesh", "Mesh", "rectangle_mesh", "rectangle_with_hole_mesh",
    "refine_uniform", "reorder_rcm", "unit_square_mesh", "read_msh", "formlang",
    "Function", "FunctionSpace", "VectorFunctionSpace", "DirichletBC",
    "errornorm", "interpolate", "norm", "project", "navier_stokes", "heat",
    "stabilization", "materials", "parabolic", "stokes", "io", "utils",
    "native", "mesh3d", "TetMesh", "box_mesh", "refine_uniform_tet",
    "experimental",
]
