"""The distributed layer: the JAX package's parallel/ on torch.distributed.

Each rank is a process with one device (cuda:<local rank>, or the CPU with
gloo for tests); the steppers take `group=` (a process group, default the
world) and `device=`. comm.launch starts the ranks of a job."""
from .domain import ShardedProjection, partition_cells  # noqa: F401
from .halo import HaloPoisson  # noqa: F401
from .halo_step import HaloSpace, HaloProjection  # noqa: F401
from .packed_shard import ShardedPackedStepper  # noqa: F401
