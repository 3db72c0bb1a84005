"""Device mesh and sharding layer of the port -- the port of
``triton_kubernetes_tpu/parallel``.

A named six-axis :class:`.mesh.Mesh` over the ranks of a
``torch.distributed`` process group (one process a device), the
logical-axis -> mesh-axis rules and each rank's block of a leaf
(``sharding.py``), and the collectives the sharded step inserts where the
reference lets XLA insert them (``collectives.py``, the port's own).

Multi-process scale-out lives in :mod:`.multihost` (imported lazily by
callers): the hybrid mesh, per-process batch rows, the fused gradient
exchange, coordinated checkpoints and the local multi-process launcher.
"""

from .mesh import (
    AXIS_DATA,
    AXIS_EXPERT,
    AXIS_FSDP,
    AXIS_SEQ,
    AXIS_STAGE,
    AXIS_TENSOR,
    MESH_AXES,
    MeshConfig,
    create_mesh,
)
from .sharding import (
    DEFAULT_RULES,
    logical_sharding,
    logical_to_spec,
    shard_pytree,
)

__all__ = [
    "AXIS_DATA",
    "AXIS_EXPERT",
    "AXIS_FSDP",
    "AXIS_SEQ",
    "AXIS_STAGE",
    "AXIS_TENSOR",
    "MESH_AXES",
    "MeshConfig",
    "create_mesh",
    "DEFAULT_RULES",
    "logical_to_spec",
    "logical_sharding",
    "shard_pytree",
]
