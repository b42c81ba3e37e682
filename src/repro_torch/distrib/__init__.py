"""Distribution on ``torch.distributed``: sharding rules over a named
device mesh, logical-axis bindings, and the int8 error-feedback mean."""

from .sharding import (AbstractMesh, MeshAxes, PartitionSpec, Rules, fingerprint,
                       mesh_axes, placements)
from .act import current_binding, default_rules, logical_axis_rules, shard
