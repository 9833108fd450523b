# Sharding layer: logical-axis -> mesh-axis rules (FSDP + TP) onto a
# DeviceMesh and DTensor placements, shared by train and serve step
# assembly.
from .sharding import (NamedSharding, PartitionSpec, ShardingRules,
                       batch_spec, distribute, kv_cache_sharding, make_rules,
                       mesh_axis_size, params_sharding, placements)

__all__ = ["ShardingRules", "make_rules", "params_sharding", "batch_spec",
           "kv_cache_sharding", "mesh_axis_size", "PartitionSpec",
           "NamedSharding", "placements", "distribute"]
