"""Mesh axes and sharding rules of the port (counterpart of
``repro/distributed``)."""
from repro_torch.distributed.sharding import (DATA_AXES, PartitionSpec,
                                              ShardingContext,
                                              current_context,
                                              logical_rules, mesh_axis_size,
                                              param_spec_for_path,
                                              split_dims, use_sharding)

__all__ = ["DATA_AXES", "PartitionSpec", "ShardingContext",
           "current_context", "logical_rules", "mesh_axis_size",
           "param_spec_for_path", "split_dims", "use_sharding"]
