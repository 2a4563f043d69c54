"""Logical-axis sharding rules of the port (``rules``)."""
from repro_torch.sharding.rules import (ACT_RULES, PARAM_RULES,
                                        PARAM_RULES_NO_FSDP, Rules,
                                        current_mesh, mesh_axes,
                                        named_sharding, placements,
                                        resolve_spec, shard_constraint,
                                        use_mesh)

__all__ = ["ACT_RULES", "PARAM_RULES", "PARAM_RULES_NO_FSDP", "Rules",
           "current_mesh", "mesh_axes", "named_sharding", "placements",
           "resolve_spec", "shard_constraint", "use_mesh"]
