"""Logical-axis sharding rules of the port (``rules``)."""
from repro_torch.sharding.rules import (ACT_RULES, PARAM_RULES,
                                        PARAM_RULES_NO_FSDP, Rules,
                                        mesh_axes, resolve_spec)

__all__ = ["ACT_RULES", "PARAM_RULES", "PARAM_RULES_NO_FSDP", "Rules",
           "mesh_axes", "resolve_spec"]
