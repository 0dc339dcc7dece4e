"""Logical-axis sharding on a ``DeviceMesh`` and GPipe (port of
``repro.distributed``)."""
from repro_torch.distributed.sharding import (
    AxisRules, DEFAULT_RULES, NamedSharding, activate, axes_to_spec,
    constrain, current_mesh, current_rules, param_shardings, spec_for,
)

__all__ = [
    "AxisRules", "DEFAULT_RULES", "NamedSharding", "activate",
    "axes_to_spec", "constrain", "current_mesh", "current_rules",
    "param_shardings", "spec_for",
]
