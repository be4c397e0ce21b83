"""Distribution primitives: logical-axis sharding rules and their DTensor
placements (port of `repro.parallel`)."""
from .sharding import (
    AxisRules,
    abstract_mesh,
    axis_rules,
    constrain,
    current_rules,
    distribute,
    logical_to_spec,
    param_specs,
    placements,
)

__all__ = [
    "AxisRules",
    "abstract_mesh",
    "axis_rules",
    "constrain",
    "current_rules",
    "distribute",
    "logical_to_spec",
    "param_specs",
    "placements",
]
