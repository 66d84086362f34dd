"""Logical-axis sharding rules of the port (see rules.py)."""
from repro_torch.sharding.rules import (
    DEFAULT_RULES,
    ShardingRules,
    constrain,
    logical_to_pspec,
    make_rules,
    pspec_tree,
)

__all__ = ["ShardingRules", "DEFAULT_RULES", "logical_to_pspec",
           "make_rules", "pspec_tree", "constrain"]
