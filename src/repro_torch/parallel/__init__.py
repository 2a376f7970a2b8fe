"""Distribution: logical-axis sharding rules, activation-constraint
context, and distributed-optimization collectives."""

from .collectives import int8_allreduce, int8_quantize
from .ctx import activation_rules, constrain
from .sharding import (default_rules, long_context_rules, spec_for,
                       tree_shardings)

__all__ = ["int8_allreduce", "int8_quantize", "activation_rules",
           "constrain", "default_rules", "long_context_rules", "spec_for",
           "tree_shardings"]
