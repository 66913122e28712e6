from .ops import demand_accum
from .ref import demand_accum_ref, in_range

__all__ = ["demand_accum", "demand_accum_ref", "in_range"]
