"""Demand matrices for the port: the paper workloads, the permutations
family, the collective traffic model and the dry run's cell demand."""

from .collectives import (
    Placement,
    TrafficModel,
    add_noise,
    normalize_max_line,
    sinkhorn,
)
from .hlo_traffic import demand_from_collectives, schedule_cell_demand
from .workloads import (
    WORKLOADS,
    benchmark_workload,
    gpt3b_workload,
    moe_workload,
    permutations_workload,
)

__all__ = [
    "Placement",
    "TrafficModel",
    "WORKLOADS",
    "add_noise",
    "benchmark_workload",
    "demand_from_collectives",
    "gpt3b_workload",
    "moe_workload",
    "normalize_max_line",
    "permutations_workload",
    "schedule_cell_demand",
    "sinkhorn",
]
