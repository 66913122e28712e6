"""Demand matrices for the port: the paper workloads and the permutations family."""

from .workloads import (
    WORKLOADS,
    benchmark_workload,
    gpt3b_workload,
    moe_workload,
    permutations_workload,
)

__all__ = [
    "WORKLOADS", "benchmark_workload", "gpt3b_workload", "moe_workload",
    "permutations_workload",
]
