"""SPECTRA core of the PyTorch port: the host algorithms (DECOMPOSE /
SCHEDULE / EQUALIZE, the bound, the §V comparison algorithms) and, under
``torchopt``, their batched device counterparts.

Preferred entry point — the unified solver API (re-exported here)::

    from repro_torch.core import Problem, solve
    report = solve(Problem(D, s, delta), solver="spectra")

Stage-level names:
    spectra, spectra_pp        — full pipelines (paper-faithful / improved)
    decompose, Decomposition   — Alg. 1 + REFINE (Alg. 2)
    schedule_lpt, equalize     — Alg. 3, Alg. 4
    lower_bound                — §IV Theorems 1-2 + Property 2
    baseline_less, eclipse_decompose — §V comparison algorithms
"""

from .baselines import baseline_less, eclipse_decompose, less_split
from .decompose import Decomposition, decompose, degree, refine_greedy, refine_lp, refine_signed
from .equalize import equalize
from .improved import local_search, schedule_wrap, spectra_pp
from .lower_bounds import lb_theorem1, lb_theorem2, lower_bound
from .matching import hungarian_min_cost, max_weight_perfect_matching, mwm_node_coverage, perm_matrix
from .schedule import ParallelSchedule, SwitchSchedule, schedule_lpt
from .schedule_ir import (
    DeviceSchedule,
    LazySchedule,
    ir_coverage,
    ir_loads,
    ir_makespan,
    ir_num_configs,
    ir_to_schedule,
    schedule_to_ir,
)
from .spectra import SpectraResult, spectra

# Solver API re-exports, resolved lazily to avoid the import cycle (the
# API's stage tables import the implementations above).
_API_NAMES = (
    "Pipeline", "Problem", "SolveOptions", "SolveReport", "get_solver",
    "list_solvers", "register_solver", "register_stage", "solve",
    "solve_all", "solve_many",
)

__all__ = [
    "Decomposition", "DeviceSchedule", "LazySchedule", "ParallelSchedule",
    "SpectraResult", "SwitchSchedule",
    "baseline_less", "decompose", "degree", "eclipse_decompose", "equalize",
    "hungarian_min_cost", "ir_coverage", "ir_loads", "ir_makespan",
    "ir_num_configs", "ir_to_schedule", "lb_theorem1", "lb_theorem2",
    "less_split", "local_search", "lower_bound",
    "max_weight_perfect_matching", "mwm_node_coverage", "perm_matrix",
    "refine_greedy", "refine_lp", "refine_signed", "schedule_lpt",
    "schedule_to_ir", "schedule_wrap", "spectra", "spectra_pp",
    *_API_NAMES,
]


def __getattr__(name: str):
    if name in _API_NAMES:
        from .. import api

        return getattr(api, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
