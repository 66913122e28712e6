"""Solver API of the PyTorch port: one input shape, one output shape.

    from repro_torch.api import Problem, solve, solve_many

    reports = solve_many(Ds, s=4, delta=0.01, solver="spectra_torch")
    report = solve(Problem(D, s=4, delta=0.01), solver="spectra")  # host numpy

The device solver (``spectra_torch``) and the device pipeline stages
(``torch_auction``, ``torch_refined``, ``torch``, ``torch_merge_aware``) run
on CUDA unless ``SolveOptions(extra={"device": "cpu"})`` asks for the plain
PyTorch path; without a GPU they raise. Every other registered solver runs
on the host. See ``registry`` for the names, ``pipeline`` for the stages
and ``batch`` for batched solving.
"""

from .batch import solve_many
from .pipeline import DECOMPOSERS, EQUALIZERS, SCHEDULERS, Pipeline, register_stage
from .problem import Problem, SolveOptions, SolveReport
from .registry import get_solver, list_solvers, register_solver, solve, solve_all
from .torch_backend import PendingBatch, dispatch_many_torch

__all__ = [
    "DECOMPOSERS", "EQUALIZERS", "SCHEDULERS",
    "PendingBatch", "Pipeline", "Problem", "SolveOptions", "SolveReport",
    "dispatch_many_torch", "get_solver", "list_solvers", "register_solver",
    "register_stage", "solve", "solve_all", "solve_many",
]
