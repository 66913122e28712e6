"""Solver API of the PyTorch port: one input shape, one output shape.

    from repro_torch.api import Problem, solve, solve_many

    reports = solve_many(Ds, s=4, delta=0.01, solver="spectra_torch")
    report = solve(Problem(D, s=4, delta=0.01), solver="spectra")  # host numpy

The device solver (``spectra_torch``) runs on CUDA unless
``SolveOptions(extra={"device": "cpu"})`` asks for the plain PyTorch path;
without a GPU it raises. ``spectra`` and ``spectra_no_eq`` run on the host.
"""

from .batch import solve_many
from .pipeline import Pipeline
from .problem import Problem, SolveOptions, SolveReport
from .registry import get_solver, list_solvers, register_solver, solve
from .torch_backend import PendingBatch, dispatch_many_torch

__all__ = [
    "PendingBatch", "Pipeline", "Problem", "SolveOptions", "SolveReport",
    "dispatch_many_torch", "get_solver", "list_solvers", "register_solver",
    "solve", "solve_many",
]
