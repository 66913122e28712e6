"""String-addressable solver registry: ``solve(problem, solver="spectra_torch")``.

A solver is any callable ``(Problem, SolveOptions) -> SolveReport``. The
port registers ``spectra_torch`` (the fused device pipeline); add others
with ``register_solver``.
"""

from __future__ import annotations

from typing import Callable

from .problem import Problem, SolveOptions, SolveReport
from .torch_backend import solve_spectra_torch

SolverFn = Callable[[Problem, SolveOptions], SolveReport]

_SOLVERS: dict[str, SolverFn] = {}


def register_solver(name: str, fn: SolverFn | None = None, *, overwrite: bool = False):
    """Register a solver under ``name``; usable as a decorator."""

    def _register(f: SolverFn) -> SolverFn:
        if name in _SOLVERS and not overwrite:
            raise ValueError(f"solver {name!r} already registered")
        _SOLVERS[name] = f
        return f

    return _register if fn is None else _register(fn)


def get_solver(name: str) -> SolverFn:
    if name not in _SOLVERS:
        raise KeyError(f"unknown solver {name!r}; available: {list_solvers()}")
    return _SOLVERS[name]


def list_solvers() -> list[str]:
    return sorted(_SOLVERS)


def solve(
    problem: Problem,
    *,
    solver: str = "spectra_torch",
    options: SolveOptions | None = None,
) -> SolveReport:
    """Run one registered solver on one problem."""
    report = get_solver(solver)(problem, options or SolveOptions())
    report.solver = solver
    return report


register_solver("spectra_torch", solve_spectra_torch)
