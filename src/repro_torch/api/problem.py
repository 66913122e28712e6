"""Problem / SolveOptions / SolveReport — one input and one output shape.

A copy of ``repro.api.problem`` for the port: every registered solver maps
a ``(Problem, SolveOptions)`` pair to a ``SolveReport``. The batched torch
backend validates at a 1e-4 tolerance (float32 on the device), the host at
1e-9.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Mapping

import numpy as np

from ..core.decompose import Decomposition
from ..core.lower_bounds import lower_bound as _host_lower_bound
from ..core.lower_bounds import optimality_gap
from ..core.schedule import ParallelSchedule


@dataclass(frozen=True)
class Problem:
    """One parallel-OCS scheduling instance: demand D over s switches, delay δ."""

    D: np.ndarray  # (n, n) nonnegative demand matrix
    s: int         # number of parallel switches
    delta: float   # reconfiguration delay, in demand-time units

    def __post_init__(self) -> None:
        D = np.asarray(self.D)
        if D.ndim != 2 or D.shape[0] != D.shape[1]:
            raise ValueError(f"D must be a square matrix, got shape {D.shape}")
        if self.s < 1:
            raise ValueError(f"need at least one switch, got s={self.s}")
        if self.delta < 0:
            raise ValueError(f"delta must be nonnegative, got {self.delta}")
        object.__setattr__(self, "D", D)

    @property
    def n(self) -> int:
        return int(self.D.shape[0])


@dataclass(frozen=True)
class SolveOptions:
    """Cross-solver knobs. Solver-specific extras go in ``extra``
    (for ``spectra_torch``: ``device``, ``equalize``, ``merge_aware``,
    ``extra_slots``, ``matcher``, ``repair_rounds``)."""

    validate: bool = True              # check Eq. 3 coverage on the result
    validate_tol: float | None = None  # None → backend default (1e-9 / 1e-4)
    compute_lb: bool = True            # attach the §IV lower bound
    extra: Mapping[str, Any] = field(default_factory=dict)

    def tol(self, backend: str) -> float:
        if self.validate_tol is not None:
            return self.validate_tol
        return 1e-4 if backend == "torch" else 1e-9


@dataclass
class SolveReport:
    """Uniform result of any registered solver."""

    solver: str
    backend: str                   # "torch" (device) or "numpy" (host)
    schedule: ParallelSchedule
    makespan: float
    lower_bound: float             # NaN when compute_lb=False
    num_configs: int
    runtime_s: float
    validated: bool                # True iff Eq. 3 coverage was checked
    decomposition: Decomposition | None = None
    extras: dict[str, Any] = field(default_factory=dict)

    @property
    def optimality_gap(self) -> float:
        """makespan / lower_bound; 1.0 for the degenerate 0/0 (empty demand)."""
        return optimality_gap(self.makespan, self.lower_bound)


def finish_report(
    *,
    solver: str,
    backend: str,
    schedule: ParallelSchedule,
    problem: Problem,
    options: SolveOptions,
    runtime_s: float,
    decomposition: Decomposition | None = None,
    extras: dict[str, Any] | None = None,
    makespan: float | None = None,
    num_configs: int | None = None,
    lower_bound: float | None = None,
) -> SolveReport:
    """Validate + lower-bound a finished schedule into a SolveReport.

    ``makespan``/``num_configs``/``lower_bound`` may come from the device;
    whenever validation runs the makespan is taken from the (materialized)
    schedule, so the report agrees exactly with what the validator saw.
    """
    validated = False
    if options.validate:
        schedule.validate(problem.D, tol=options.tol(backend))
        validated = True
    if makespan is None or validated:
        makespan = schedule.makespan()
    if num_configs is None:
        num_configs = schedule.num_configs()
    if not options.compute_lb:
        lb = float("nan")
    elif lower_bound is not None:
        lb = float(lower_bound)
    else:
        lb = _host_lower_bound(problem.D, problem.s, problem.delta)
    return SolveReport(
        solver=solver,
        backend=backend,
        schedule=schedule,
        makespan=makespan,
        lower_bound=lb,
        num_configs=num_configs,
        runtime_s=runtime_s,
        validated=validated,
        decomposition=decomposition,
        extras=extras or {},
    )
