"""Composable host DECOMPOSE → SCHEDULE → EQUALIZE pipelines (declarative stages).

A copy of the host stages of ``repro.api.pipeline``: a ``Pipeline`` names
its three stages, each looked up in a registry::

    Pipeline()                   # paper-faithful SPECTRA
    Pipeline(equalize="none")    # SPECTRA w/o EQUALIZE

Stages here: decompose ``spectra``; schedule ``lpt``; equalize ``none``,
``standard`` and ``merge_aware``. The other stages of the reference
(``eclipse``, the local search, ``wrap`` and its device stages) and its
``register_stage`` are not ported yet (ROADMAP Queue 1).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping

from ..core.decompose import Decomposition, decompose
from ..core.equalize import equalize
from ..core.schedule import ParallelSchedule, schedule_lpt
from .problem import Problem, SolveOptions, SolveReport, finish_report

DecomposeFn = Callable[..., Decomposition]        # (problem, **kw) -> dec
ScheduleFn = Callable[..., ParallelSchedule]      # (dec, problem, **kw) -> sched
EqualizeFn = Callable[..., ParallelSchedule]      # (sched, problem, **kw) -> sched

DECOMPOSERS: dict[str, DecomposeFn] = {
    "spectra": lambda problem, **kw: decompose(problem.D, **kw),
}

SCHEDULERS: dict[str, ScheduleFn] = {
    "lpt": lambda dec, problem, **kw: schedule_lpt(dec, problem.s, problem.delta),
}

EQUALIZERS: dict[str, EqualizeFn] = {
    "none": lambda sched, problem, **kw: sched,
    "standard": lambda sched, problem, **kw: equalize(sched, **kw),
    "merge_aware": lambda sched, problem, **kw: equalize(sched, merge_aware=True, **kw),
}

_STAGE_TABLES = {"decompose": DECOMPOSERS, "schedule": SCHEDULERS, "equalize": EQUALIZERS}


def _lookup(kind: str, name: str) -> Callable:
    table = _STAGE_TABLES[kind]
    if name not in table:
        raise KeyError(f"unknown {kind} stage {name!r}; available: {sorted(table)}")
    return table[name]


@dataclass(frozen=True)
class Pipeline:
    """Declarative three-stage host solver; callable as ``pipeline(problem, options)``."""

    decompose: str = "spectra"
    schedule: str = "lpt"
    equalize: str = "standard"
    decompose_kwargs: Mapping[str, Any] = field(default_factory=dict)
    schedule_kwargs: Mapping[str, Any] = field(default_factory=dict)
    equalize_kwargs: Mapping[str, Any] = field(default_factory=dict)

    def describe(self) -> str:
        return f"{self.decompose} → {self.schedule} → {self.equalize}"

    @property
    def backend(self) -> str:
        """Every stage here runs on the host in float64 (the 1e-9 tolerance)."""
        return "numpy"

    def __call__(self, problem: Problem, options: SolveOptions = SolveOptions(), *,
                 solver_name: str | None = None) -> SolveReport:
        dec_fn = _lookup("decompose", self.decompose)
        sched_fn = _lookup("schedule", self.schedule)
        eq_fn = _lookup("equalize", self.equalize)
        t0 = time.perf_counter()
        dec = dec_fn(problem, **dict(self.decompose_kwargs))
        sched = sched_fn(dec, problem, **dict(self.schedule_kwargs))
        sched = eq_fn(sched, problem, **dict(self.equalize_kwargs))
        runtime = time.perf_counter() - t0
        return finish_report(
            solver=solver_name or self.describe(),
            backend=self.backend,
            schedule=sched,
            problem=problem,
            options=options,
            runtime_s=runtime,
            decomposition=dec,
            extras={"pipeline": self.describe()},
        )
