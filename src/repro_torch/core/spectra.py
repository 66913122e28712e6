"""Host SPECTRA end to end: DECOMPOSE → SCHEDULE → EQUALIZE (§III).

A copy of ``repro.core.spectra``. ``spectra(D, s, delta)`` is the
paper-faithful algorithm; ``decompose_fn`` swaps the decomposition step.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

import numpy as np

from .decompose import Decomposition, decompose
from .equalize import equalize
from .lower_bounds import lower_bound, optimality_gap
from .schedule import ParallelSchedule, schedule_lpt


@dataclass
class SpectraResult:
    schedule: ParallelSchedule
    decomposition: Decomposition
    makespan: float
    lower_bound: float
    runtime_s: float

    @property
    def optimality_gap(self) -> float:
        return optimality_gap(self.makespan, self.lower_bound)


def spectra(
    D: np.ndarray,
    s: int,
    delta: float,
    *,
    do_equalize: bool = True,
    merge_aware: bool = False,
    decompose_fn: Callable[..., Decomposition] | None = None,
    validate: bool = True,
    compute_lb: bool = True,
) -> SpectraResult:
    """Run the full SPECTRA pipeline on demand matrix D over s switches."""
    D = np.asarray(D, dtype=np.float64)
    t0 = time.perf_counter()
    dec = decompose(D) if decompose_fn is None else decompose_fn(D)
    sched = schedule_lpt(dec, s, delta)
    if do_equalize:
        sched = equalize(sched, merge_aware=merge_aware)
    dt = time.perf_counter() - t0
    if validate:
        sched.validate(D)
    lb = lower_bound(D, s, delta) if compute_lb else float("nan")
    return SpectraResult(schedule=sched, decomposition=dec, makespan=sched.makespan(), lower_bound=lb,
                         runtime_s=dt)
