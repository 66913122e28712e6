"""Event-level simulator validating ParallelSchedule timing and service, a
copy of ``repro.fabric.simulator``.

Replays each switch's schedule as (reconfigure δ → serve α at line rate)
events and checks that (a) every demand entry is fully served by the
schedule's claimed makespan, and (b) at no instant does any switch serve
more than one circuit per input/output port (guaranteed by permutations but
re-checked independently here).

The (δ → α) event construction itself lives in ``fabric.timeline``, the
one source of truth for circuit timing.

Online replay: ``installed`` carries the configurations left on the
switches by the previous controller period. A switch whose *first*
configuration equals its installed permutation serves it without paying δ —
the circuit is already up — which is exactly the online controller's reuse
credit. The finish-time check then validates against the credit-aware
makespan instead of the schedule's nominal one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from ..core.schedule import ParallelSchedule
from .timeline import build_timeline


@dataclass
class SimReport:
    """Matrix-granularity replay verdict.

    ``reused_switches`` is always a well-defined per-switch bool array of
    shape ``(s,)``: which switches served their first configuration δ-free
    against a carried ``installed`` state. A stateless replay (no
    ``installed``) has nothing to reuse, so the contract is **all-False**
    — never ``None`` — letting consumers sum or index it unconditionally.
    """

    finish_time: float
    served: np.ndarray
    demand_met: bool
    max_shortfall: float
    reused_switches: np.ndarray = None  # (s,) bool; zeros for stateless replay


def simulate(
    sched,
    D: np.ndarray,
    tol: float = 1e-9,
    *,
    installed: Sequence[np.ndarray | None] | None = None,
    expected_makespan: float | None = None,
) -> SimReport:
    """Accepts a ParallelSchedule, or anything carrying one under
    ``.schedule`` (``SolveReport``, ``SpectraResult``).

    ``installed`` enables online replay (see module doc): one permutation —
    or None — per switch. ``expected_makespan`` overrides the finish-time
    assertion target (the online controller's credit-aware makespan);
    without it the target is the schedule's nominal makespan minus the
    replay's observed reuse credit.
    """
    sched = getattr(sched, "schedule", sched)
    if not isinstance(sched, ParallelSchedule):
        raise TypeError(f"cannot simulate {type(sched).__name__}")
    D = np.asarray(D, dtype=np.float64)
    n = D.shape[0]
    rows = np.arange(n)
    tl = build_timeline(sched, installed=installed, tol=tol)
    served = np.zeros_like(D)
    for w in tl.windows:
        if len(w.perm) != n:
            raise AssertionError("configuration is not a permutation")
        served[rows, w.perm] += w.alpha
    finish = tl.finish
    shortfall = float((D - served).max())
    if expected_makespan is None:
        expected_makespan = sched.makespan()
        if installed is not None:
            loads = sched.loads() - sched.delta * tl.reused_switches
            expected_makespan = float(loads.max()) if len(loads) else 0.0
    if abs(finish - expected_makespan) > 1e-6 * max(1.0, finish):
        raise AssertionError(
            f"simulated finish {finish} != claimed makespan {expected_makespan}"
        )
    return SimReport(
        finish_time=finish,
        served=served,
        demand_met=shortfall <= tol,
        max_shortfall=max(shortfall, 0.0),
        reused_switches=tl.reused_switches,
    )
