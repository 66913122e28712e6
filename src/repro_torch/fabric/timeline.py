"""Circuit timeline: the one source of truth for schedule timing, a copy of
``repro.fabric.timeline``.

A ``ParallelSchedule`` says *what* each switch serves; this module says
*when*. ``build_timeline`` replays each switch's slot list as
(reconfigure δ → serve α) and emits one ``CircuitWindow`` per served
configuration — absolute ``[start, end)`` serve intervals with the δ
windows in between. ``repro_torch.fabric.simulator.simulate`` (the
matrix-granularity replay) and ``repro_torch.flowsim`` (the flow-level
replay) both read it, so they agree on when a circuit is up.

Online replay: ``installed`` carries the configuration left on each
switch by the previous controller period. A switch whose *first* slot
equals its installed permutation serves it without paying δ (the circuit
is already up) — the online controller's reuse credit.

Float discipline: per-switch time accumulates in slot order
(``t += δ; t += α``), as in the reference, so finish times are equal.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from ..core.schedule import ParallelSchedule

__all__ = ["CircuitWindow", "Timeline", "build_timeline"]


@dataclass(frozen=True)
class CircuitWindow:
    """One configuration's serve interval on one switch.

    ``alpha`` is the scheduled serve duration; ``end - start`` equals it
    up to float addition, but consumers accumulating served demand must
    use ``alpha`` (the schedule's own weight) so matrix replay stays
    bit-identical to summing the schedule directly.
    """

    switch: int        # OCS index h
    slot: int          # position in that switch's slot list
    perm: np.ndarray   # (n,) int destination port per source port
    alpha: float       # serve duration (demand-time units)
    start: float       # absolute serve start (after any δ)
    end: float         # start + alpha
    reused: bool       # first slot served δ-free via the installed config


@dataclass
class Timeline:
    """All serve windows of a schedule, switch-major in slot order."""

    windows: list[CircuitWindow]
    switch_finish: np.ndarray    # (s,) last serve end per switch
    reused_switches: np.ndarray  # (s,) bool — δ-free first slot
    delta: float
    s: int

    @property
    def finish(self) -> float:
        """Replay finish time: when the last switch goes quiet."""
        return float(self.switch_finish.max()) if self.s else 0.0

    def delta_time(self) -> np.ndarray:
        """Per-switch total reconfiguration time actually paid."""
        paid = np.zeros(self.s, dtype=np.float64)
        for w in self.windows:
            if not w.reused:
                paid[w.switch] += self.delta
        return paid


def build_timeline(
    sched,
    *,
    installed: Sequence[np.ndarray | None] | None = None,
    tol: float = 1e-9,
) -> Timeline:
    """Replay ``sched`` into absolute circuit serve windows.

    Accepts a ``ParallelSchedule`` or anything carrying one under
    ``.schedule`` (``SolveReport``, ``SpectraResult``). Raises
    ``AssertionError`` on negative durations or non-permutation
    configurations: the independent checks every timing consumer relies on.
    """
    sched = getattr(sched, "schedule", sched)
    if not isinstance(sched, ParallelSchedule):
        raise TypeError(f"cannot build a timeline for {type(sched).__name__}")
    if installed is not None and len(installed) != sched.s:
        raise ValueError(
            f"need one installed permutation (or None) per switch: "
            f"got {len(installed)} for s={sched.s}"
        )
    windows: list[CircuitWindow] = []
    switch_finish = np.zeros(sched.s, dtype=np.float64)
    reused = np.zeros(sched.s, dtype=bool)
    for h, sw in enumerate(sched.switches):
        t = 0.0
        carried = None if installed is None else installed[h]
        for j, (perm, a) in enumerate(zip(sw.perms, sw.alphas)):
            a = float(a)
            if a < -tol:
                raise AssertionError("negative duration in schedule")
            perm = np.asarray(perm, dtype=np.int64)
            # Independent port-conflict check: perm must be a permutation.
            if len(np.unique(perm)) != len(perm):
                raise AssertionError("configuration is not a permutation")
            slot_reused = (
                j == 0
                and carried is not None
                and np.array_equal(perm, np.asarray(carried, dtype=np.int64))
            )
            if slot_reused:
                reused[h] = True  # circuit already up: no reconfiguration
            else:
                t += sched.delta  # reconfiguration before each configuration
            start = t
            t += a
            windows.append(
                CircuitWindow(
                    switch=h, slot=j, perm=perm, alpha=a,
                    start=start, end=t, reused=slot_reused,
                )
            )
        switch_finish[h] = t
    return Timeline(
        windows=windows,
        switch_finish=switch_finish,
        reused_switches=reused,
        delta=sched.delta,
        s=sched.s,
    )
