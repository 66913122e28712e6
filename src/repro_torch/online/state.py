"""Cross-period switch state and reuse-credit accounting (host side), a copy
of ``repro.online.state`` in the reference's float64 order.

``SwitchState`` is what the online controller carries between controller
periods: the permutation each OCS left *installed* at the end of the
previous period, plus the previous period's decomposition (the warm-start
seed). A period's schedule whose first configuration on a switch equals
that switch's installed permutation serves it with **zero** reconfiguration
delay — the circuit is already up — which is the reuse credit the whole
online subsystem monetizes.

Serve order convention (shared with the device path in
``repro_torch.core.torchopt.online_torch``): each switch serves its carried
configuration first (δ-free), then the remaining configurations in slot
order, EQUALIZE splits last. ``effective_loads``/``effective_makespan``
price exactly that order; ``repro_torch.fabric.simulator.simulate(...,
installed=...)`` replays and verifies it event by event.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.equalize import perm_key
from ..core.schedule import ParallelSchedule, SwitchSchedule
from ..core.schedule_ir import DeviceSchedule

__all__ = [
    "SwitchState", "advance_installed", "apply_reuse_order",
    "effective_loads", "effective_makespan", "online_ir_to_schedule",
    "perm_key", "reuse_marks",
]


@dataclass
class SwitchState:
    """Per-OCS installed configuration carried between controller periods."""

    installed: list[np.ndarray | None]  # per switch; None = never configured
    prev_perms: list[np.ndarray] = field(default_factory=list)
    prices: np.ndarray | None = None    # device matcher dual-price carry
    # Σα / max-line-sum of the last FRESH decomposition — the scale-free
    # quality reference gating warm-start acceptance (see controller).
    fresh_ratio: float | None = None
    # makespan / §IV-lower-bound of the last FRESH (or donated-baseline)
    # period — the outcome-level warm gate reference (see controller).
    fresh_gap: float | None = None
    # Support-pattern → (permutation set, fresh ratio): the matching cache.
    # Carried on the state so it survives the per-call controllers of the
    # spectra_online registry solver (sessions thread the whole state).
    support_cache: dict = field(default_factory=dict)

    @classmethod
    def initial(cls, s: int) -> "SwitchState":
        if s < 1:
            raise ValueError(f"need at least one switch, got s={s}")
        return cls(installed=[None] * s)

    @property
    def s(self) -> int:
        return len(self.installed)

    def installed_keys(self) -> list[bytes | None]:
        return [
            perm_key(p) if p is not None else None for p in self.installed
        ]


def reuse_marks(
    sched: ParallelSchedule, state: SwitchState
) -> np.ndarray:
    """Per-switch flags: switch h holds a configuration equal to its
    installed permutation (the first such, served δ-free)."""
    keys = state.installed_keys()
    marks = np.zeros(sched.s, dtype=bool)
    for h, sw in enumerate(sched.switches):
        if keys[h] is None:
            continue
        marks[h] = any(perm_key(p) == keys[h] for p in sw.perms)
    return marks


def effective_loads(
    sched: ParallelSchedule, marks: np.ndarray
) -> np.ndarray:
    """Switch loads under the reuse credit: −δ on every marked switch."""
    return sched.loads() - sched.delta * np.asarray(marks, dtype=np.float64)


def effective_makespan(sched: ParallelSchedule, state: SwitchState) -> float:
    marks = reuse_marks(sched, state)
    loads = effective_loads(sched, marks)
    return float(loads.max()) if len(loads) else 0.0


def apply_reuse_order(
    sched: ParallelSchedule, state: SwitchState
) -> tuple[ParallelSchedule, np.ndarray]:
    """Rebuild ``sched`` in reuse serve order: on each marked switch the
    first configuration matching the installed permutation moves to the
    front (everything else keeps its relative order). Returns the new
    schedule plus the per-switch reuse marks. The input is not mutated —
    permutation arrays are shared, lists are fresh."""
    keys = state.installed_keys()
    switches: list[SwitchSchedule] = []
    marks = np.zeros(sched.s, dtype=bool)
    for h, sw in enumerate(sched.switches):
        perms = list(sw.perms)
        alphas = [float(a) for a in sw.alphas]
        if keys[h] is not None:
            for j, p in enumerate(perms):
                if perm_key(p) == keys[h]:
                    perms.insert(0, perms.pop(j))
                    alphas.insert(0, alphas.pop(j))
                    marks[h] = True
                    break
        switches.append(SwitchSchedule(perms=perms, alphas=alphas))
    return ParallelSchedule(switches=switches, delta=sched.delta), marks


def advance_installed(
    sched: ParallelSchedule, state: SwitchState, marks: np.ndarray
) -> list[np.ndarray | None]:
    """Next period's installed permutations: the last configuration each
    switch serves. A switch serving only its carried configuration — or
    nothing at all — keeps its previous state. ``sched`` must already be in
    reuse serve order (``apply_reuse_order``)."""
    out: list[np.ndarray | None] = []
    for h, sw in enumerate(sched.switches):
        served = sw.perms[1:] if marks[h] else list(sw.perms)
        if served:
            out.append(np.asarray(served[-1]))
        else:
            out.append(state.installed[h])
    return out


def online_ir_to_schedule(
    ds: DeviceSchedule, s: int, reused: np.ndarray
) -> tuple[ParallelSchedule, np.ndarray]:
    """Materialize a device online slot table as a host schedule in reuse
    serve order. ``reused`` is the (R,) slot mask from the device step;
    marked slots move to the front of their switch's list. Returns the
    schedule plus per-switch reuse flags."""
    perms = np.asarray(ds.perms)
    alphas = np.asarray(ds.alphas, dtype=np.float64)
    switch = np.asarray(ds.switch)
    reused = np.asarray(reused, dtype=bool)
    switches = [SwitchSchedule() for _ in range(s)]
    marks = np.zeros(s, dtype=bool)
    order = np.flatnonzero(switch >= 0)
    # Reused slots first (at most one per switch), then slot-index order.
    order = np.concatenate([order[reused[order]], order[~reused[order]]])
    for r in order:
        h = int(switch[r])
        if h >= s:
            raise ValueError(f"slot {r} assigned to switch {h} but s={s}")
        switches[h].perms.append(perms[r].astype(np.int64))
        switches[h].alphas.append(float(alphas[r]))
        marks[h] = marks[h] or bool(reused[r])
    return ParallelSchedule(switches=switches, delta=float(ds.delta)), marks
