"""Two-tier schedule cache keyed by support pattern and quantized weights (a
copy of ``repro.serve.cache``, over the port's host ``core`` modules).

Phase-cycling traffic (MoE routing that revisits a small set of expert
assignments, periodic collective phases) re-presents the same demand
*structure* every few periods. Decomposition is the expensive stage of the
pipeline, and its output is reusable in two grades:

- **Exact tier** — key = (support pattern, weights quantized to a relative
  grid). A hit returns the stored ``ParallelSchedule`` verbatim after a
  coverage validation against the live matrix (tolerance = one quantization
  step, which same-key matrices satisfy by construction). Zero solve work.
- **Support tier** — key = support pattern only. A hit replays the stored
  permutations: ``refine_greedy`` *starting from the stored weights* tops
  them up to cover the live matrix (starting from the stored alphas rather
  than zero is load-bearing — re-refining overlapping permutations from
  zero over-provisions badly), then LPT + EQUALIZE rebuild the schedule.
  A quality gate rejects the replay when its total weight exceeds the
  stored fresh-solve efficiency by more than ``ratio_slack``, so a stale
  structure can never silently serve a bloated schedule.

This is the host-side generalization of the device-side support cache in
``core.torchopt.online_torch`` (same key, same gates); the server consults it
before dispatching to the device, so cache hits cost microseconds and
never occupy the accelerator.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass

import numpy as np

from ..core.decompose import Decomposition, refine_greedy
from ..core.equalize import equalize
from ..core.schedule import ParallelSchedule, schedule_lpt


def _max_line_sum(D: np.ndarray) -> float:
    """max row/col sum — the total-weight lower bound of any cover."""
    return float(max(D.sum(axis=1).max(), D.sum(axis=0).max(), 0.0))


def support_key(D: np.ndarray) -> bytes:
    """Canonical bytes key for the boolean support pattern of ``D``."""
    S = np.asarray(D) > 0
    return S.shape[0].to_bytes(4, "little") + np.packbits(S).tobytes()


def _quant_scale(D: np.ndarray, quant_rel: float) -> float:
    """Quantization step, itself snapped to a coarse log2 grid of D's max.

    Snapping the step keeps near-identical matrices (multiplicative drift
    well under one grid cell) on the *same* grid; without it every matrix
    would define its own step and exact-tier keys would never collide.
    """
    m = float(np.asarray(D).max())
    if m <= 0:
        return quant_rel
    snapped = 2.0 ** (round(4.0 * np.log2(m)) / 4.0)
    return quant_rel * snapped


def exact_key(D: np.ndarray, quant_rel: float) -> tuple[bytes, bytes]:
    D = np.asarray(D, dtype=np.float64)
    step = _quant_scale(D, quant_rel)
    q = np.round(D / step).astype(np.int64)
    return support_key(D), q.tobytes()


@dataclass
class CacheResult:
    """A schedule served from the cache instead of the solver."""

    schedule: ParallelSchedule
    makespan: float
    num_configs: int
    tier: str  # "exact" | "support"


@dataclass
class _SupportEntry:
    perms: list[np.ndarray]
    alphas: list[float]
    ratio: float  # fresh-solve total_weight / max line sum — quality ref


@dataclass
class CacheStats:
    hits_exact: int = 0
    hits_support: int = 0
    misses: int = 0
    inserts: int = 0
    rejected_quality: int = 0

    @property
    def hits(self) -> int:
        return self.hits_exact + self.hits_support

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else float("nan")


class ScheduleCache:
    """Host-side two-tier schedule cache (exact + support pattern).

    ``lookup`` returns a ``CacheResult`` or None; ``insert`` records a
    fresh solve's decomposition (and full schedule for the exact tier).
    Both tiers are FIFO-bounded at ``capacity`` entries; re-inserting an
    existing key updates it in place without consuming a slot.
    """

    def __init__(
        self,
        capacity: int = 64,
        *,
        quant_rel: float = 1e-3,
        ratio_slack: float = 0.1,
    ) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.quant_rel = float(quant_rel)
        self.ratio_slack = float(ratio_slack)
        self._exact: OrderedDict[tuple, tuple[ParallelSchedule, float]] = (
            OrderedDict()
        )
        self._support: OrderedDict[bytes, _SupportEntry] = OrderedDict()
        self.stats = CacheStats()

    def __len__(self) -> int:
        return len(self._support)

    def lookup(
        self,
        D: np.ndarray,
        s: int,
        delta: float,
        *,
        do_equalize: bool = True,
        merge_aware: bool = False,
    ) -> CacheResult | None:
        D = np.asarray(D, dtype=np.float64)
        ek = exact_key(D, self.quant_rel)
        hit = self._exact.get(ek)
        if hit is not None:
            sched, step = hit
            if sched.delta == float(delta) and sched.s == s:
                try:
                    sched.validate(D, tol=1.01 * step + 1e-9)
                except AssertionError:
                    pass
                else:
                    self.stats.hits_exact += 1
                    return CacheResult(
                        schedule=sched,
                        makespan=sched.makespan(),
                        num_configs=sched.num_configs(),
                        tier="exact",
                    )
        entry = self._support.get(support_key(D))
        if entry is not None:
            res = self._replay(D, s, delta, entry, do_equalize, merge_aware)
            if res is not None:
                self.stats.hits_support += 1
                return res
        self.stats.misses += 1
        return None

    def _replay(
        self,
        D: np.ndarray,
        s: int,
        delta: float,
        entry: _SupportEntry,
        do_equalize: bool,
        merge_aware: bool,
    ) -> CacheResult | None:
        alphas = refine_greedy(D, entry.alphas, entry.perms)
        dec = Decomposition(
            perms=[p for p, a in zip(entry.perms, alphas) if a > 0],
            alphas=[a for a in alphas if a > 0],
        )
        tol = 1e-9 * max(float(D.max()), 1.0)
        if not dec.covers(D, tol=tol):
            return None  # pragma: no cover - same support always replays
        line = _max_line_sum(D)
        ratio = dec.total_weight() / line if line > 0 else 1.0
        if ratio > entry.ratio * (1.0 + self.ratio_slack):
            self.stats.rejected_quality += 1
            return None
        sched = schedule_lpt(dec, s, float(delta))
        if do_equalize:
            sched = equalize(sched, merge_aware=merge_aware)
        return CacheResult(
            schedule=sched,
            makespan=sched.makespan(),
            num_configs=sched.num_configs(),
            tier="support",
        )

    def insert(
        self,
        D: np.ndarray,
        schedule: ParallelSchedule,
        decomposition: Decomposition | None = None,
    ) -> None:
        """Record a fresh solve. The decomposition defaults to the union of
        the schedule's per-switch (perm, weight) lists — always available,
        even for lazily-materialized device schedules."""
        D = np.asarray(D, dtype=np.float64)
        if decomposition is None:
            perms: list[np.ndarray] = []
            alphas: list[float] = []
            for sw in schedule.switches:
                perms.extend(np.asarray(p) for p in sw.perms)
                alphas.extend(float(a) for a in sw.alphas)
            decomposition = Decomposition(perms=perms, alphas=alphas)
        line = _max_line_sum(D)
        ratio = (
            decomposition.total_weight() / line if line > 0 else 1.0
        )
        ek = exact_key(D, self.quant_rel)
        step = _quant_scale(D, self.quant_rel)
        self._put(self._exact, ek, (schedule, step))
        self._put(
            self._support,
            support_key(D),
            _SupportEntry(
                perms=[np.asarray(p) for p in decomposition.perms],
                alphas=[float(a) for a in decomposition.alphas],
                ratio=ratio,
            ),
        )
        self.stats.inserts += 1

    def _put(self, store: OrderedDict, key, value) -> None:
        if key in store:
            store[key] = value  # update in place, keep FIFO position
            return
        while len(store) >= self.capacity:
            store.popitem(last=False)
        store[key] = value
