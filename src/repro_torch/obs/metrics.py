"""One metrics vocabulary for serving, scenarios and benchmarks, a copy of
``repro.obs.metrics``.

The log-spaced ``LatencyHistogram``, the always-on ``ServeMetrics``
counters of the schedule server, the generic ``Counters`` bag and the
solver-warning taxonomy (``warning_category`` / ``warning_counts``) that
surfaces degraded solves (matcher budget exhausted, EQUALIZE headroom
exhausted) without digging through per-instance ``extras``. Everything
exports as a plain dict, so benchmarks write it straight to JSON.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Iterable


class LatencyHistogram:
    """Fixed log-spaced latency histogram (seconds).

    Bins span ``lo``..``hi`` with ``per_decade`` geometric bins per decade;
    observations clamp into the edge bins, so no sample is ever dropped.
    Quantiles interpolate within the winning bin (geometric), which is
    accurate to one bin width — plenty for p50/p99 SLO gating — while
    ``observe`` stays O(1) with no sample retention.
    """

    def __init__(
        self,
        lo: float = 1e-6,
        hi: float = 100.0,
        per_decade: int = 8,
    ) -> None:
        if not (0 < lo < hi):
            raise ValueError(f"need 0 < lo < hi, got {lo}, {hi}")
        self.lo = float(lo)
        self.hi = float(hi)
        decades = math.log10(hi / lo)
        self._nbins = max(1, int(math.ceil(decades * per_decade)))
        self._scale = self._nbins / math.log(hi / lo)
        self._counts = [0] * self._nbins
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, seconds: float) -> None:
        x = float(seconds)
        self.count += 1
        self.sum += x
        self.min = min(self.min, x)
        self.max = max(self.max, x)
        if x <= self.lo:
            b = 0
        elif x >= self.hi:
            b = self._nbins - 1
        else:
            b = min(int(self._scale * math.log(x / self.lo)), self._nbins - 1)
        self._counts[b] += 1

    def _edge(self, b: int) -> float:
        return self.lo * math.exp(b / self._scale)

    def percentile(self, p: float) -> float:
        """p in [0, 100]; NaN when empty. Clamped to the observed min/max."""
        if self.count == 0:
            return math.nan
        target = p / 100.0 * self.count
        cum = 0
        for b, c in enumerate(self._counts):
            cum += c
            if cum >= target:
                # Geometric midpoint-ish interpolation inside the bin.
                frac = 1.0 if c == 0 else 1.0 - (cum - target) / c
                val = self._edge(b) * math.exp(frac / self._scale)
                return min(max(val, self.min), self.max)
        return self.max  # pragma: no cover - cum always reaches count

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else math.nan

    def export(self) -> dict:
        return {
            "count": self.count,
            "mean_s": self.mean,
            "min_s": self.min if self.count else math.nan,
            "max_s": self.max if self.count else math.nan,
            "p50_s": self.percentile(50),
            "p90_s": self.percentile(90),
            "p99_s": self.percentile(99),
        }


# The per-request pipeline stages the server times. "queue_wait" is
# submit→dispatch, "device" is dispatch→results-collected, "install" is the
# OCS programming/ACK latency per installed batch, "e2e" is submit→installed.
STAGES = ("queue_wait", "device", "install", "e2e")


class Counters:
    """Named monotonic counters with dict export — the obs counter bag."""

    def __init__(self) -> None:
        self._counts: dict[str, int] = {}

    def inc(self, name: str, by: int = 1) -> None:
        self._counts[name] = self._counts.get(name, 0) + int(by)

    def get(self, name: str) -> int:
        return self._counts.get(name, 0)

    @property
    def total(self) -> int:
        return sum(self._counts.values())

    def export(self) -> dict[str, int]:
        return dict(sorted(self._counts.items()))

    def __bool__(self) -> bool:
        return bool(self._counts)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Counters({self.export()})"


# ---------------------------------------------------------------- warnings
# Solver warnings live in SolveReport.extras["warnings"] as free-form
# strings; this taxonomy buckets them into stable counter names so reports
# and CI can alarm on them without string-matching per call site.

WARNING_CATEGORIES = (
    "matcher_budget_exhausted",
    "equalize_headroom_exhausted",
    "other",
)


def warning_category(message: str) -> str:
    """Bucket one warning string into a stable counter name."""
    low = message.lower()
    if "matcher" in low:
        return "matcher_budget_exhausted"
    if "equalize" in low:
        return "equalize_headroom_exhausted"
    return "other"


def warning_counts(reports: Iterable[Any]) -> Counters:
    """Tally ``extras["warnings"]`` across SolveReports into obs counters.

    Also mirrors each tally into the default tracer as counter samples
    (when tracing is enabled), so degraded solves show up on the trace
    timeline next to the spans that produced them.
    """
    from .trace import get_tracer

    counters = Counters()
    for rep in reports:
        extras = getattr(rep, "extras", None) or {}
        for msg in extras.get("warnings", ()):
            counters.inc(warning_category(str(msg)))
    tracer = get_tracer()
    if tracer.enabled:
        for name, value in counters.export().items():
            tracer.counter(f"warnings.{name}", value)
    return counters


@dataclass
class ServeMetrics:
    """Always-on counters + stage histograms for one server instance."""

    stages: dict[str, LatencyHistogram] = field(
        default_factory=lambda: {name: LatencyHistogram() for name in STAGES}
    )
    admitted: int = 0
    degraded: int = 0
    shed: int = 0
    cache_hit_exact: int = 0
    cache_hit_support: int = 0
    cache_miss: int = 0
    batches: int = 0
    schedules: int = 0
    _t0: float = field(default_factory=time.perf_counter)

    def observe(self, stage: str, seconds: float) -> None:
        self.stages[stage].observe(seconds)

    def count_verdict(self, verdict: str) -> None:
        if verdict == "ADMIT":
            self.admitted += 1
        elif verdict == "DEGRADED":
            self.degraded += 1
        elif verdict == "SHED":
            self.shed += 1
        else:
            raise ValueError(f"unknown admission verdict {verdict!r}")

    @property
    def cache_hits(self) -> int:
        return self.cache_hit_exact + self.cache_hit_support

    @property
    def cache_hit_rate(self) -> float:
        total = self.cache_hits + self.cache_miss
        return self.cache_hits / total if total else math.nan

    @property
    def elapsed_s(self) -> float:
        return time.perf_counter() - self._t0

    @property
    def schedules_per_sec(self) -> float:
        dt = self.elapsed_s
        return self.schedules / dt if dt > 0 else math.nan

    def export(self) -> dict:
        """JSON-safe snapshot: counters, rates, and per-stage histograms."""
        return {
            "admitted": self.admitted,
            "degraded": self.degraded,
            "shed": self.shed,
            "cache_hit_exact": self.cache_hit_exact,
            "cache_hit_support": self.cache_hit_support,
            "cache_miss": self.cache_miss,
            "cache_hit_rate": self.cache_hit_rate,
            "batches": self.batches,
            "schedules": self.schedules,
            "elapsed_s": self.elapsed_s,
            "schedules_per_sec": self.schedules_per_sec,
            "stages": {k: h.export() for k, h in self.stages.items()},
        }
