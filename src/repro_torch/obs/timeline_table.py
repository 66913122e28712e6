"""Time-expanded switch tables and makespan attribution, a copy of
``repro.obs.timeline_table``.

Built on ``fabric.timeline.build_timeline``, the one source of truth for
circuit timing, this module answers *where the makespan goes*:

* ``timeline_table`` expands one schedule into per-switch occupancy rows
  (``serve`` / ``reconf`` / ``idle`` intervals covering ``[0, horizon)``
  exactly), per-switch utilization, and per-round statistics.
* ``MakespanAttribution`` is the accounting identity underneath:

      transmission + δ paid + idle  ≡  s · makespan

  (each switch's horizon splits exactly into serve time, reconfiguration
  time actually paid, and idle tail). The same identity divided by ``s``
  gives an **exact** lower-bound-gap decomposition:

      makespan − LB  ≡  (transmission/s − LB)  +  δpaid/s  +  idle/s

  whose first term may be negative (the §IV bound already charges some
  transmission *and* δ) — the other two are the overheads SPECTRA's
  EQUALIZE and the online controller's reuse credit attack directly.
* ``attribute_scenario`` runs the expansion over every period of a
  ``ScenarioReport`` (and the credit-aware online pass of an
  ``OnlineReport``, replaying the installed-configuration chain), checks
  the identity per period, and aggregates — turning "the gap is 1.07×"
  into "4% δ, 2% idle, 1% imbalance".

Nothing here imports the scenario registry (reports are duck-typed), so
``scenarios`` can lazily call back into this module without a cycle.

One change from the reference: the default tolerance follows the port's
backends. Device schedules carry ``backend="torch"`` (float32 on the
device) and resolve to 1e-4, as ``SolveOptions.tol`` does; host schedules
(``"numpy"``) to 1e-9.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np

from ..fabric.timeline import Timeline, build_timeline

__all__ = [
    "Interval",
    "MakespanAttribution",
    "ScenarioAttribution",
    "SwitchRow",
    "TimelineTable",
    "attribute_scenario",
    "timeline_table",
]


@dataclass(frozen=True)
class Interval:
    """One occupancy interval on one switch: ``[start, end)``."""

    switch: int
    kind: str      # "serve" | "reconf" | "idle"
    start: float
    end: float
    slot: int = -1  # serve intervals: position in the switch's slot list

    @property
    def duration(self) -> float:
        return self.end - self.start


@dataclass
class SwitchRow:
    """One switch's time-expanded row over ``[0, horizon)``."""

    switch: int
    intervals: list[Interval]
    serve_time: float
    reconf_time: float
    idle_time: float
    horizon: float
    reused: bool  # first slot served δ-free via a carried configuration

    @property
    def utilization(self) -> float:
        """Serve-busy fraction of the horizon (0 for an empty horizon)."""
        return self.serve_time / self.horizon if self.horizon > 0 else 0.0

    @property
    def reconf_fraction(self) -> float:
        return self.reconf_time / self.horizon if self.horizon > 0 else 0.0

    @property
    def idle_fraction(self) -> float:
        return self.idle_time / self.horizon if self.horizon > 0 else 0.0


@dataclass
class MakespanAttribution:
    """The identity ``transmission + δ paid + idle == s · makespan``.

    All quantities are in demand-time units, summed over switches.
    ``lower_bound`` is NaN when the producing report carried none.
    """

    s: int
    makespan: float      # the horizon (credit-aware for online timelines)
    transmission: float  # Σ serve time over switches (Σ α)
    delta_paid: float    # Σ reconfiguration time actually paid
    idle: float          # Σ (horizon − busy) over switches
    lower_bound: float = float("nan")
    reuse_count: int = 0                 # switches that served δ-free
    delta_avoided: float = 0.0           # δ · reuse_count

    @property
    def identity_residual(self) -> float:
        """``transmission + δ paid + idle − s·makespan`` (≈ 0 by construction)."""
        return self.transmission + self.delta_paid + self.idle - self.s * self.makespan

    def check(self, tol: float = 1e-9) -> None:
        """Assert the identity within ``tol`` (relative to s·makespan)."""
        scale = max(1.0, self.s * abs(self.makespan))
        if abs(self.identity_residual) > tol * scale:
            raise AssertionError(
                f"attribution identity violated: transmission {self.transmission}"
                f" + delta {self.delta_paid} + idle {self.idle}"
                f" != {self.s} * {self.makespan}"
                f" (residual {self.identity_residual})"
            )

    # Shares of the total switch-time budget (sum to 1 when makespan > 0).
    @property
    def transmission_share(self) -> float:
        total = self.s * self.makespan
        return self.transmission / total if total > 0 else 0.0

    @property
    def delta_share(self) -> float:
        total = self.s * self.makespan
        return self.delta_paid / total if total > 0 else 0.0

    @property
    def idle_share(self) -> float:
        total = self.s * self.makespan
        return self.idle / total if total > 0 else 0.0

    # Exact LB-gap decomposition (see module doc): the three terms sum to
    # ``makespan − lower_bound`` identically.
    @property
    def lb_gap(self) -> float:
        return self.makespan - self.lower_bound

    @property
    def gap_from_transmission(self) -> float:
        """``transmission/s − LB`` — may be negative (LB charges δ too)."""
        return self.transmission / self.s - self.lower_bound

    @property
    def gap_from_delta(self) -> float:
        return self.delta_paid / self.s

    @property
    def gap_from_idle(self) -> float:
        return self.idle / self.s

    def summary(self) -> dict[str, Any]:
        return {
            "s": self.s,
            "makespan": self.makespan,
            "transmission": self.transmission,
            "delta_paid": self.delta_paid,
            "delta_avoided": self.delta_avoided,
            "idle": self.idle,
            "reuse_count": self.reuse_count,
            "transmission_share": self.transmission_share,
            "delta_share": self.delta_share,
            "idle_share": self.idle_share,
            "identity_residual": self.identity_residual,
            "lower_bound": self.lower_bound,
            "lb_gap": self.lb_gap,
            "gap_from_transmission": self.gap_from_transmission,
            "gap_from_delta": self.gap_from_delta,
            "gap_from_idle": self.gap_from_idle,
        }


@dataclass
class TimelineTable:
    """Time-expanded table of one schedule: rows, rounds, attribution."""

    rows: list[SwitchRow]
    horizon: float
    delta: float
    attribution: MakespanAttribution
    timeline: Timeline = field(repr=False, default=None)

    @property
    def s(self) -> int:
        return len(self.rows)

    @property
    def utilization(self) -> np.ndarray:
        """(s,) serve-busy fraction per switch."""
        return np.array([r.utilization for r in self.rows])

    def per_round(self) -> list[dict[str, Any]]:
        """Round (slot-index) statistics across switches.

        Round ``j`` aggregates every switch's j-th served configuration:
        how many switches are still active at that depth, the total and
        extreme serve durations, and the *spread* (max − min α) that
        EQUALIZE exists to shrink.
        """
        by_slot: dict[int, list[float]] = {}
        for w in self.timeline.windows:
            by_slot.setdefault(w.slot, []).append(w.alpha)
        out = []
        for j in sorted(by_slot):
            alphas = np.array(by_slot[j])
            out.append(
                {
                    "round": j,
                    "switches": int(len(alphas)),
                    "alpha_total": float(alphas.sum()),
                    "alpha_mean": float(alphas.mean()),
                    "alpha_max": float(alphas.max()),
                    "alpha_min": float(alphas.min()),
                    "spread": float(alphas.max() - alphas.min()),
                }
            )
        return out

    def render_ascii(self, width: int = 72) -> str:
        """Per-switch occupancy strips: ``#`` serve, ``/`` reconf, ``·`` idle."""
        if self.horizon <= 0 or not self.rows:
            return "(empty schedule)"
        chars = {"serve": "#", "reconf": "/", "idle": "·"}
        lines = []
        for row in self.rows:
            strip = []
            for c in range(width):
                # Sample the interval covering this column's midpoint.
                t = (c + 0.5) / width * self.horizon
                kind = "idle"
                for iv in row.intervals:
                    if iv.start <= t < iv.end:
                        kind = iv.kind
                        break
                strip.append(chars[kind])
            reuse = "+" if row.reused else " "
            lines.append(
                f"  ocs{row.switch:<3d}{reuse}|{''.join(strip)}| "
                f"util={row.utilization:5.1%} δ={row.reconf_fraction:5.1%} "
                f"idle={max(row.idle_fraction, 0.0):5.1%}"
            )
        lines.append(
            f"  {'':7s}|{'-' * width}| horizon={self.horizon:.4f} "
            f"(# serve, / reconf, · idle, + reused carry-over)"
        )
        return "\n".join(lines)


def timeline_table(
    sched,
    *,
    installed: Sequence[np.ndarray | None] | None = None,
    lower_bound: float | None = None,
    horizon: float | None = None,
) -> TimelineTable:
    """Expand a schedule into its time-expanded switch table.

    Accepts a ``ParallelSchedule`` or anything carrying one under
    ``.schedule`` (``SolveReport``; its ``lower_bound`` is picked up when
    ``lower_bound`` is not given). ``installed`` enables the online reuse
    credit exactly as in ``fabric.simulator``. ``horizon`` defaults to the
    timeline finish — pass the controller-period makespan to account a
    switch's time against a longer horizon (more idle).
    """
    if lower_bound is None:
        lower_bound = float(getattr(sched, "lower_bound", float("nan")))
    tl = build_timeline(sched, installed=installed)
    if horizon is None:
        horizon = tl.finish
    elif horizon < tl.finish - 1e-9 * max(1.0, tl.finish):
        raise ValueError(
            f"horizon {horizon} is shorter than the timeline finish {tl.finish}"
        )
    rows: list[SwitchRow] = []
    windows_by_switch: dict[int, list] = {h: [] for h in range(tl.s)}
    for w in tl.windows:
        windows_by_switch[w.switch].append(w)
    for h in range(tl.s):
        intervals: list[Interval] = []
        serve = reconf = 0.0
        t = 0.0
        for w in windows_by_switch[h]:
            if not w.reused:
                intervals.append(Interval(h, "reconf", t, w.start))
                reconf += w.start - t
            intervals.append(Interval(h, "serve", w.start, w.end, slot=w.slot))
            serve += w.alpha
            t = w.end
        if t < horizon:
            intervals.append(Interval(h, "idle", t, horizon))
        # Idle from the attribution identity, so the three components sum
        # to the horizon exactly even under float accumulation.
        idle = horizon - serve - reconf
        rows.append(
            SwitchRow(
                switch=h,
                intervals=intervals,
                serve_time=serve,
                reconf_time=reconf,
                idle_time=idle,
                horizon=horizon,
                reused=bool(tl.reused_switches[h]),
            )
        )
    attribution = MakespanAttribution(
        s=tl.s,
        makespan=horizon,
        transmission=float(sum(r.serve_time for r in rows)),
        delta_paid=float(sum(r.reconf_time for r in rows)),
        idle=float(sum(r.idle_time for r in rows)),
        lower_bound=lower_bound,
        reuse_count=int(tl.reused_switches.sum()),
        delta_avoided=float(tl.delta * tl.reused_switches.sum()),
    )
    return TimelineTable(
        rows=rows, horizon=horizon, delta=tl.delta,
        attribution=attribution, timeline=tl,
    )


@dataclass
class ScenarioAttribution:
    """Per-period timeline tables + aggregate attribution for one report."""

    scenario: str
    solver: str
    tables: list[TimelineTable]               # stateless pass, trace order
    online_tables: list[TimelineTable] = field(default_factory=list)
    tol: float = 1e-9

    def check(self) -> None:
        """Assert the attribution identity on every period (both passes)."""
        for t, table in enumerate(self.tables + self.online_tables):
            try:
                table.attribution.check(self.tol)
            except AssertionError as exc:
                raise AssertionError(f"period {t}: {exc}") from None

    @staticmethod
    def _aggregate(tables: list[TimelineTable]) -> dict[str, Any]:
        att = [t.attribution for t in tables]
        total = sum(a.s * a.makespan for a in att)
        lbs = np.array([a.lower_bound for a in att])
        gaps = np.array([a.lb_gap for a in att])
        finite = np.isfinite(gaps)
        utils = np.concatenate([t.utilization for t in tables]) if tables else np.array([])
        return {
            "periods": len(att),
            "total_makespan": float(sum(a.makespan for a in att)),
            "transmission": float(sum(a.transmission for a in att)),
            "delta_paid": float(sum(a.delta_paid for a in att)),
            "delta_avoided": float(sum(a.delta_avoided for a in att)),
            "idle": float(sum(a.idle for a in att)),
            "reuse_count": int(sum(a.reuse_count for a in att)),
            "transmission_share": (
                float(sum(a.transmission for a in att) / total) if total > 0 else 0.0
            ),
            "delta_share": (
                float(sum(a.delta_paid for a in att) / total) if total > 0 else 0.0
            ),
            "idle_share": (
                float(sum(a.idle for a in att) / total) if total > 0 else 0.0
            ),
            "util_mean": float(utils.mean()) if len(utils) else 0.0,
            "util_min": float(utils.min()) if len(utils) else 0.0,
            "total_lb": float(lbs[finite].sum()) if finite.any() else float("nan"),
            "total_lb_gap": float(gaps[finite].sum()) if finite.any() else float("nan"),
            "gap_from_transmission": float(
                sum(a.gap_from_transmission for a in att if np.isfinite(a.lb_gap))
            ),
            "gap_from_delta": float(sum(a.gap_from_delta for a in att)),
            "gap_from_idle": float(sum(a.gap_from_idle for a in att)),
            "max_identity_residual": (
                float(max(abs(a.identity_residual) for a in att)) if att else 0.0
            ),
        }

    def summary(self) -> dict[str, Any]:
        """Flat aggregate row; online keys appear when the report was online."""
        row = {"scenario": self.scenario, "solver": self.solver}
        row.update(self._aggregate(self.tables))
        if self.online_tables:
            online = self._aggregate(self.online_tables)
            row.update({f"online_{k}": v for k, v in online.items()})
        return row


def attribute_scenario(report, *, tol: float | None = None) -> ScenarioAttribution:
    """Time-expand every period of a ``ScenarioReport`` and check the identity.

    For an ``OnlineReport`` the online pass is expanded too: the
    installed-configuration chain is replayed (exactly as the runner
    replayed it), so online timelines start from each period's carried
    switch state and their horizons are the credit-aware makespans.

    ``tol`` bounds the identity residual and the horizon-vs-reported
    makespan agreement; ``None`` resolves per backend (1e-9 host, 1e-4 for
    the float32 ``"torch"`` device schedules), matching the validation
    tolerances everywhere else.
    """
    if tol is None:
        backends = {r.backend for r in report.reports}
        tol = 1e-4 if "torch" in backends else 1e-9
    tables: list[TimelineTable] = []
    for t, rep in enumerate(report.reports):
        table = timeline_table(rep)
        table.attribution.check(tol)
        reported = float(rep.makespan)
        if abs(table.horizon - reported) > tol * max(1.0, reported):
            raise AssertionError(
                f"period {t}: timeline horizon {table.horizon} disagrees "
                f"with reported makespan {reported}"
            )
        tables.append(table)

    online_tables: list[TimelineTable] = []
    online_periods = getattr(report, "online_periods", None)
    if online_periods:
        from ..online import SwitchState, advance_installed, reuse_marks

        installed: list[np.ndarray | None] = [None] * report.spec.s
        for t, p in enumerate(online_periods):
            table = timeline_table(
                p.schedule,
                installed=installed,
                lower_bound=float(report.reports[t].lower_bound),
            )
            table.attribution.check(tol)
            reported = float(p.makespan)
            if abs(table.horizon - reported) > 1e-6 * max(1.0, reported):
                raise AssertionError(
                    f"online period {t}: timeline horizon {table.horizon} "
                    f"disagrees with credit-aware makespan {reported}"
                )
            paid = float(p.delta_paid)
            if abs(table.attribution.delta_paid - paid) > tol * max(1.0, paid):
                raise AssertionError(
                    f"online period {t}: timeline delta paid "
                    f"{table.attribution.delta_paid} != accounted {paid}"
                )
            online_tables.append(table)
            state = SwitchState(installed=installed)
            marks = reuse_marks(p.schedule, state)
            installed = advance_installed(p.schedule, state, marks)
    return ScenarioAttribution(
        scenario=report.scenario,
        solver=report.solver,
        tables=tables,
        online_tables=online_tables,
        tol=tol,
    )
