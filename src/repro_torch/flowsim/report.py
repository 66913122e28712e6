"""FlowSimOptions / FlowStats / FlowSimReport — the flow-level result shape
(a copy of ``repro.flowsim.report``, with the port's backend tolerance).

Every flow-level replay — SPECTRA schedules, rotor round-robin, rotor+VLB —
returns one ``FlowSimReport``: per-flow completion times (FCT), their
distribution (p50/p90/p99/mean/max, linear-interpolated ``np.percentile``),
the coordinated completion time (CCT = last flow's FCT), per-switch
utilization and δ-overhead, and the bytes-conservation verdict that is the
real validation for indirection-dependent schedules (whose matrix-level
Eq. 3 coverage is undefined).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Mapping

import numpy as np

__all__ = ["FlowSimOptions", "FlowStats", "FlowSimReport"]

_INDIRECTION = ("auto", "none", "vlb")
_ARRIVAL = ("start", "uniform")


@dataclass(frozen=True)
class FlowSimOptions:
    """Knobs of the flow-level replay.

    * ``line_rate`` — service rate of one circuit, demand units per time
      unit. 1.0 is the normalized fabric (one unit of demand takes one
      unit of time on one link), matching the matrix-level simulator.
    * ``buffer_limit`` — per-node cap on *indirect* (VLB hop-1) bytes a
      host can hold for later forwarding, in demand units. ``inf`` models
      unbounded host memory; finite values throttle hop-1 injection (a
      full buffer admits nothing until hop-2 drains it).
    * ``indirection`` — ``"none"`` replays circuits directly; ``"vlb"``
      enables 2-hop Valiant load balancing (leftover window capacity
      carries traffic to an intermediate that forwards it across a later
      window); ``"auto"`` (default) enables VLB exactly when the solver's
      report asks for it (``SolveReport.extras["indirection"] == "vlb"``,
      e.g. the ``rotor_vlb`` baseline).
    * ``tol`` — completion/conservation tolerance in demand units.
      ``None`` (default) resolves per schedule backend exactly like the
      matrix simulator's verdict tolerance: 1e-9 for float64 host
      schedules, 1e-4 for float32 device (``"torch"``) schedules, whose
      alphas legitimately undershoot demand at single-precision scale.
    * ``arrival`` — when each flow's bytes become sendable. ``"start"``
      (default) is the classic all-at-t=0 replay the schedule was solved
      for; ``"uniform"`` releases each flow at an independent uniform
      time in ``[0, arrival_span · finish]`` — the demand estimate a real
      controller schedules is collected *during* the period, so bytes
      trickle in while circuits are already up. Capacity a circuit sees
      before its flow's release is lost (no retroactive service), so a
      schedule that is exact at ``line_rate=1`` generally needs headroom
      to complete under staggered arrivals.
    * ``arrival_span`` — fraction of the timeline finish over which
      uniform releases spread (default 0.5).
    * ``arrival_seed`` — RNG seed for the release draw (deterministic
      replays).
    """

    line_rate: float = 1.0
    buffer_limit: float = math.inf
    indirection: str = "auto"
    tol: float | None = None
    arrival: str = "start"
    arrival_span: float = 0.5
    arrival_seed: int = 0

    def __post_init__(self) -> None:
        if self.line_rate <= 0:
            raise ValueError(f"line_rate must be positive, got {self.line_rate}")
        if self.tol is not None and self.tol <= 0:
            raise ValueError(f"tol must be positive, got {self.tol}")
        if self.buffer_limit < 0:
            raise ValueError(
                f"buffer_limit must be nonnegative, got {self.buffer_limit}"
            )
        if self.indirection not in _INDIRECTION:
            raise ValueError(
                f"indirection must be one of {_INDIRECTION}, "
                f"got {self.indirection!r}"
            )
        if self.arrival not in _ARRIVAL:
            raise ValueError(
                f"arrival must be one of {_ARRIVAL}, got {self.arrival!r}"
            )
        if self.arrival_span < 0:
            raise ValueError(
                f"arrival_span must be nonnegative, got {self.arrival_span}"
            )

    @classmethod
    def from_params(cls, params: Mapping[str, Any] | None) -> "FlowSimOptions":
        """Build from a scenario's ``flowsim_params`` mapping."""
        return cls(**dict(params or {}))

    def resolve_tol(self, sched: Any) -> float:
        """The effective tolerance against this schedule (see ``tol``)."""
        if self.tol is not None:
            return self.tol
        return 1e-4 if getattr(sched, "backend", None) == "torch" else 1e-9


@dataclass(frozen=True)
class FlowStats:
    """Distribution summary of one completion-time sample (NaN when empty)."""

    p50: float
    p90: float
    p99: float
    mean: float
    max: float
    count: int

    @classmethod
    def from_sample(cls, sample: np.ndarray) -> "FlowStats":
        sample = np.asarray(sample, dtype=np.float64)
        sample = sample[np.isfinite(sample)]
        if len(sample) == 0:
            nan = float("nan")
            return cls(p50=nan, p90=nan, p99=nan, mean=nan, max=nan, count=0)
        p50, p90, p99 = np.percentile(sample, [50, 90, 99])
        return cls(
            p50=float(p50), p90=float(p90), p99=float(p99),
            mean=float(sample.mean()), max=float(sample.max()),
            count=int(len(sample)),
        )


@dataclass
class FlowSimReport:
    """One flow-level replay of one schedule against one demand matrix."""

    finish_time: float           # Timeline.finish — circuit replay makespan
    fct: np.ndarray              # (F,) per-flow completion time; inf = stuck
    flow_src: np.ndarray         # (F,) source port per flow
    flow_dst: np.ndarray         # (F,) destination port per flow
    flow_size: np.ndarray        # (F,) demand units per flow
    delivered: np.ndarray        # (F,) units delivered to the destination
    fct_stats: FlowStats         # FCT distribution over *completed* flows
    cct: float                   # last completion (inf if any flow is stuck)
    utilization: np.ndarray      # (s,) serve-busy time / finish per switch
    delta_fraction: np.ndarray   # (s,) reconfiguration time / finish
    delta_overhead: float        # aggregate δ share of total switch-time
    conserved: bool              # every flow delivered in full (± tol)
    residual: float              # total undelivered units (incl. buffered)
    port_ok: bool                # no switch served two circuits at once
    indirected: float            # units delivered via a 2-hop VLB detour
    options: FlowSimOptions = field(default_factory=FlowSimOptions)
    extras: dict[str, Any] = field(default_factory=dict)

    @property
    def num_flows(self) -> int:
        return int(len(self.fct))

    @property
    def completed(self) -> int:
        return int(np.isfinite(self.fct).sum())

    @property
    def demand_total(self) -> float:
        return float(self.flow_size.sum())

    @property
    def delivered_total(self) -> float:
        return float(self.delivered.sum())

    @property
    def indirect_fraction(self) -> float:
        """Share of delivered units that took the 2-hop detour."""
        total = self.delivered_total
        return self.indirected / total if total > 0 else 0.0

    def summary(self) -> dict[str, Any]:
        """Flat row (what benchmarks and the smoke lane print)."""
        return {
            "flows": self.num_flows,
            "completed": self.completed,
            "fct_p50": self.fct_stats.p50,
            "fct_p90": self.fct_stats.p90,
            "fct_p99": self.fct_stats.p99,
            "fct_mean": self.fct_stats.mean,
            "fct_max": self.fct_stats.max,
            "cct": self.cct,
            "finish": self.finish_time,
            "util_mean": (
                float(self.utilization.mean()) if len(self.utilization) else 0.0
            ),
            "delta_overhead": self.delta_overhead,
            # Switch-time attribution shares (see obs.timeline_table):
            # serve is util_mean, δ is delta_share, the rest of the horizon
            # is idle — the three sum to 1 per switch by construction.
            "delta_share": (
                float(self.delta_fraction.mean())
                if len(self.delta_fraction)
                else 0.0
            ),
            "idle_share": (
                float(
                    np.clip(
                        1.0 - self.utilization - self.delta_fraction, 0.0, 1.0
                    ).mean()
                )
                if len(self.utilization)
                else 0.0
            ),
            "indirect_frac": self.indirect_fraction,
            "conserved": self.conserved,
            "residual": self.residual,
        }
