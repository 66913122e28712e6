"""``run_scenario`` — a whole trace through the batched solver, one report.

The port's counterpart of ``repro.scenarios.runner``: materialize a
scenario's ``(T, n, n)`` demand trace, push every period through
``repro_torch.api.solve_many`` (on ``spectra_torch`` one fused device call
per shape bucket, on ``options.extra["device"]``, None meaning CUDA),
optionally replay each period through the event-level simulator and the
flow-level one (``flowsim``), and aggregate per-period makespans,
lower-bound gaps and, for byte traces, CCT seconds under the scenario's
``OCSFabric``. ``online=True`` adds the stateful pass: the host
``OnlineController``, or for ``spectra_torch`` the device
``spectra_online_scan``. The report's ``warning_counters`` and
``attribution_summary`` read ``obs.metrics`` and ``obs.timeline_table``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from ..api import SolveOptions, SolveReport, solve_many
from ..api.batch import shape_buckets
from ..obs.trace import get_tracer
from .registry import Scenario, get_scenario
from .spec import DemandTrace, TrafficSpec


@dataclass
class PeriodResult:
    """One controller period's scheduling outcome."""

    period: int
    makespan: float          # demand-time units
    lower_bound: float       # §IV bound, same units (NaN if compute_lb=False)
    gap: float               # makespan / lower_bound
    num_configs: int
    cct_s: float             # wall-clock CCT seconds (NaN for unit traces)
    meta: dict = field(default_factory=dict)
    demand_met: bool | None = None   # simulator verdict (None unless simulated)
    ref_makespan: float = float("nan")  # quality_ref solver's makespan
    flowsim: Any = None              # FlowSimReport (None unless flowsim=True)


@dataclass
class ScenarioReport:
    """Aggregate result of one scenario × solver run."""

    scenario: str
    solver: str
    spec: TrafficSpec
    trace: DemandTrace
    reports: list[SolveReport]       # per-period SolveReports, trace order
    periods: list[PeriodResult]
    unit_s: float                    # seconds per demand unit (NaN: unit trace)
    delta_units: Any                 # δ in units: scalar, or (T,) for δ sweeps
    num_shape_buckets: int           # solve_many dispatch groups (1 per shape)
    runtime_s: float                 # wall time of the solve_many call
    quality_ref: str | None = None   # reference solver of the quality ratios
    flowsim_options: Any = None      # resolved FlowSimOptions (None: no flowsim)

    @property
    def deltas_units(self) -> np.ndarray:
        """Per-period δ in units, shape (T,) — broadcast when constant."""
        return np.broadcast_to(
            np.asarray(self.delta_units, dtype=np.float64), (self.trace.T,)
        )

    @property
    def makespans(self) -> np.ndarray:
        return np.array([p.makespan for p in self.periods])

    @property
    def lower_bounds(self) -> np.ndarray:
        return np.array([p.lower_bound for p in self.periods])

    @property
    def gaps(self) -> np.ndarray:
        return np.array([p.gap for p in self.periods])

    @property
    def cct_s(self) -> np.ndarray:
        return np.array([p.cct_s for p in self.periods])

    @property
    def total_cct_s(self) -> float:
        finite = self.cct_s[np.isfinite(self.cct_s)]
        return float(finite.sum()) if len(finite) else float("nan")

    @property
    def geomean_gap(self) -> float:
        gaps = self.gaps
        finite = gaps[np.isfinite(gaps) & (gaps > 0)]
        return float(np.exp(np.mean(np.log(finite)))) if len(finite) else float("nan")

    @property
    def quality_ratios(self) -> np.ndarray:
        """Per-period makespan / ``quality_ref`` solver's makespan (NaN when
        ``run_scenario`` ran without a reference)."""
        return np.array(
            [p.makespan / p.ref_makespan if p.ref_makespan else float("nan")
             for p in self.periods]
        )

    @property
    def geomean_quality_ratio(self) -> float:
        r = self.quality_ratios
        finite = r[np.isfinite(r) & (r > 0)]
        return float(np.exp(np.mean(np.log(finite)))) if len(finite) else float("nan")

    @property
    def max_quality_ratio(self) -> float:
        r = self.quality_ratios
        finite = r[np.isfinite(r)]
        return float(finite.max()) if len(finite) else float("nan")

    def warning_counters(self):
        """Solver warnings across all periods, tallied as obs ``Counters``
        (``matcher_budget_exhausted`` / ``equalize_headroom_exhausted``)."""
        from ..obs.metrics import warning_counts

        return warning_counts(self.reports)

    def attribution_summary(self, tol: float | None = None) -> dict[str, Any]:
        """Makespan attribution over the whole trace: where the switch-time
        budget went (serve / δ paid / idle shares) and the exact LB-gap
        decomposition, with the identity checked on every period. Expands
        every period's timeline — materializes lazy device schedules."""
        from ..obs.timeline_table import attribute_scenario

        att = attribute_scenario(self, tol=tol)
        att.check()
        return att.summary()

    @property
    def flowsim_reports(self) -> list:
        """Per-period FlowSimReports, trace order (empty when flowsim off)."""
        return [p.flowsim for p in self.periods if p.flowsim is not None]

    @property
    def fct_all(self) -> np.ndarray:
        """Every period's flow completion times pooled into one sample."""
        fs = self.flowsim_reports
        if not fs:
            return np.array([])
        return np.concatenate([f.fct for f in fs])

    def flowsim_summary(self) -> dict[str, Any]:
        """Trace-level flow stats: pooled FCT distribution, worst-period
        CCT, conservation verdict over every period, mean utilization and
        δ-overhead. Raises if the report was built without flowsim."""
        from ..flowsim import FlowStats

        fs = self.flowsim_reports
        if not fs:
            raise ValueError(
                "no flow-level results: run_scenario(..., flowsim=True)"
            )
        stats = FlowStats.from_sample(self.fct_all)
        return {
            "scenario": self.scenario,
            "solver": self.solver,
            "periods": len(fs),
            "flows": int(sum(f.num_flows for f in fs)),
            "completed": int(sum(f.completed for f in fs)),
            "fct_p50": stats.p50,
            "fct_p90": stats.p90,
            "fct_p99": stats.p99,
            "fct_mean": stats.mean,
            "fct_max": stats.max,
            "cct_max": float(max(f.cct for f in fs)),
            "cct_mean": float(np.mean([f.cct for f in fs])),
            "util_mean": float(
                np.mean([f.utilization.mean() for f in fs])
            ),
            "delta_overhead": float(np.mean([f.delta_overhead for f in fs])),
            # Mean per-period switch-time attribution shares (see
            # obs.timeline_table): serve + δ + idle = 1 per switch.
            "delta_share": float(
                np.mean([f.summary()["delta_share"] for f in fs])
            ),
            "idle_share": float(
                np.mean([f.summary()["idle_share"] for f in fs])
            ),
            "indirect_frac": float(
                np.mean([f.indirect_fraction for f in fs])
            ),
            "conserved": bool(all(f.conserved for f in fs)),
            "residual": float(sum(f.residual for f in fs)),
        }

    def summary(self) -> dict[str, Any]:
        """Flat aggregate row (what the smoke lane and benchmarks print).

        When the run carried ``flowsim=True`` the row also gets the
        flow-level headline keys (``fct_p50``/``fct_p99``/``conserved``)
        from ``flowsim_summary()``.
        """
        mk = self.makespans
        row = {
            "scenario": self.scenario,
            "solver": self.solver,
            "periods": self.trace.T,
            "n": self.trace.n,
            "s": self.spec.s,
            "mean_makespan": float(mk.mean()) if len(mk) else float("nan"),
            "max_makespan": float(mk.max()) if len(mk) else float("nan"),
            "geomean_gap": self.geomean_gap,
            "total_cct_s": self.total_cct_s,
            "buckets": self.num_shape_buckets,
            "runtime_s": self.runtime_s,
            # Device-vs-host (or any solver-vs-solver) quality: geomean of
            # per-period makespan ratios against quality_ref; NaN when the
            # run carried no reference.
            "quality_ratio": self.geomean_quality_ratio,
            "quality_ref": self.quality_ref,
        }
        # Degraded solves, visible without digging into per-report extras:
        # total warning count always; the per-category tally when nonzero.
        warnings = self.warning_counters()
        row["warnings"] = warnings.total
        if warnings:
            row["warning_counts"] = warnings.export()
        if self.flowsim_reports:
            fs = self.flowsim_summary()
            row.update(
                fct_p50=fs["fct_p50"],
                fct_p99=fs["fct_p99"],
                conserved=fs["conserved"],
            )
        return row


@dataclass
class OnlinePeriod:
    """One controller period of the *online* (stateful) pass."""

    period: int
    makespan: float            # credit-aware effective makespan
    stateless_makespan: float  # the same period's stateless baseline
    reuse_count: int           # switches serving a carried config δ-free
    delta_paid: float          # δ · (configs − reuse_count)
    delta_avoided: float       # δ · reuse_count
    warm: bool                 # warm-start decomposition used
    num_configs: int
    schedule: Any = None       # ParallelSchedule in reuse serve order
    demand_met: bool | None = None  # online simulator verdict
    # The device scan's own outcome (None on the host controller):
    cache_hit: bool | None = None   # the warm set came from the support cache
    k: int | None = None            # decomposition rounds
    bidding_rounds: int | None = None  # matcher rounds (0 on warm periods)
    host_reads: int | None = None   # synchronizing reads (CUDA, when counted)

    @property
    def ratio(self) -> float:
        """online / stateless makespan (≤ 1 + float tolerance)."""
        return (
            self.makespan / self.stateless_makespan
            if self.stateless_makespan
            else 1.0
        )


@dataclass
class OnlineReport(ScenarioReport):
    """``ScenarioReport`` plus the stateful (online) pass over the trace.

    The base fields describe the stateless per-period solve — the baseline.
    ``online_periods`` carries the stateful controller's outcomes; each
    period's effective makespan is ≤ the stateless makespan by construction.
    """

    online_periods: list[OnlinePeriod] = field(default_factory=list)
    online_runtime_s: float = float("nan")
    online_solver: str = ""          # "host" (controller) or "scan" (device)

    @property
    def online_makespans(self) -> np.ndarray:
        return np.array([p.makespan for p in self.online_periods])

    @property
    def online_ratios(self) -> np.ndarray:
        """Per-period online / stateless makespan ratios."""
        return np.array([p.ratio for p in self.online_periods])

    @property
    def reuse_counts(self) -> np.ndarray:
        return np.array([p.reuse_count for p in self.online_periods])

    @property
    def total_reuse(self) -> int:
        return int(self.reuse_counts.sum())

    @property
    def total_delta_avoided(self) -> float:
        return float(sum(p.delta_avoided for p in self.online_periods))

    @property
    def total_delta_paid(self) -> float:
        return float(sum(p.delta_paid for p in self.online_periods))

    @property
    def total_improvement(self) -> float:
        """Σ_t (stateless − online) makespan over the trace (≥ 0)."""
        return float(
            sum(p.stateless_makespan - p.makespan for p in self.online_periods)
        )

    def online_summary(self) -> dict[str, Any]:
        base = self.summary()
        mk = self.online_makespans
        base.update(
            online_solver=self.online_solver,
            online_mean_makespan=float(mk.mean()) if len(mk) else float("nan"),
            online_total_makespan=float(mk.sum()) if len(mk) else float("nan"),
            stateless_total_makespan=float(
                sum(p.stateless_makespan for p in self.online_periods)
            ),
            total_reuse=self.total_reuse,
            total_delta_avoided=self.total_delta_avoided,
            total_delta_paid=self.total_delta_paid,
            mean_online_ratio=(
                float(self.online_ratios.mean())
                if len(self.online_periods)
                else float("nan")
            ),
            online_runtime_s=self.online_runtime_s,
        )
        return base


# Registry-name sugar: run_scenario(solver="spectra_online[_torch]") implies
# online=True with the matching stateless baseline solver.
_ONLINE_SOLVER_ALIASES = {
    "spectra_online": "spectra",
    "spectra_online_torch": "spectra_torch",
}


def run_scenario(
    scenario: str | Scenario | DemandTrace,
    *,
    solver: str = "spectra",
    options: SolveOptions | None = None,
    simulate: bool = False,
    flowsim: bool = False,
    flowsim_options: Any = None,
    processes: int | None = None,
    quality_ref: str | None = None,
    online: bool = False,
    **overrides: Any,
) -> ScenarioReport:
    """Schedule a whole scenario trace with one batched ``solve_many`` call.

    ``scenario`` is a registered name, a ``Scenario``, or an
    already-materialized ``DemandTrace`` (overrides only apply to the first
    two). Byte traces are normalized trace-globally (one ``unit_s``, one
    δ-in-units) so the batch stays uniform; per-period CCT seconds are
    ``makespan · unit_s``. ``simulate=True`` replays every period through
    ``repro_torch.fabric.simulator`` and records ``demand_met``.
    ``quality_ref`` names a second solver to solve the same trace with, for
    the per-period quality ratios.

    ``flowsim=True`` replays every period at the *flow* level
    (``repro_torch.flowsim.simulate_flows``): each ``PeriodResult.flowsim``
    gets a ``FlowSimReport`` (FCT/CCT distributions, utilization,
    conservation) and the report grows ``flowsim_reports`` / ``fct_all`` /
    ``flowsim_summary()``. Options resolve from ``flowsim_options`` if
    given, else from the spec's ``flowsim_params``; solvers that mark
    ``extras["indirection"]`` (``rotor_vlb``) get 2-hop VLB automatically
    under the default ``indirection="auto"``.

    ``online=True`` (or ``solver="spectra_online[_torch]"``) also runs the
    stateful cross-period controller over the trace — the host
    ``OnlineController`` for host solvers, the device
    ``spectra_online_scan`` for ``spectra_torch`` (on
    ``options.extra["device"]``; with ``options.extra["count_host_reads"]``
    each period's host reads are counted on CUDA) — and returns an
    ``OnlineReport`` whose base fields stay the stateless baseline.
    """
    if isinstance(scenario, DemandTrace):
        if overrides:
            raise TypeError("overrides only apply to named scenarios, not traces")
        trace, name = scenario, f"trace[{scenario.spec.family}]"
    else:
        sc = get_scenario(scenario) if isinstance(scenario, str) else scenario
        trace, name = sc.trace(**overrides), sc.name
    spec = trace.spec
    options = options or SolveOptions()
    if solver in _ONLINE_SOLVER_ALIASES:
        online, solver = True, _ONLINE_SOLVER_ALIASES[solver]

    units, unit_s, delta_units = trace.normalized()
    t0 = time.perf_counter()
    reports = solve_many(
        units, spec.s, delta_units, solver=solver,
        options=options, processes=processes,
    )
    runtime_s = time.perf_counter() - t0

    ref_makespans = [float("nan")] * len(reports)
    if quality_ref is not None:
        ref_reports = solve_many(
            units, spec.s, delta_units, solver=quality_ref,
            options=SolveOptions(validate=False, compute_lb=False),
            processes=processes,
        )
        ref_makespans = [r.makespan for r in ref_reports]

    fs_opts = None
    if flowsim:
        from ..flowsim import FlowSimOptions, simulate_flows

        fs_opts = flowsim_options or FlowSimOptions.from_params(
            spec.flowsim_params
        )

    tracer = get_tracer()
    periods: list[PeriodResult] = []
    for t, rep in enumerate(reports):
        # "install" is the fabric handoff: the point the period's schedule
        # leaves the solver and is replayed/recorded against the switches.
        with tracer.span(
            "period", {"period": t} if tracer.enabled else None
        ), tracer.span("install", {"period": t} if tracer.enabled else None):
            demand_met = None
            if simulate:
                from ..fabric.simulator import simulate as sim

                demand_met = bool(
                    sim(rep, units[t], tol=options.tol(rep.backend)).demand_met
                )
            fs_report = None
            if flowsim:
                fs_report = simulate_flows(rep, units[t], options=fs_opts)
            periods.append(
                PeriodResult(
                    period=t,
                    makespan=rep.makespan,
                    lower_bound=rep.lower_bound,
                    gap=rep.optimality_gap,
                    num_configs=rep.num_configs,
                    cct_s=rep.makespan * unit_s if np.isfinite(unit_s) else float("nan"),
                    meta=dict(trace.period_meta[t]),
                    demand_met=demand_met,
                    ref_makespan=ref_makespans[t],
                    flowsim=fs_report,
                )
            )
    base = dict(
        scenario=name,
        solver=solver,
        spec=spec,
        trace=trace,
        reports=reports,
        periods=periods,
        unit_s=unit_s,
        delta_units=delta_units,
        num_shape_buckets=len(shape_buckets(list(units))),
        runtime_s=runtime_s,
        quality_ref=quality_ref,
        flowsim_options=fs_opts,
    )
    if not online:
        return ScenarioReport(**base)

    online_periods, online_runtime_s, mode = _run_online(
        trace, units, delta_units, reports, options,
        simulate=simulate, solver=solver,
    )
    return OnlineReport(
        **base,
        online_periods=online_periods,
        online_runtime_s=online_runtime_s,
        online_solver=mode,
    )


def _run_online(
    trace: DemandTrace,
    units: np.ndarray,
    delta_units,
    stateless: list[SolveReport],
    options: SolveOptions,
    *,
    simulate: bool,
    solver: str,
) -> tuple[list[OnlinePeriod], float, str]:
    """The stateful pass: host controller loop or device scan.

    Whatever the backend produced, every period is re-priced and clamped
    here against the TRUE stateless baseline (the batched ``stateless``
    reports) along one sequential replay chain: the backend's candidate and
    the stateless schedule with the reuse credit applied post-hoc are both
    evaluated against the *reported* installed state, and the better one is
    kept. This pins ``online ≤ stateless`` per period by construction.
    """
    from ..online import (
        SwitchState,
        advance_installed,
        apply_reuse_order,
        effective_loads,
    )

    spec = trace.spec
    deltas = np.broadcast_to(
        np.asarray(delta_units, dtype=np.float64), (trace.T,)
    )
    device = solver == "spectra_torch"
    t0 = time.perf_counter()
    if device:
        rows = _online_scan_rows(trace, units, deltas, options)
    else:
        rows = _online_host_rows(trace, units, deltas, stateless, options)
    online_runtime_s = time.perf_counter() - t0

    tracer = get_tracer()
    tol = options.tol("torch" if device else "numpy")
    periods: list[OnlinePeriod] = []
    installed = [None] * spec.s  # the reported replay chain
    for t, (sched, _marks, row) in enumerate(rows):
        with tracer.span(
            "online.period", {"period": t} if tracer.enabled else None
        ):
            state = SwitchState(installed=installed)
            cand, cand_marks = apply_reuse_order(sched, state)
            cand_mk = float(effective_loads(cand, cand_marks).max())
            base, base_marks = apply_reuse_order(stateless[t].schedule, state)
            base_mk = float(effective_loads(base, base_marks).max())
            if cand_mk <= base_mk:
                chosen, marks, mk = cand, cand_marks, cand_mk
            else:
                chosen, marks, mk = base, base_marks, base_mk
            reuse_count = int(marks.sum())
            num_configs = chosen.num_configs()
            d = float(deltas[t])
            row = dict(
                row,
                makespan=mk,
                stateless_makespan=float(stateless[t].makespan),
                reuse_count=reuse_count,
                delta_avoided=d * reuse_count,
                delta_paid=d * (num_configs - reuse_count),
                num_configs=num_configs,
            )
            with tracer.span(
                "install", {"period": t} if tracer.enabled else None
            ):
                if options.validate:
                    chosen.validate(units[t], tol=tol)
                demand_met = None
                if simulate:
                    from ..fabric.simulator import simulate as sim

                    demand_met = bool(
                        sim(
                            chosen, units[t], tol=tol, installed=installed
                        ).demand_met
                    )
                installed = advance_installed(chosen, state, marks)
            periods.append(
                OnlinePeriod(
                    period=t,
                    schedule=chosen,
                    demand_met=demand_met,
                    **row,
                )
            )
    return periods, online_runtime_s, "scan" if device else "host"


def _online_host_rows(trace, units, deltas, stateless, options):
    """Host controller over the trace, donating the batched stateless
    schedules/decompositions as the baseline candidates."""
    from ..online import OnlineController

    spec = trace.spec
    ctl = OnlineController(
        s=spec.s,
        delta=float(deltas[0]),
        warm_start=bool(options.extra.get("warm_start", True)),
        warm_slack=float(options.extra.get("warm_slack", 0.05)),
        merge_aware=bool(options.extra.get("merge_aware", False)),
        do_equalize=bool(options.extra.get("equalize", True)),
        cache_size=int(options.extra.get("cache_size", 8)),
    )
    rows = []
    for t in range(trace.T):
        out = ctl.step(
            units[t],
            delta=float(deltas[t]),
            stateless=stateless[t].schedule,
            decomposition=stateless[t].decomposition,
        )
        rows.append(
            (
                out.schedule,
                out.reused_switches,
                dict(
                    makespan=out.makespan,
                    stateless_makespan=out.stateless_makespan,
                    reuse_count=out.reuse_count,
                    delta_paid=out.delta_paid,
                    delta_avoided=out.delta_avoided,
                    warm=out.warm,
                    num_configs=out.num_configs,
                ),
            )
        )
    return rows


def _online_scan_rows(trace, units, deltas, options):
    """Device rolling solve: the whole trace through ``spectra_online_scan``,
    its results copied to the host once."""
    from ..core.schedule_ir import DeviceSchedule
    from ..core.torchopt.matching import default_matcher
    from ..core.torchopt.online_torch import spectra_online_scan
    from ..online import online_ir_to_schedule

    spec = trace.spec
    reads: list | None = [] if options.extra.get("count_host_reads") else None
    res, _ = spectra_online_scan(
        units.astype(np.float32),
        spec.s,
        deltas.astype(np.float32),
        device=options.extra.get("device"),
        do_equalize=bool(options.extra.get("equalize", True)),
        merge_aware=bool(options.extra.get("merge_aware", False)),
        extra_slots=int(options.extra.get("extra_slots", 64)),
        matcher=str(options.extra.get("matcher") or default_matcher(trace.n)),
        repair_rounds=int(options.extra.get("repair_rounds", 0)),
        warm_start=bool(options.extra.get("warm_start", True)),
        warm_prices=bool(options.extra.get("warm_prices", False)),
        warm_slack=float(options.extra.get("warm_slack", 0.05)),
        cache_size=int(options.extra.get("cache_size", 8)),
        host_reads=reads,
    )
    host = {f: getattr(res, f)[0].cpu().numpy() for f in res._fields if f != "schedule"}
    perms, alphas, switch, _ = (x[0].cpu().numpy() for x in res.schedule)
    rows = []
    for t in range(trace.T):
        ds = DeviceSchedule(
            perms=perms[t], alphas=alphas[t].astype(np.float64), switch=switch[t],
            delta=float(deltas[t]),
        )
        sched, marks = online_ir_to_schedule(ds, spec.s, host["reused"][t])
        num_configs = int((switch[t] >= 0).sum())
        rc = int(host["reuse_count"][t])
        rows.append(
            (
                sched,
                marks,
                dict(
                    makespan=float(host["makespan"][t]),
                    stateless_makespan=float(host["stateless_makespan"][t]),
                    reuse_count=rc,
                    delta_paid=float(deltas[t]) * (num_configs - rc),
                    delta_avoided=float(deltas[t]) * rc,
                    warm=bool(host["warm"][t]),
                    num_configs=num_configs,
                    cache_hit=bool(host["cache_hit"][t]),
                    k=int(host["k"][t]),
                    bidding_rounds=int(host["rounds"][t]),
                    host_reads=None if reads is None else reads[t],
                ),
            )
        )
    return rows
