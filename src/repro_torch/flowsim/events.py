"""The discrete-event flow replay: circuits × queues → per-flow FCTs (a copy
of ``repro.flowsim.events``).

Event model
-----------
``fabric.timeline.build_timeline`` turns the schedule into absolute
circuit serve windows (δ reconfiguration gaps between them — the same
timing the matrix-level simulator asserts against). Window boundaries are
the event times: between two consecutive boundaries the set of up
circuits is fixed, so the engine walks intervals in time order and lets
each active circuit spend its capacity ``(t1 − t0) · line_rate``
sequentially on, in priority order:

1. **relay** — indirect bytes parked at the source by an earlier VLB
   hop-1, destined to this window's output (RotorNet's "old indirect
   first", which guarantees buffers drain);
2. **direct** — the window's own (src → dst) VOQ;
3. **hop-1 injection** (VLB only) — leftover capacity detours other
   destinations' bytes to this output's buffer, throttled by its free
   space; arrivals commit at the window boundary (store-and-forward), so
   no byte rides two circuits in one instant.

Circuits are processed in deterministic (switch, slot) order and debit
shared queues immediately, so two windows can never serve the same byte.
With ``options.arrival="uniform"`` each flow is released at a uniform
time inside the period instead of at t=0; a circuit serves a flow only
from ``max(window position, release)``, forfeiting the capacity before
it, and VLB may not detour bytes that have not been released yet.
Completion times are stamped mid-window at the exact chunk end — the
engine knows when each byte lands because service within a window is
sequential.
"""

from __future__ import annotations

import numpy as np

from ..fabric.timeline import Timeline, build_timeline
from .buffers import FabricBuffers
from .flows import FlowTable, flows_from_demand
from .indirection import vlb_injections
from .report import FlowSimOptions, FlowSimReport, FlowStats

__all__ = ["simulate_flows"]

_EPS = 1e-15


def _resolve_indirection(sched, options: FlowSimOptions) -> str:
    """``"auto"`` → whatever the solver's report requests (default off)."""
    if options.indirection != "auto":
        return options.indirection
    extras = getattr(sched, "extras", None) or {}
    return "vlb" if extras.get("indirection") == "vlb" else "none"


def _port_windows_ok(tl: Timeline, tol: float) -> bool:
    """No switch may have two serve windows up at one instant."""
    for h in range(tl.s):
        ws = sorted(
            (w for w in tl.windows if w.switch == h), key=lambda w: w.start
        )
        for prev, nxt in zip(ws, ws[1:]):
            if nxt.start < prev.end - tol:
                return False
    return True


def simulate_flows(
    sched,
    D: np.ndarray,
    *,
    options: FlowSimOptions | None = None,
    installed=None,
) -> FlowSimReport:
    """Flow-level replay of ``sched`` (or anything carrying ``.schedule``)
    against demand ``D``; see the module doc for the event model.

    ``installed`` is the online controller's carried per-switch
    configuration (δ-free first slot), identical to the matrix simulator's
    parameter. The report's ``finish_time`` is the shared timeline's
    finish — by construction the same number ``fabric.simulator.simulate``
    asserts equals the schedule's claimed makespan.
    """
    options = options or FlowSimOptions()
    vlb = _resolve_indirection(sched, options) == "vlb"
    tol = options.resolve_tol(sched)
    D = np.asarray(D, dtype=np.float64)
    tl = build_timeline(sched, installed=installed, tol=tol)
    n = D.shape[0]
    for w in tl.windows:
        if len(w.perm) != n:
            raise AssertionError("configuration is not a permutation")

    flows = FlowTable(flows_from_demand(D, tol=_EPS), tol=tol)
    staggered = options.arrival == "uniform"
    if staggered:
        # Releases are drawn per flow in the FlowTable's (row-major) order,
        # so a fixed seed reproduces the same arrival pattern exactly.
        rng = np.random.default_rng(options.arrival_seed)
        horizon = options.arrival_span * tl.finish
        for f in flows.flows:
            f.release = float(rng.uniform(0.0, horizon)) if horizon > 0 else 0.0
    buffers = FabricBuffers(D, buffer_limit=options.buffer_limit)
    rate = options.line_rate
    busy = np.zeros(tl.s, dtype=np.float64)
    port_ok = _port_windows_ok(tl, tol)

    # Interval decomposition: windows never straddle a boundary, so a
    # window is active on [idx(start), idx(end)) of the boundary grid.
    bounds = sorted({w.start for w in tl.windows} | {w.end for w in tl.windows})
    index = {t: i for i, t in enumerate(bounds)}
    active: list[list] = [[] for _ in range(max(len(bounds) - 1, 0))]
    for w in sorted(tl.windows, key=lambda w: (w.switch, w.slot)):
        for i in range(index[w.start], index[w.end]):
            active[i].append(w)

    for i, circuits in enumerate(active):
        t0, t1 = bounds[i], bounds[i + 1]
        span = t1 - t0
        if span <= 0 or not circuits:
            continue
        for w in circuits:
            h = w.switch
            # A window holds n simultaneous circuits — one per (src,
            # perm[src]) port pair — each serving independently at line
            # rate, so every pair gets its own capacity budget.
            for src in range(n):
                dst = int(w.perm[src])
                cap = span * rate
                used = 0.0
                # 1. relay: forward bytes parked here for this output.
                queue = buffers.relay_queue(src, dst)
                for origin in list(queue):
                    if cap - used <= _EPS:
                        break
                    x = buffers.take_relay(src, dst, origin, cap - used)
                    if x <= 0:
                        continue
                    used += x
                    t_land = min(t0 + used / rate, t1)
                    flows.deliver(origin, dst, x, t_land, indirect=True)
                # 2. direct: this circuit's own VOQ.
                if cap - used > _EPS:
                    if not staggered:
                        x = buffers.take_direct(src, dst, cap - used)
                        if x > 0:
                            used += x
                            t_land = min(t0 + used / rate, t1)
                            flows.deliver(src, dst, x, t_land)
                    else:
                        # Service can't start before the flow's release;
                        # window capacity before it is forfeited.
                        f = flows.get(src, dst)
                        rel = f.release if f is not None else 0.0
                        start = max(t0 + used / rate, rel)
                        budget = min(cap - used, (t1 - start) * rate)
                        if budget > _EPS:
                            x = buffers.take_direct(src, dst, budget)
                            if x > 0:
                                used += x
                                t_land = min(start + x / rate, t1)
                                flows.deliver(src, dst, x, t_land)
                # 3. VLB hop-1: detour other destinations with the leftover.
                if vlb and cap - used > _EPS:
                    for d, want in vlb_injections(
                        buffers, src, dst, cap - used
                    ):
                        if staggered:
                            fd = flows.get(src, d)
                            # Unreleased bytes can't be detoured either.
                            if fd is not None and fd.release > t0:
                                continue
                        x = buffers.take_direct(src, d, want)
                        if x <= 0:
                            continue
                        buffers.stage_arrival(dst, src, d, x)
                        used += x
                busy[h] += used / rate
        buffers.commit()  # staged hop-1 arrivals become forwardable

    fct = flows.fct_array()
    arrays = flows.arrays()
    residual = buffers.direct_total() + buffers.buffered_total()
    num_flows = len(flows.flows)
    conserved = bool(np.isfinite(fct).all()) and residual <= tol * max(
        1, num_flows
    )
    finish = tl.finish
    if finish > 0:
        # A switch exposes n port-pairs at once, so its busy time is the
        # summed per-pair transfer time out of n · finish available.
        utilization = busy / (n * finish)
        delta_fraction = tl.delta_time() / finish
        delta_overhead = float(tl.delta_time().sum() / (tl.s * finish))
    else:
        utilization = np.zeros(tl.s)
        delta_fraction = np.zeros(tl.s)
        delta_overhead = 0.0
    return FlowSimReport(
        finish_time=finish,
        fct=fct,
        flow_src=arrays["flow_src"],
        flow_dst=arrays["flow_dst"],
        flow_size=arrays["flow_size"],
        delivered=arrays["delivered"],
        fct_stats=FlowStats.from_sample(fct),
        cct=float(fct.max()) if num_flows else 0.0,
        utilization=utilization,
        delta_fraction=delta_fraction,
        delta_overhead=delta_overhead,
        conserved=conserved,
        residual=float(residual),
        port_ok=port_ok,
        indirected=float(sum(f.indirected for f in flows.flows)),
        options=options,
        extras={
            "vlb": vlb,
            "windows": len(tl.windows),
            "intervals": len(active),
            **(
                {
                    "arrival": options.arrival,
                    "releases": np.array(
                        [f.release for f in flows.flows], dtype=np.float64
                    ),
                }
                if staggered
                else {}
            ),
        },
    )
