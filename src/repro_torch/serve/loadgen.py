"""Open-loop load generation for the scheduling control plane (a copy of
``repro.serve.loadgen``).

Serving benchmarks need *open-loop* arrivals — requests land on the
server at the times a Poisson process dictates, whether or not the server
has kept up — because closed-loop drivers (submit, wait, repeat) hide
queueing collapse: an overloaded closed-loop server just slows the
client down, while an open-loop one exposes the growing queue, the p99,
and the shed verdicts. CISCO/operator traffic studies and every serving
benchmark (e.g. the LLM serving literature) use open-loop for exactly
this reason.

A ``TenantLoad`` is one tenant's Poisson arrival rate plus the scenario
family its demand matrices are drawn from (``moe_phases`` gives the
phase-cycling traffic the schedule cache serves; ``uniform`` /
``permutations`` give cache-hostile fresh structure). ``make_workload``
merges the tenants' arrival processes into one time-ordered request
list; ``run_open_loop`` replays it against a ``ScheduleServer`` in real
time — submitting strictly by the arrival clock, pumping the server's
double-buffered loop in between — and returns the server's metrics.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Mapping

import numpy as np

from ..scenarios.registry import get_family
from ..scenarios.spec import TrafficSpec


@dataclass(frozen=True)
class TenantLoad:
    """One tenant's offered load: Poisson ``rate`` req/s of ``family``."""

    tenant: str
    rate: float  # mean arrivals per second
    n: int
    family: str = "moe_phases"
    seed: int = 0
    params: Mapping[str, object] = field(default_factory=dict)


@dataclass(frozen=True)
class Arrival:
    t: float  # seconds from workload start
    tenant: str
    D: np.ndarray


def poisson_arrivals(
    rate: float, duration: float, rng: np.random.Generator
) -> np.ndarray:
    """Arrival times of a Poisson(rate) process on [0, duration)."""
    if rate <= 0 or duration <= 0:
        return np.empty((0,))
    # Exponential gaps; draw with headroom, then trim to the horizon.
    est = max(8, int(rate * duration * 2 + 10))
    gaps = rng.exponential(1.0 / rate, size=est)
    times = np.cumsum(gaps)
    while times[-1] < duration:  # pragma: no cover - headroom almost always enough
        more = np.cumsum(rng.exponential(1.0 / rate, size=est)) + times[-1]
        times = np.concatenate([times, more])
    return times[times < duration]


def make_workload(
    tenants: list[TenantLoad],
    duration: float,
    *,
    s: int = 4,
    delta: float = 0.01,
    seed: int = 0,
) -> list[Arrival]:
    """Merge per-tenant Poisson processes into one time-ordered workload.

    The k-th arrival of a tenant carries that tenant's period-k demand
    matrix from its scenario family, so phase-cycling families cycle at
    the tenant's own arrival cadence — exactly the traffic a per-tenant
    schedule cache should serve.
    """
    arrivals: list[Arrival] = []
    for i, tl in enumerate(tenants):
        rng = np.random.default_rng(seed * 1009 + 31 * i + tl.seed)
        times = poisson_arrivals(tl.rate, duration, rng)
        spec = TrafficSpec(
            family=tl.family,
            n=tl.n,
            s=s,
            delta=delta,
            periods=max(1, len(times)),
            seed=tl.seed,
            params=dict(tl.params),
        )
        fam = get_family(tl.family)
        for k, t in enumerate(times):
            demand_rng = np.random.default_rng(
                (seed * 1009 + 31 * i + tl.seed) * 100003 + k
            )
            D, _meta = fam(spec, k, demand_rng)
            arrivals.append(Arrival(t=float(t), tenant=tl.tenant, D=D))
    arrivals.sort(key=lambda a: a.t)
    return arrivals


def tiny_profile(n: int = 8, rate: float = 40.0) -> list[TenantLoad]:
    """CI-sized single-shape profile: one cache-friendly phase-cycling
    tenant plus one cache-hostile tenant at the same n."""
    return [
        TenantLoad("moe-a", rate=rate * 0.6, n=n, family="moe_phases",
                   seed=1, params={"phases": 2}),
        TenantLoad("adhoc", rate=rate * 0.4, n=n, family="uniform", seed=2),
    ]


def mixed_profile(
    n_small: int = 8, n_large: int = 16, rate: float = 30.0
) -> list[TenantLoad]:
    """Mixed-tenant profile with ragged shapes (n_small and n_large)."""
    return [
        TenantLoad("moe-a", rate=rate * 0.4, n=n_small, family="moe_phases",
                   seed=1, params={"phases": 2}),
        TenantLoad("moe-b", rate=rate * 0.3, n=n_large, family="moe_phases",
                   seed=2, params={"phases": 3}),
        TenantLoad("adhoc", rate=rate * 0.3, n=n_small, family="uniform",
                   seed=3),
    ]


def run_open_loop(server, workload: list[Arrival]) -> dict:
    """Replay a workload against a server in real (wall-clock) time.

    Submits each arrival no earlier than its timestamp, pumping the
    server's serving loop whenever there is work and sleeping to the next
    arrival when there is not; drains the pipeline after the last
    arrival (``drain`` also stops the server's device worker). Returns
    ``server.metrics.export()``.
    """
    t0 = time.perf_counter()
    i = 0
    while i < len(workload) or server.has_work():
        now = time.perf_counter() - t0
        while i < len(workload) and workload[i].t <= now:
            a = workload[i]
            server.submit(a.tenant, a.D, now=now)
            i += 1
        if server.has_work():
            server.step()
        elif i < len(workload):
            time.sleep(min(0.05, max(0.0, workload[i].t - now)))
    server.drain()
    return server.metrics.export()


def submit_all(server, workload: list[Arrival]) -> None:
    """Burst-submit a workload (virtual arrival clock, no pacing).

    Used by overload tests: arrival timestamps feed the admission
    controller's token buckets, but nothing waits — the queue bound and
    shed verdicts are exercised immediately.
    """
    for a in workload:
        server.submit(a.tenant, a.D, now=a.t)
