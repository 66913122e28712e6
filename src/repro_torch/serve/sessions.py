"""Per-tenant stateful sessions for the scheduling control plane (a copy of
``repro.serve.sessions``; the default solver is ``spectra_online_torch``).

A tenant here is one training job (or one pod's collective group): its
demand evolves period to period, so its switch state — installed
configurations, warm-start permutations, auction prices, and the
device-side support-pattern cache — must persist *per tenant*, never
shared. ``TenantSession`` wraps the stateful ``OnlineSession`` with the
serving knobs threaded through ``SolveOptions.extra`` (``cache_size`` for
the device cache carried in the scan state, ``warm_prices`` for auction
price reuse) and keeps the per-tenant reuse accounting the metrics layer
reports.

``SessionManager`` owns the tenant → session map and drains pending
per-tenant demands in round-robin order, so one tenant submitting a burst
of periods cannot starve the rest — the fairness half of admission
control, applied to the stateful path. Sessions with different fabric
sizes n coexist (ragged shape buckets): each session's state is its own,
and each session's device state has its own (n, s) shape.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np

from ..api import SolveOptions, SolveReport
from .engine import OnlineSession


def _online_options(
    base: SolveOptions,
    *,
    cache_size: int,
    warm_prices: bool,
) -> SolveOptions:
    extra = dict(base.extra)
    extra.setdefault("cache_size", int(cache_size))
    extra.setdefault("warm_prices", bool(warm_prices))
    return SolveOptions(
        validate=base.validate,
        validate_tol=base.validate_tol,
        compute_lb=base.compute_lb,
        extra=extra,
    )


@dataclass
class TenantSession:
    """One tenant's always-on scheduling session.

    Thin stateful wrapper: ``step`` schedules one controller period
    against the carried state; ``stats`` summarizes how much of the work
    was served from reuse (warm decompositions, device cache hits, δ
    avoided) — the quantities the serving metrics export per tenant.
    """

    tenant: str
    s: int
    delta: float
    solver: str = "spectra_online_torch"
    cache_size: int = 8
    warm_prices: bool = False
    options: SolveOptions = field(default_factory=SolveOptions)

    def __post_init__(self) -> None:
        self._session = OnlineSession(
            s=self.s,
            delta=self.delta,
            solver=self.solver,
            options=_online_options(
                self.options,
                cache_size=self.cache_size,
                warm_prices=self.warm_prices,
            ),
        )
        self.pending: deque[np.ndarray] = deque()

    def __len__(self) -> int:
        return len(self._session)

    @property
    def reports(self) -> list[SolveReport]:
        return self._session.reports

    @property
    def state(self):
        return self._session.state

    def step(self, D: np.ndarray) -> SolveReport:
        return self._session.step(D)

    def stats(self) -> dict:
        reps = self.reports
        n = len(reps)
        warm = sum(bool(r.extras.get("warm", False)) for r in reps)
        cache = sum(bool(r.extras.get("cache_hit", False)) for r in reps)
        return {
            "tenant": self.tenant,
            "periods": n,
            "warm": warm,
            "warm_rate": warm / n if n else float("nan"),
            "device_cache_hits": cache,
            "device_cache_hit_rate": cache / n if n else float("nan"),
            "delta_avoided": self._session.total_delta_avoided,
        }


class SessionManager:
    """Tenant → session registry with round-robin fair draining.

    ``submit`` queues one period of demand for a tenant (opening its
    session on first sight); ``drain_round`` serves at most one queued
    period per tenant, cycling from wherever the previous round stopped,
    and returns the ``(tenant, report)`` pairs served. Stateful periods
    are inherently sequential per tenant, so fairness — not batching — is
    the scheduling lever on this path.
    """

    def __init__(
        self,
        s: int,
        delta: float,
        *,
        solver: str = "spectra_online_torch",
        cache_size: int = 8,
        warm_prices: bool = False,
        options: SolveOptions | None = None,
    ) -> None:
        self.s = int(s)
        self.delta = float(delta)
        self.solver = solver
        self.cache_size = int(cache_size)
        self.warm_prices = bool(warm_prices)
        self.options = options or SolveOptions()
        self.sessions: dict[str, TenantSession] = {}
        self._order: list[str] = []
        self._rr = 0

    def session(self, tenant: str) -> TenantSession:
        sess = self.sessions.get(tenant)
        if sess is None:
            sess = TenantSession(
                tenant=tenant,
                s=self.s,
                delta=self.delta,
                solver=self.solver,
                cache_size=self.cache_size,
                warm_prices=self.warm_prices,
                options=self.options,
            )
            self.sessions[tenant] = sess
            self._order.append(tenant)
        return sess

    def submit(self, tenant: str, D: np.ndarray) -> None:
        self.session(tenant).pending.append(np.asarray(D, dtype=np.float64))

    @property
    def backlog(self) -> int:
        return sum(len(s.pending) for s in self.sessions.values())

    def drain_round(self) -> list[tuple[str, SolveReport]]:
        served: list[tuple[str, SolveReport]] = []
        k = len(self._order)
        for i in range(k):
            tenant = self._order[(self._rr + i) % k]
            sess = self.sessions[tenant]
            if sess.pending:
                served.append((tenant, sess.step(sess.pending.popleft())))
        self._rr = (self._rr + 1) % k if k else 0
        return served

    def drain(self) -> list[tuple[str, SolveReport]]:
        """Drain every queued period, one fair round at a time."""
        out: list[tuple[str, SolveReport]] = []
        while self.backlog:
            out.extend(self.drain_round())
        return out

    def stats(self) -> dict:
        return {t: s.stats() for t, s in self.sessions.items()}
