"""Admission control for the scheduling control plane (a copy of
``repro.serve.admission``).

A fabric controller is a shared service: one chatty tenant (a job whose
traffic phase-shifts every period) must not starve the others, and a
backlog must surface as an explicit verdict the client can act on rather
than unbounded queueing delay. The policy here is the standard two-knob
one:

- **Bounded queue** — when the server's queue is at ``max_queue``, new
  work is ``SHED`` (client retries next period with its stale schedule;
  for an OCS that is always safe — the previous circuits stay up).
- **Per-tenant token buckets** — each tenant earns ``rate`` submissions
  per second up to a ``burst`` ceiling. An empty bucket does *not* drop
  the request; it returns ``DEGRADED``: the server still schedules it but
  in the cheaper no-EQUALIZE tier, so over-rate tenants pay the quality
  cost of their own burstiness instead of inflating everyone's latency.

Verdicts are plain strings (``"ADMIT" | "DEGRADED" | "SHED"``) so they
serialize into metrics and reports without an enum dance. Time is passed
in explicitly (``now``) — the server uses a monotonic clock, tests use a
virtual one; the controller never reads a wall clock itself.
"""

from __future__ import annotations

from dataclasses import dataclass, field

ADMIT = "ADMIT"
DEGRADED = "DEGRADED"
SHED = "SHED"
VERDICTS = (ADMIT, DEGRADED, SHED)


@dataclass
class TokenBucket:
    """Classic token bucket: ``rate`` tokens/sec, capacity ``burst``.

    Starts full. ``try_take`` refills lazily from the elapsed time, then
    takes one token if available. Deterministic given the ``now`` values
    passed in; never reads a clock.
    """

    rate: float
    burst: float
    tokens: float = field(default=-1.0)
    _last: float = field(default=None)  # type: ignore[assignment]

    def __post_init__(self) -> None:
        if self.rate < 0 or self.burst <= 0:
            raise ValueError(
                f"need rate >= 0 and burst > 0, got {self.rate}, {self.burst}"
            )
        if self.tokens < 0:
            self.tokens = float(self.burst)

    def _refill(self, now: float) -> None:
        if self._last is None:
            self._last = now
            return
        dt = max(0.0, now - self._last)
        self._last = now
        self.tokens = min(self.burst, self.tokens + dt * self.rate)

    def try_take(self, now: float, amount: float = 1.0) -> bool:
        self._refill(now)
        if self.tokens >= amount:
            self.tokens -= amount
            return True
        return False


@dataclass
class AdmissionController:
    """Queue-bound + per-tenant-rate admission policy.

    ``admit(tenant, queue_depth, now)`` returns a verdict string. Shedding
    is checked first (a full queue is a server-wide condition; burning a
    tenant's token for work that is dropped anyway would double-charge
    it), then the tenant's bucket decides ADMIT vs DEGRADED. Buckets are
    created lazily per tenant with the shared ``rate``/``burst`` defaults;
    ``set_tenant_rate`` pins a tenant-specific one.
    """

    rate: float = 100.0
    burst: float = 20.0
    max_queue: int = 64
    buckets: dict[str, TokenBucket] = field(default_factory=dict)

    def bucket(self, tenant: str) -> TokenBucket:
        b = self.buckets.get(tenant)
        if b is None:
            b = self.buckets[tenant] = TokenBucket(self.rate, self.burst)
        return b

    def set_tenant_rate(self, tenant: str, rate: float, burst: float) -> None:
        self.buckets[tenant] = TokenBucket(rate, burst)

    def admit(self, tenant: str, queue_depth: int, now: float) -> str:
        if queue_depth >= self.max_queue:
            return SHED
        if not self.bucket(tenant).try_take(now):
            return DEGRADED
        return ADMIT
