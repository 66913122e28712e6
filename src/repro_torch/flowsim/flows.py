"""Flows: one per (src, dst) demand entry, with delivery accounting (a copy
of ``repro.flowsim.flows``).

A flow is the unit the FCT distribution is over — all of D[src, dst],
regardless of how many circuit windows (or VLB detours) carry pieces of
it. ``FlowTable`` owns the per-flow delivered counters and stamps the
completion time the instant the last unit reaches the destination.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["Flow", "FlowTable", "flows_from_demand"]


@dataclass
class Flow:
    src: int
    dst: int
    size: float
    delivered: float = 0.0
    indirected: float = 0.0          # units that arrived via a VLB detour
    fct: float = float("inf")        # completion time; inf until complete
    release: float = 0.0             # instant the bytes become sendable

    @property
    def remaining(self) -> float:
        return self.size - self.delivered

    @property
    def complete(self) -> bool:
        return np.isfinite(self.fct)


def flows_from_demand(D: np.ndarray, tol: float = 1e-9) -> list[Flow]:
    """One flow per strictly-positive demand entry (diagonal included —
    intra-rack demand is rare but the matrix-level simulator serves it via
    identity configurations, and the flow view must agree)."""
    D = np.asarray(D, dtype=np.float64)
    srcs, dsts = np.nonzero(D > tol)
    return [Flow(src=int(a), dst=int(b), size=float(D[a, b])) for a, b in zip(srcs, dsts)]


class FlowTable:
    """Index + delivery bookkeeping over the flow list."""

    def __init__(self, flows: list[Flow], tol: float = 1e-9):
        self.flows = flows
        self.tol = tol
        self._by_pair = {(f.src, f.dst): f for f in flows}

    def get(self, src: int, dst: int) -> Flow | None:
        return self._by_pair.get((src, dst))

    def deliver(
        self, src: int, dst: int, amount: float, time: float, *,
        indirect: bool = False,
    ) -> None:
        """Credit ``amount`` units arriving at ``dst`` at ``time``.

        ``time`` is the instant the *last* of the amount lands (the engine
        serves queues sequentially within a window, so it knows exactly
        when each chunk finishes). Completion is stamped when delivered
        reaches the flow size within tolerance.
        """
        if amount <= 0:
            return
        f = self._by_pair[(src, dst)]
        f.delivered += amount
        if indirect:
            f.indirected += amount
        if not f.complete and f.delivered >= f.size - self.tol:
            f.fct = time

    def fct_array(self) -> np.ndarray:
        return np.array([f.fct for f in self.flows], dtype=np.float64)

    def arrays(self) -> dict[str, np.ndarray]:
        return {
            "fct": self.fct_array(),
            "flow_src": np.array([f.src for f in self.flows], dtype=np.int64),
            "flow_dst": np.array([f.dst for f in self.flows], dtype=np.int64),
            "flow_size": np.array([f.size for f in self.flows]),
            "delivered": np.array([f.delivered for f in self.flows]),
        }
