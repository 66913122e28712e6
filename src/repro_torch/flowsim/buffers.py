"""Host-side queues: direct VOQs at sources, finite indirect buffers (a
copy of ``repro.flowsim.buffers``).

Two tiers of queueing, matching the RotorNet host model:

* **direct** — the virtual output queues at each source NIC: remaining
  demand D[src, dst] waiting at src for a (src → dst) circuit (or, under
  VLB, for a hop-1 detour).
* **indirect** — bytes a host holds *for someone else*: hop-1 traffic
  parked at intermediate ``m`` until an ``(m → dst)`` circuit comes up.
  Capped at ``buffer_limit`` units per node; a full buffer throttles
  hop-1 admission, which is how finite host memory pushes back on VLB.

Causality: hop-1 arrivals within a circuit window are *staged* and only
become forwardable when the engine commits them at the window boundary —
store-and-forward at slot granularity, so a byte can never ride two
circuits in the same instant.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["FabricBuffers"]


class FabricBuffers:
    def __init__(self, D: np.ndarray, *, buffer_limit: float = math.inf):
        D = np.asarray(D, dtype=np.float64)
        self.n = D.shape[0]
        self.direct = D.copy()              # (n, n) remaining at source
        self.buffer_limit = float(buffer_limit)
        # indirect[m][dst] -> {src: units} in arrival order (FIFO drain).
        self.indirect: list[dict[int, dict[int, float]]] = [
            {} for _ in range(self.n)
        ]
        self.occupancy = np.zeros(self.n, dtype=np.float64)  # Σ indirect at m
        self._staged: list[tuple[int, int, int, float]] = []  # (m, src, dst, x)

    # -- direct tier --------------------------------------------------------

    def take_direct(self, src: int, dst: int, amount: float) -> float:
        """Remove up to ``amount`` units from the (src, dst) VOQ."""
        x = min(float(self.direct[src, dst]), amount)
        if x <= 0:
            return 0.0
        self.direct[src, dst] -= x
        return x

    # -- indirect tier ------------------------------------------------------

    def free_space(self, m: int) -> float:
        """Admissible hop-1 units at node ``m`` (staged arrivals count
        against the cap immediately, so concurrent windows can't jointly
        overcommit the buffer)."""
        return max(self.buffer_limit - float(self.occupancy[m]), 0.0)

    def stage_arrival(self, m: int, src: int, dst: int, amount: float) -> None:
        """Park hop-1 units at ``m``; forwardable only after ``commit``."""
        if amount <= 0:
            return
        self._staged.append((m, src, dst, amount))
        self.occupancy[m] += amount

    def commit(self) -> None:
        """Window boundary: staged arrivals become forwardable."""
        for m, src, dst, x in self._staged:
            per_dst = self.indirect[m].setdefault(dst, {})
            per_dst[src] = per_dst.get(src, 0.0) + x
        self._staged.clear()

    def relay_queue(self, m: int, dst: int) -> dict[int, float]:
        """Forwardable units at ``m`` destined ``dst``, by origin (FIFO)."""
        return self.indirect[m].get(dst, {})

    def take_relay(self, m: int, dst: int, src: int, amount: float) -> float:
        """Remove up to ``amount`` relay units (m, src→dst) for delivery."""
        queue = self.indirect[m].get(dst)
        if not queue or src not in queue:
            return 0.0
        x = min(queue[src], amount)
        if x <= 0:
            return 0.0
        queue[src] -= x
        self.occupancy[m] -= x
        if queue[src] <= 1e-15:
            del queue[src]
        if not queue:
            del self.indirect[m][dst]
        return x

    # -- accounting ---------------------------------------------------------

    def buffered_total(self) -> float:
        """Units parked (or staged) anywhere in the fabric's buffers."""
        return float(self.occupancy.sum())

    def direct_total(self) -> float:
        return float(self.direct.sum())
