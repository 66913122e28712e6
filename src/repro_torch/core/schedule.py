"""Host schedule objects: one switch's (permutation, weight) sequence and
the parallel schedule over s switches, with the Eq. 3 coverage check; and
SCHEDULE (Alg. 3), the LPT placement of weighted permutations on s switches
with a setup cost δ per permutation.

A copy of ``repro.core.schedule``, kept here so the port depends on nothing
of the reference package.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field

import numpy as np

from .decompose import Decomposition


@dataclass
class SwitchSchedule:
    """One OCS's schedule: a sequence of (permutation, weight) pairs."""

    perms: list[np.ndarray] = field(default_factory=list)
    alphas: list[float] = field(default_factory=list)

    def load(self, delta: float) -> float:
        return float(sum(self.alphas) + delta * len(self.alphas))

    def longest(self) -> int:
        """Index of the longest-duration permutation (-1 if empty)."""
        if not self.alphas:
            return -1
        return int(np.argmax(self.alphas))


@dataclass
class ParallelSchedule:
    """Schedules for s parallel switches plus the reconfiguration delay."""

    switches: list[SwitchSchedule]
    delta: float

    @property
    def s(self) -> int:
        return len(self.switches)

    def loads(self) -> np.ndarray:
        return np.array([sw.load(self.delta) for sw in self.switches])

    def makespan(self) -> float:
        return float(self.loads().max()) if self.switches else 0.0

    def num_configs(self) -> int:
        return sum(len(sw.perms) for sw in self.switches)

    def coverage(self, n: int) -> np.ndarray:
        out = np.zeros((n, n), dtype=np.float64)
        rows = np.arange(n)
        for sw in self.switches:
            for perm, a in zip(sw.perms, sw.alphas):
                out[rows, perm] += a
        return out

    def validate(self, D: np.ndarray, tol: float = 1e-9) -> None:
        """Raise unless the schedules cover D (Eq. 3) with nonnegative weights."""
        D = np.asarray(D)
        for sw in self.switches:
            for a in sw.alphas:
                if a < -tol:
                    raise AssertionError(f"negative weight {a}")
        cov = self.coverage(D.shape[0])
        gap = float((D - cov).max())
        if gap > tol:
            raise AssertionError(f"schedule does not cover D: max gap {gap}")


def schedule_lpt(dec: Decomposition, s: int, delta: float) -> ParallelSchedule:
    """Alg. 3: sort by non-increasing weight, greedily place on least-loaded."""
    if s < 1:
        raise ValueError("need at least one switch")
    order = np.argsort(-np.asarray(dec.alphas), kind="stable")
    switches = [SwitchSchedule() for _ in range(s)]
    # (load, switch index) min-heap — ties broken by lowest index, as in Alg.3.
    heap = [(0.0, h) for h in range(s)]
    heapq.heapify(heap)
    for i in order:
        load, h = heapq.heappop(heap)
        switches[h].perms.append(dec.perms[i])
        switches[h].alphas.append(float(dec.alphas[i]))
        heapq.heappush(heap, (load + delta + float(dec.alphas[i]), h))
    return ParallelSchedule(switches=switches, delta=delta)
