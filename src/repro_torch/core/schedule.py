"""Host schedule objects: one switch's (permutation, weight) sequence and
the parallel schedule over s switches, with the Eq. 3 coverage check.

A copy of the same classes in ``repro.core.schedule``, kept here so the
port depends on nothing of the reference package.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


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
