"""The host ``Decomposition``: weighted permutations covering a demand
matrix. A copy of the dataclass in ``repro.core.decompose``."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Decomposition:
    """Weighted permutations covering a demand matrix."""

    perms: list[np.ndarray] = field(default_factory=list)  # each perm[i] = col
    alphas: list[float] = field(default_factory=list)

    @property
    def k(self) -> int:
        return len(self.perms)

    def total_weight(self) -> float:
        return float(sum(self.alphas))

    def coverage(self, n: int) -> np.ndarray:
        out = np.zeros((n, n), dtype=np.float64)
        rows = np.arange(n)
        for perm, a in zip(self.perms, self.alphas):
            out[rows, perm] += a
        return out

    def covers(self, D: np.ndarray, tol: float = 1e-9) -> bool:
        return bool(np.all(self.coverage(D.shape[0]) >= np.asarray(D) - tol))
