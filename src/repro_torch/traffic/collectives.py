"""Collective-communication traffic → rack-level demand matrices.

A copy of ``repro.traffic.collectives``. Byte counts per collective follow
the standard ring algorithms:

  ring all-reduce  : each member sends 2(g−1)/g · V to its ring successor
  all-gather / RS  : (g−1)/g · V per member to its successor
  all-to-all       : V/g from every member to every other member
  point-to-point   : V from src to dst

Traffic between chips in one rack never reaches the optical core.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Placement:
    """Maps global chip ids to racks (n racks × chips_per_rack)."""

    num_chips: int
    chips_per_rack: int

    def __post_init__(self) -> None:
        if self.num_chips % self.chips_per_rack:
            raise ValueError("num_chips must be divisible by chips_per_rack")
        self.num_racks = self.num_chips // self.chips_per_rack

    def rack(self, chip: int) -> int:
        return chip // self.chips_per_rack


@dataclass
class TrafficModel:
    """Accumulates chip-to-chip collective traffic into a rack demand matrix."""

    placement: Placement
    demand_bytes: np.ndarray = field(init=False)

    def __post_init__(self) -> None:
        n = self.placement.num_racks
        self.demand_bytes = np.zeros((n, n), dtype=np.float64)

    def _add(self, src_chip: int, dst_chip: int, nbytes: float) -> None:
        a, b = self.placement.rack(src_chip), self.placement.rack(dst_chip)
        if a != b:  # intra-rack traffic stays on the ToR
            self.demand_bytes[a, b] += nbytes

    def p2p(self, src: int, dst: int, nbytes: float) -> None:
        self._add(src, dst, nbytes)

    def ring_allreduce(self, group: list[int], nbytes: float) -> None:
        g = len(group)
        if g < 2:
            return
        per_edge = 2.0 * (g - 1) / g * nbytes
        for i, chip in enumerate(group):
            self._add(chip, group[(i + 1) % g], per_edge)

    def ring_allgather(self, group: list[int], nbytes: float) -> None:
        g = len(group)
        if g < 2:
            return
        per_edge = (g - 1) / g * nbytes
        for i, chip in enumerate(group):
            self._add(chip, group[(i + 1) % g], per_edge)

    ring_reducescatter = ring_allgather  # identical byte profile

    def all_to_all(self, group: list[int], nbytes: float) -> None:
        g = len(group)
        if g < 2:
            return
        per_pair = nbytes / g
        for a in group:
            for b in group:
                if a != b:
                    self._add(a, b, per_pair)

    def weighted_all_to_all(self, group: list[int], matrix_bytes: np.ndarray) -> None:
        """Non-uniform all-to-all (e.g. measured MoE routing), g×g bytes."""
        for i, a in enumerate(group):
            for j, b in enumerate(group):
                if a != b:
                    self._add(a, b, float(matrix_bytes[i, j]))


def sinkhorn(D: np.ndarray, iters: int = 200, tol: float = 1e-10) -> np.ndarray:
    """Scale D (on its support) to doubly stochastic."""
    D = np.asarray(D, dtype=np.float64).copy()
    for _ in range(iters):
        r = D.sum(axis=1, keepdims=True)
        D = np.divide(D, np.maximum(r, 1e-300))
        c = D.sum(axis=0, keepdims=True)
        D = np.divide(D, np.maximum(c, 1e-300))
        if abs(D.sum(1) - 1).max() < tol and abs(D.sum(0) - 1).max() < tol:
            break
    return D


def normalize_max_line(D: np.ndarray) -> np.ndarray:
    """Scale so the max row/col sum is 1 (schedulable in one unit sans δ)."""
    D = np.asarray(D, dtype=np.float64)
    T = max(D.sum(1).max(), D.sum(0).max())
    return D / T if T > 0 else D


def add_noise(D: np.ndarray, sigma: float, rng: np.random.Generator) -> np.ndarray:
    """Gaussian noise of std ``sigma`` on nonzero entries (paper's 0.3%/1%)."""
    D = np.asarray(D, dtype=np.float64).copy()
    nz = D > 0
    D[nz] = np.maximum(D[nz] + rng.normal(0.0, sigma, size=int(nz.sum())), 1e-9)
    return D
