"""The benchmark's one traffic generator: copies of the program's sound
demand generators, driven by a mix's data file.

Copied, number for number, from the PyTorch port's ``traffic/workloads.py``
(``moe_workload``, ``permutations_workload``) and ``scenarios/library.py``
(the ``moe`` and ``permutations`` families), so that a change to the
program cannot change the benchmark's inputs.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

import numpy as np


def normalize_max_line(D: np.ndarray) -> np.ndarray:
    """Scale so the max row/col sum is 1."""
    D = np.asarray(D, dtype=np.float64)
    T = max(D.sum(1).max(), D.sum(0).max())
    return D / T if T > 0 else D


def add_noise(D: np.ndarray, sigma: float, rng: np.random.Generator) -> np.ndarray:
    """Gaussian noise of std ``sigma`` on nonzero entries."""
    D = np.asarray(D, dtype=np.float64).copy()
    nz = D > 0
    D[nz] = np.maximum(D[nz] + rng.normal(0.0, sigma, size=int(nz.sum())), 1e-9)
    return D


def moe_workload(*, n: int = 64, top_k: int = 6, tokens_per_gpu: int = 8192, skew: float = 0.25,
                 noise: float = 0.0, rng: np.random.Generator) -> np.ndarray:
    """MoE expert-routing demand (token counts, normalised to max line sum 1)."""
    pop = 1.0 + skew * np.abs(rng.standard_normal(n))
    pop /= pop.sum()
    D = np.zeros((n, n), dtype=np.float64)
    for src in range(n):
        p = pop.copy()
        p[src] = 0.0  # the local expert never crosses the fabric
        p /= p.sum()
        D[src, :] = rng.multinomial(tokens_per_gpu * top_k, p)
    D = normalize_max_line(D)
    if noise > 0:
        D = add_noise(D, noise, rng)
    return D


def permutations_workload(*, n: int, k: int = 16, weight_floor: float = 0.05,
                          rng: np.random.Generator) -> np.ndarray:
    """Sum of k random permutations with weights in [floor, 1 + floor)."""
    D = np.zeros((n, n), dtype=np.float64)
    for _ in range(k):
        D[np.arange(n), rng.permutation(n)] += rng.random() + weight_floor
    return D


# A family maps (n, tenant seed, params, period t, rng) to one demand matrix.
Family = Callable[[int, int, Mapping[str, Any], int, np.random.Generator], np.ndarray]


def _moe(n, seed, p, t, rng):
    return moe_workload(n=n, top_k=int(p.get("top_k", 6)), tokens_per_gpu=int(p.get("tokens_per_gpu", 8192)),
                        skew=float(p.get("skew", 0.25)), noise=float(p.get("noise", 0.0)), rng=rng)


def _permutations(n, seed, p, t, rng):
    return permutations_workload(n=n, k=int(p.get("k", 16)), weight_floor=float(p.get("weight_floor", 0.05)),
                                 rng=rng)


FAMILIES: dict[str, Family] = {"moe": _moe, "permutations": _permutations}


def closed_loop_matrix(family: str, n: int, params: Mapping[str, Any], seed: int, index: int) -> np.ndarray:
    """Matrix ``index`` of a pool: drawn from ``(seed, index)`` alone, so no
    two indices share one."""
    return FAMILIES[family](n, 0, params, index, np.random.default_rng([seed, index]))


def closed_loop_source(config: Mapping[str, Any], mix: Mapping[str, Any], seed: int) -> Callable[[int], np.ndarray]:
    """Matrix j of a closed-loop run. The mix's ``pool`` of matrices, drawn
    from its own ``pool_seed``, is built here, before the window; the run's
    seed only orders it, and the run cycles through it. Every run, on either
    side of a comparison, solves the same set in the same sequence, however
    many requests its window completes."""
    family, n, params = config["family"], int(config["n"]), config["params"]
    size, pool_seed = int(mix["pool"]), int(mix["pool_seed"])
    pool = [closed_loop_matrix(family, n, params, pool_seed, i) for i in range(size)]
    order = np.random.default_rng([seed, 1]).permutation(size)
    return lambda j: pool[order[j % size]]


def warm_matrices(config: Mapping[str, Any], mix: Mapping[str, Any], count: int) -> list[np.ndarray]:
    """Matrices of the pool's family and shape that the pool does not hold,
    for the warm-up call."""
    family, n, params = config["family"], int(config["n"]), config["params"]
    size, pool_seed = int(mix["pool"]), int(mix["pool_seed"])
    return [closed_loop_matrix(family, n, params, pool_seed, size + b) for b in range(count)]
