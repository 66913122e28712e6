"""The paper's evaluation workloads (§V-A) and the permutations family.

Copies of ``repro.traffic.workloads`` and of the ``permutations`` scenario
family (``repro.scenarios.library``), so the port can build real demand
without the reference package. The same seed gives the same matrix.

1. ``gpt3b_workload``     32×32, sparse, skewed, doubly stochastic: GPT-3B
   under the DeepSpeed 3D mapping (TP innermost, then PP, then DP).
2. ``moe_workload``       64×64 Qwen2-57B-style expert routing: dense, near
   uniform with mild column skew.
3. ``benchmark_workload`` the standard 100×100 benchmark: m = 16 permutation
   flows per port (4 large carry 70%, 12 small 30%) plus 0.3% noise.
4. ``permutations_workload`` a sum of k random permutations with weights in
   [floor, 1 + floor) — the pod-scale (n = 512, 1024) instances.
"""

from __future__ import annotations

import numpy as np

from .collectives import Placement, TrafficModel, add_noise, normalize_max_line, sinkhorn


def gpt3b_workload(
    *,
    noise: float = 0.003,
    rng: np.random.Generator | None = None,
    tp: int = 4,
    pp: int = 4,
    dp: int = 2,
    tp_bytes: float = 10.0,
    pp_bytes: float = 3.0,
    dp_bytes: float = 1.0,
    emb_bytes: float = 2.0,
    bg_flows: int = 4,
    bg_bytes: float = 0.25,
) -> np.ndarray:
    """32×32 (tp·pp·dp GPUs, one per rack port) GPT-3B traffic."""
    rng = rng or np.random.default_rng(0)
    n = tp * pp * dp
    tm = TrafficModel(Placement(num_chips=n, chips_per_rack=1))

    def rank(d: int, p: int, t: int) -> int:
        return d * (pp * tp) + p * tp + t

    for d in range(dp):
        for p in range(pp):
            tm.ring_allreduce([rank(d, p, t) for t in range(tp)], tp_bytes)
            if p + 1 < pp:  # PP activations forward, gradients back
                for t in range(tp):
                    tm.p2p(rank(d, p, t), rank(d, p + 1, t), pp_bytes)
                    tm.p2p(rank(d, p + 1, t), rank(d, p, t), pp_bytes)
        if emb_bytes > 0 and pp > 1:  # tied embedding sync, first ↔ last stage
            for t in range(tp):
                tm.ring_allreduce([rank(d, 0, t), rank(d, pp - 1, t)], emb_bytes)
    for p in range(pp):  # DP gradient all-reduce
        for t in range(tp):
            tm.ring_allreduce([rank(d, p, t) for d in range(dp)], dp_bytes)
    for i in range(n):  # background small flows: the measured long tail
        others = np.array([x for x in range(n) if x != i])
        for j in rng.choice(others, size=bg_flows, replace=False):
            tm.p2p(i, int(j), bg_bytes * (0.5 + rng.random()))
    return add_noise(sinkhorn(tm.demand_bytes), noise, rng)


def moe_workload(
    *,
    n: int = 64,
    top_k: int = 6,
    tokens_per_gpu: int = 8192,
    skew: float = 0.25,
    noise: float = 0.0,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """64×64 MoE expert-routing demand (token counts, normalized)."""
    rng = rng or np.random.default_rng(0)
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


def benchmark_workload(
    *,
    n: int = 100,
    m: int = 16,
    num_big: int = 4,
    big_frac: float = 0.7,
    noise: float = 0.003,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Standard benchmark: m permutation flows per port (4 big / 12 small)."""
    rng = rng or np.random.default_rng(0)
    if m < num_big:
        raise ValueError("m must be at least num_big")
    D = np.zeros((n, n), dtype=np.float64)
    big_w = big_frac / num_big
    small_w = (1.0 - big_frac) / max(m - num_big, 1)
    for f in range(m):
        w = big_w if f < num_big else small_w
        D[np.arange(n), rng.permutation(n)] += w
    return add_noise(D, noise, rng)


def permutations_workload(
    *,
    n: int,
    k: int = 16,
    weight_floor: float = 0.05,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Sum of k random permutations with weights in [floor, 1 + floor)."""
    rng = rng or np.random.default_rng(0)
    D = np.zeros((n, n), dtype=np.float64)
    for _ in range(k):
        D[np.arange(n), rng.permutation(n)] += rng.random() + weight_floor
    return D


WORKLOADS = {
    "gpt": gpt3b_workload,
    "moe": moe_workload,
    "benchmark": benchmark_workload,
    "permutations": permutations_workload,
}
