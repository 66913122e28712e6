"""Batched SPECTRA DECOMPOSE + LPT SCHEDULE (PyTorch port).

Counterpart of ``repro.core.jaxopt.decompose_jax``. Every function takes a
leading batch dimension. DECOMPOSE (Alg. 1) calls a matcher from
:mod:`.matching` once per round on the lanes that still have residual
support, with the node-coverage constraint folded into the weights as the
M-bonus; greedy REFINE (Alg. 2) then tops up each round's weight, and
``repair_rounds > 0`` runs the bounded α re-extraction of ``_repair``.

Sums (the M-bonus, coverage with repeated indices) are taken in another
order than XLA's, so decompositions agree with the reference to float32
rounding, not bit for bit. They are taken in a fixed order (coverage round
by round) or in float64 and rounded once (the M-bonus), so the CPU and the
GPU give the same decomposition.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...kernels.auction_bid.ops import ROUNDS_MAX_N, decompose_rounds
from ...kernels.auction_bid.ref import add_at as _add_at, decompose_round_loop, take_at as _take
from ...kernels.backend import resolve_device
from ..decompose import Decomposition
from .matching import (default_max_iters, default_num_phases, eps_table, get_matcher, match_auction,
                       match_auction_fr)


class TorchDecomposition(NamedTuple):
    perms: torch.Tensor      # (B, n, n) int64; row r = permutation of round r
    alphas: torch.Tensor     # (B, n) float32; 0 for padded rounds
    k: torch.Tensor          # (B,) int64: number of real rounds
    converged: torch.Tensor  # (B,) bool: all matcher calls converged
    rounds: torch.Tensor     # (B,) int64: matcher bidding rounds, all calls


def coverage(perms: torch.Tensor, alphas: torch.Tensor, k: torch.Tensor,
             kmax: int | None = None) -> torch.Tensor:
    """Σ_r α_r P_r over each lane's first k rounds, as a (B, n, n) matrix,
    from ``perms`` (B, m, n) and ``alphas`` (B, m), m ≥ max(k).

    Rounds are added one at a time, in round order, so the sum is the same
    on every device and in every run. ``kmax`` is ``max(k)`` where the
    caller has read it already.
    """
    B, m, n = perms.shape
    live = torch.arange(m, device=perms.device)[None, :] < k[:, None]
    al = alphas * live
    out = torch.zeros((B, n, n), dtype=torch.float32, device=perms.device)
    if kmax is None:
        kmax = int(k.max()) if B else 0
    for r in range(kmax):
        out = _add_at(out, perms[:, r], al[:, r])
    return out


def uses_device_loop(match, n: int, device: torch.device) -> bool:
    """Whether DECOMPOSE runs its whole round loop in one ``decompose_rounds``
    launch: on a CUDA device, for 5 ≤ n ≤ 128 (the kernel's shared memory;
    the ε table's identity), with the built-in ``match_auction`` or
    ``match_auction_fr`` as the matcher (the function itself: a matcher
    registered over a built-in name runs in the host loop)."""
    return (torch.device(device).type == "cuda" and 5 <= n <= ROUNDS_MAX_N
            and (match is match_auction or match is match_auction_fr))


def _decompose_rounds(D: torch.Tensor, matcher: str, carry_prices: bool = False,
                      prices0: torch.Tensor | None = None):
    """Alg. 1: matcher rounds until no residual support is left; see
    ``decompose_round_loop`` for the prices and the six results, followed
    here by whether the device loop ran. Where ``uses_device_loop`` holds,
    one kernel launch runs every round, bit for bit the host loop's;
    elsewhere the loop runs on the host, one matcher call a round."""
    match = get_matcher(matcher)
    B, n, _ = D.shape
    if B and uses_device_loop(match, n, D.device):
        p0 = (None if prices0 is None
              else torch.as_tensor(prices0, dtype=torch.float32, device=D.device).expand(B, n).contiguous())
        return *decompose_rounds(D.contiguous(), eps_table(default_num_phases(n), D.device),
                                 default_max_iters(n), reverse=match is match_auction_fr,
                                 carry=carry_prices, prices0=p0), True
    return *decompose_round_loop(D, match, carry_prices, prices0), False


def _refine(D, perms, alphas, k):
    """Alg. 2: greedy REFINE over each lane's first k rounds, given as
    ``perms`` (B, m, n) and ``alphas`` (B, m) with m ≥ max(k); returns the
    (B, m) refined weights."""
    m = alphas.shape[1]
    R = torch.clamp_min(D - coverage(perms, alphas, k, m), 0.0)
    alphas = alphas.clone()
    for r in range(m):
        perm = perms[:, r]
        d = torch.clamp_min(_take(R, perm).amax(dim=1), 0.0)
        d = torch.where(r < k, d, 0.0)
        alphas[:, r] += d
        R = torch.clamp_min(_add_at(R, perm, -d), 0.0)
    return alphas


def _repair(D, perms, alphas, k, repair_rounds: int):
    """Bounded local search on the refined weights: each sweep shrinks every
    α by the minimum coverage slack along its permutation; rounds whose α
    reaches zero are compacted to the tail and dropped from k."""
    B, n, _ = D.shape
    arange = torch.arange(n, device=D.device)
    rounds_left = torch.full((B,), repair_rounds, dtype=torch.int64, device=D.device)
    improved = torch.ones((B,), dtype=torch.bool, device=D.device)
    while True:
        active = improved & (rounds_left > 0)
        if not bool(active.any()):
            break
        slack = coverage(perms, alphas, k) - D
        new = alphas.clone()
        for r in range(int(k.max())):
            perm = perms[:, r]
            d = torch.minimum(_take(slack, perm).amin(dim=1), new[:, r])
            d = torch.where(r < k, torch.clamp_min(d, 0.0), 0.0)
            new[:, r] += -d
            slack = _add_at(slack, perm, -d)
        grew = (new < alphas).any(dim=1)
        alphas = torch.where(active[:, None], new, alphas)
        rounds_left -= active.long()
        improved = torch.where(active, grew, improved)
    live = (alphas > 0) & (arange[None, :] < k[:, None])
    order = torch.argsort((~live).to(torch.int8), dim=1, stable=True)
    perms = torch.gather(perms, 1, order[..., None].expand(B, n, n))
    alphas = torch.gather(torch.where(live, alphas, 0.0), 1, order)
    return perms, alphas, live.sum(dim=1)


def _decompose(D, matcher, repair_rounds, carry_prices, prices0):
    """The decomposition, the final prices, the number of matcher calls
    (``max(k)`` before repair: the round loop's iterations) and whether one
    ``decompose_rounds`` launch ran the round loop."""
    D = D.to(torch.float32)
    perms, alphas, k, conv, rounds, prices, device_loop = _decompose_rounds(D, matcher, carry_prices, prices0)
    calls = int(k.max()) if D.shape[0] else 0  # the one host read before REFINE
    # REFINE sees the rounds that ran; the weights past them stay 0.
    alphas = torch.cat([_refine(D, perms[:, :calls], alphas[:, :calls], k), alphas[:, calls:]], dim=1)
    if repair_rounds:
        perms, alphas, k = _repair(D, perms, alphas, k, repair_rounds)
    return TorchDecomposition(perms, alphas, k, conv, rounds), prices, calls, device_loop


def decompose(
    D: torch.Tensor,
    *,
    matcher: str = "auction",
    repair_rounds: int = 0,
) -> TorchDecomposition:
    """Exactly-k decomposition of each lane of ``D`` (B, n, n): Alg. 1 +
    greedy REFINE (+ ``repair_rounds`` local-search sweeps). Every matcher
    call starts from zero prices."""
    return _decompose(D, matcher, repair_rounds, False, None)[0]


def decompose_prices(
    D: torch.Tensor,
    prices0: torch.Tensor | None,
    *,
    matcher: str = "auction",
    repair_rounds: int = 0,
) -> tuple[TorchDecomposition, torch.Tensor]:
    """Warm-started decomposition, the counterpart of ``decompose_jax_prices``:
    the matcher's prices carry from round to round, round 0 starts from
    ``prices0`` ((n,) or (B, n); None: zeros), and the final (B, n) prices
    come back beside the decomposition for the caller to carry on. Every
    round hands the matcher prices, so ``auction_fused`` enters its ε
    schedule at the tail each round, as the reference's does."""
    return _decompose(D, matcher, repair_rounds, True, prices0)[:2]


def to_decomposition(dec: TorchDecomposition, lane: int = 0) -> Decomposition:
    """One lane as a host ``Decomposition`` (for the host SCHEDULE and
    EQUALIZE stages), read from the device once. Zero-α rounds (possible
    after repair) are dropped: they carry no weight and would only add
    δ-cost configurations to a host schedule."""
    k = int(dec.k[lane])
    perms = dec.perms[lane, :k].cpu().numpy()
    alphas = dec.alphas[lane, :k].cpu().numpy()
    keep = alphas > 0
    return Decomposition(
        perms=[p.astype(np.int64) for p, kp in zip(perms, keep) if kp],
        alphas=[float(a) for a, kp in zip(alphas, keep) if kp],
    )


def lpt_place(alphas, place, loads, delta, assignment, steps: int):
    """Alg. 3's placement loop per lane: the rounds in ``place`` (B, n) in
    non-increasing α order (stable), each onto the least-loaded switch of
    ``loads`` (B, s) (lowest index on ties), each adding δ + α; ``steps`` is
    at least the largest count of rounds to place. Rounds outside ``place``
    keep ``assignment``. Returns ``(assignment, loads)``."""
    B, n = alphas.shape
    dev = alphas.device
    order = torch.argsort(torch.where(place, -alphas, torch.inf), dim=1, stable=True)
    a_sorted = torch.gather(alphas, 1, order)
    real_sorted = torch.gather(place, 1, order)
    placed = torch.full((B, n), -1, dtype=torch.int64, device=dev)
    # Rounds outside `place` sort last, so `steps` covers every real one.
    for t in range(steps):
        h = torch.argmin(loads, dim=1)
        real = real_sorted[:, t]
        add = torch.where(real, delta + a_sorted[:, t], 0.0)
        loads = torch.where(real[:, None], loads.scatter_add(1, h[:, None], add[:, None]), loads)
        placed[:, t] = torch.where(real, h, -1)
    scattered = torch.full((B, n), -1, dtype=torch.int64, device=dev).scatter(1, order, placed)
    return torch.where(place, scattered, assignment), loads


def lpt_schedule(dec: TorchDecomposition, s: int, delta: torch.Tensor):
    """Alg. 3 per lane: returns ``(assignment (B, n), loads (B, s),
    makespan (B,))``; ``delta`` is (B,). Rounds go in non-increasing α order
    (stable), each onto the least-loaded switch (lowest index on ties)."""
    B, n = dec.alphas.shape
    dev = dec.alphas.device
    valid = (torch.arange(n, device=dev)[None, :] < dec.k[:, None]) & (dec.alphas > 0)
    assignment, loads = lpt_place(
        dec.alphas, valid, torch.zeros((B, s), dtype=torch.float32, device=dev), delta,
        torch.full((B, n), -1, dtype=torch.int64, device=dev), int(valid.sum(dim=1).max()) if B else 0,
    )
    return assignment, loads, loads.amax(dim=1)


def spectra_torch(
    D,
    s: int,
    delta,
    *,
    matcher: str = "auction",
    repair_rounds: int = 0,
    device: str | torch.device | None = None,
):
    """DECOMPOSE + LPT for each lane of ``D`` (B, n, n); returns ``(dec,
    assignment (B, n), loads (B, s), makespan (B,))``. ``delta`` is one float
    for the batch or a (B,) vector. ``device=None`` means CUDA and raises
    without a GPU."""
    dev = resolve_device(device)
    D = torch.as_tensor(D, dtype=torch.float32, device=dev)
    deltas = torch.as_tensor(delta, dtype=torch.float32, device=dev).expand(D.shape[0]).contiguous()
    dec = decompose(D, matcher=matcher, repair_rounds=repair_rounds)
    assignment, loads, makespan = lpt_schedule(dec, s, deltas)
    return dec, assignment, loads, makespan
