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

import torch

from .matching import get_matcher


class TorchDecomposition(NamedTuple):
    perms: torch.Tensor      # (B, n, n) int64; row r = permutation of round r
    alphas: torch.Tensor     # (B, n) float32; 0 for padded rounds
    k: torch.Tensor          # (B,) int64: number of real rounds
    converged: torch.Tensor  # (B,) bool: all matcher calls converged
    rounds: torch.Tensor     # (B,) int64: matcher bidding rounds, all calls


def _take(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """x[b, i, perm[b, i]] for (B, n, n) x and (B, n) perm."""
    return torch.gather(x, 2, perm[..., None])[..., 0]


def _add_at(x: torch.Tensor, perm: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """x[b, i, perm[b, i]] += v[b] (the indices of one lane are distinct)."""
    return x.scatter_add(2, perm[..., None], v[:, None, None].expand(-1, x.shape[1], 1))


def coverage(perms: torch.Tensor, alphas: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Σ_r α_r P_r over each lane's first k rounds, as a (B, n, n) matrix.

    Rounds are added one at a time, in round order, so the sum is the same
    on every device and in every run.
    """
    B, n, _ = perms.shape
    live = torch.arange(n, device=perms.device)[None, :] < k[:, None]
    al = alphas * live
    out = torch.zeros((B, n, n), dtype=torch.float32, device=perms.device)
    for r in range(int(k.max()) if B else 0):
        out = _add_at(out, perms[:, r], al[:, r])
    return out


def _decompose_rounds(D: torch.Tensor, matcher: str):
    """Alg. 1: matcher rounds until no residual support is left."""
    match = get_matcher(matcher)
    B, n, _ = D.shape
    dev = D.device
    D_rem = D.clone()
    S_rem = D > 0
    perms = torch.arange(n, device=dev).expand(B, n, n).clone()
    alphas = torch.zeros((B, n), dtype=torch.float32, device=dev)
    i = torch.zeros((B,), dtype=torch.int64, device=dev)
    conv = torch.ones((B,), dtype=torch.bool, device=dev)
    rounds = torch.zeros((B,), dtype=torch.int64, device=dev)
    while True:
        active = S_rem.any(dim=(1, 2)) & (i < n)
        idx = active.nonzero()[:, 0]
        if idx.numel() == 0:
            break
        Dr, Sr, ir = D_rem[idx], S_rem[idx], i[idx]
        row_deg = Sr.sum(dim=2)
        col_deg = Sr.sum(dim=1)
        kdeg = torch.maximum(row_deg.amax(dim=1), col_deg.amax(dim=1))
        crit_r = (row_deg == kdeg[:, None]) & (kdeg > 0)[:, None]
        crit_c = (col_deg == kdeg[:, None]) & (kdeg > 0)[:, None]
        base = torch.clamp_min(Dr, 0.0)
        # Dominance constant with a relative margin over the matcher's n·ε
        # slack (see the reference's comment at the same line). Summed in
        # float64 and rounded once, so CPU and GPU reductions give the same
        # M (the reference's float32 sum order is XLA's own).
        row_max_sum = base.amax(dim=2).sum(dim=1, dtype=torch.float64).float()
        M = (row_max_sum + 1.0) * (1.0 + n * 2.0**-19)
        bonus = M[:, None, None] * (crit_r[:, :, None].float() + crit_c[:, None, :].float())
        W = base + torch.where(Sr, bonus, 0.0)
        res = match(W)
        perm = res.perm
        newly = _take(Sr, perm)
        vals = torch.where(newly, _take(Dr, perm), torch.inf)
        alpha = torch.where(newly.any(dim=1), vals.amin(dim=1), 0.0)
        Dr = torch.clamp_min(_add_at(Dr, perm, -alpha), 0.0)
        Sr = Sr.scatter(2, perm[..., None], False)
        D_rem[idx], S_rem[idx] = Dr, Sr
        perms[idx, ir] = perm
        alphas[idx, ir] = alpha
        i[idx] = ir + 1
        conv[idx] &= res.converged
        rounds[idx] += res.rounds
    return perms, alphas, i, conv, rounds


def _refine(D, perms, alphas, k):
    """Alg. 2: greedy REFINE over each lane's first k rounds."""
    R = torch.clamp_min(D - coverage(perms, alphas, k), 0.0)
    alphas = alphas.clone()
    for r in range(int(k.max())):
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


def decompose(
    D: torch.Tensor,
    *,
    matcher: str = "auction",
    repair_rounds: int = 0,
) -> TorchDecomposition:
    """Exactly-k decomposition of each lane of ``D`` (B, n, n): Alg. 1 +
    greedy REFINE (+ ``repair_rounds`` local-search sweeps)."""
    D = D.to(torch.float32)
    perms, alphas, k, conv, rounds = _decompose_rounds(D, matcher)
    alphas = _refine(D, perms, alphas, k)
    if repair_rounds:
        perms, alphas, k = _repair(D, perms, alphas, k, repair_rounds)
    return TorchDecomposition(perms, alphas, k, conv, rounds)


def lpt_schedule(dec: TorchDecomposition, s: int, delta: torch.Tensor):
    """Alg. 3 per lane: returns ``(assignment (B, n), loads (B, s),
    makespan (B,))``; ``delta`` is (B,). Rounds go in non-increasing α order
    (stable), each onto the least-loaded switch (lowest index on ties)."""
    B, n = dec.alphas.shape
    dev = dec.alphas.device
    valid = (torch.arange(n, device=dev)[None, :] < dec.k[:, None]) & (dec.alphas > 0)
    order = torch.argsort(torch.where(valid, -dec.alphas, torch.inf), dim=1, stable=True)
    a_sorted = torch.gather(dec.alphas, 1, order)
    real_sorted = torch.gather(valid, 1, order)
    loads = torch.zeros((B, s), dtype=torch.float32, device=dev)
    placed = torch.full((B, n), -1, dtype=torch.int64, device=dev)
    # Invalid rounds sort last, so the loop stops at the longest valid prefix.
    for t in range(int(valid.sum(dim=1).max()) if B else 0):
        h = torch.argmin(loads, dim=1)
        real = real_sorted[:, t]
        add = torch.where(real, delta + a_sorted[:, t], 0.0)
        loads = torch.where(real[:, None], loads.scatter_add(1, h[:, None], add[:, None]), loads)
        placed[:, t] = torch.where(real, h, -1)
    assignment = torch.full((B, n), -1, dtype=torch.int64, device=dev).scatter(1, order, placed)
    return assignment, loads, loads.amax(dim=1)
