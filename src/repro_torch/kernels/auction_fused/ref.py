"""Plain PyTorch version of the fused ε-scaling auction.

Same round semantics, float order and tie rules as
``repro.kernels.auction_fused.ref.fused_auction_ref``, batched over a leading
instance dimension. Each round costs one O(n²) pass (the ``W − prices``
top-2) plus O(n) segment scatters: ``scatter_reduce(amax)`` finds each
column's best increment and ``scatter_reduce(amin)`` its lowest bidding row
at that increment.

The batched loop keeps a per-lane done mask: a lane whose assignment is
complete, or whose round budget is spent, is never updated again, exactly
as the reference's ``vmap``-ed ``while_loop`` freezes a finished lane.
"""

from __future__ import annotations

import torch

NEG = -1e30
NEG_HALF = NEG / 2


def _round(W, r2c, c2r, prices, eps):
    """One Jacobi bidding round for every lane (int64 maps)."""
    B, n, _ = W.shape
    dev = W.device
    cols = torch.arange(n, device=dev)
    V = W - prices[:, None, :]
    j1 = torch.argmax(V, dim=2)
    v1 = torch.gather(V, 2, j1[..., None])[..., 0]
    v2 = torch.where(cols[None, None, :] == j1[..., None], NEG, V).amax(dim=2)
    inc = torch.where(r2c < 0, v1 - v2 + eps[:, None], NEG)
    # Columns take the best increment (every bidder on j shares prices[j], so
    # comparing increments is comparing bids); the winner is the lowest row.
    col_inc = torch.full((B, n), NEG, dtype=W.dtype, device=dev).scatter_reduce(
        1, j1, inc, "amax", include_self=True
    )
    cand = (inc > NEG_HALF) & (inc >= torch.gather(col_inc, 1, j1))
    winner = torch.full((B, n + 1), n, dtype=torch.int64, device=dev).scatter_reduce(
        1, torch.where(cand, j1, n), cols.expand(B, n), "amin", include_self=True
    )[:, :n]
    has = winner < n
    c2r = torch.where(has, winner, c2r)
    prices = torch.where(has, prices + col_inc, prices)
    # Rebuild row -> column from the injective column -> row map; index n
    # is the dropped slot.
    r2c = torch.full((B, n + 1), -1, dtype=torch.int64, device=dev).scatter(
        1, torch.where(c2r >= 0, c2r, n), cols.expand(B, n)
    )[:, :n]
    return r2c, c2r, prices


def fused_auction_ref(
    W: torch.Tensor,
    prices0: torch.Tensor,
    eps: torch.Tensor,
    *,
    max_iters: int,
):
    """ε-scaling auction over each lane's ``eps`` row.

    ``W`` (B, n, n) float32, ``prices0`` (B, n) float32, ``eps`` (B, P)
    float32. Each phase restarts the assignment and keeps the learned prices;
    ``max_iters`` bounds the rounds of each phase. Returns ``(r2c, c2r,
    prices, rounds, bids)``: the maps (B, n) int32 (``-1`` = unassigned),
    the final prices (B, n), the bidding rounds summed over phases (B,)
    int32, and the bidding rows summed over rounds (B,) int64.
    """
    B, n, _ = W.shape
    dev = W.device
    prices = prices0.clone()
    r2c = torch.full((B, n), -1, dtype=torch.int64, device=dev)
    c2r = r2c.clone()
    rounds = torch.zeros((B,), dtype=torch.int32, device=dev)
    bids = torch.zeros((B,), dtype=torch.int64, device=dev)
    for p in range(eps.shape[1]):
        e = eps[:, p]
        r2c = torch.full((B, n), -1, dtype=torch.int64, device=dev)
        c2r = r2c.clone()
        it = torch.zeros((B,), dtype=torch.int32, device=dev)
        while True:
            bidders = (r2c < 0).sum(dim=1)
            active = (bidders > 0) & (it < max_iters)
            if not bool(active.any()):
                break
            nr2c, nc2r, nprices = _round(W, r2c, c2r, prices, e)
            keep = active[:, None]
            r2c = torch.where(keep, nr2c, r2c)
            c2r = torch.where(keep, nc2r, c2r)
            prices = torch.where(keep, nprices, prices)
            bids += torch.where(active, bidders, 0)
            it += active.to(torch.int32)
        rounds += it
    return r2c.to(torch.int32), c2r.to(torch.int32), prices, rounds, bids


def complete_greedy(row2col: torch.Tensor, col2row: torch.Tensor) -> torch.Tensor:
    """Pair leftover rows with leftover columns in rank order, so the result
    is always a permutation."""
    n = row2col.shape[1]
    un_r = row2col < 0
    un_c = col2row < 0
    rank_r = torch.cumsum(un_r.long(), dim=1) - 1
    order_c = torch.argsort((~un_c).to(torch.int8), dim=1, stable=True)
    fill = torch.gather(order_c, 1, torch.clamp(rank_r, 0, n - 1))
    return torch.where(un_r, fill, row2col)


def polish_2swap_ref(W: torch.Tensor, r2c: torch.Tensor, c2r: torch.Tensor, *, max_swaps: int):
    """The fused matcher's tail: greedy completion of the maps, then the
    greedy best-pair 2-swap polish, per lane, until no transposition improves
    the assignment or ``max_swaps`` swaps ran. Returns ``(perm, converged)``:
    (B, n) int64 and (B,) bool (every row assigned before completion)."""
    converged = (r2c >= 0).all(dim=1)
    perm = complete_greedy(r2c.long(), c2r.long())
    B, n, _ = W.shape
    lanes = torch.arange(B, device=W.device)
    it = torch.zeros((B,), dtype=torch.int64, device=W.device)
    improved = torch.ones((B,), dtype=torch.bool, device=W.device)
    while True:
        active = improved & (it < max_swaps)
        if not bool(active.any()):
            break
        cur = torch.gather(W, 2, perm[..., None])[..., 0]
        cross = torch.gather(W, 2, perm[:, None, :].expand(B, n, n))
        gain = cross + cross.transpose(1, 2) - cur[:, :, None] - cur[:, None, :]
        flat = torch.argmax(gain.reshape(B, n * n), dim=1)
        i, ip = flat // n, flat % n
        do = (gain[lanes, i, ip] > 0) & active
        pi, pip = perm[lanes, i], perm[lanes, ip]
        perm[lanes, i] = torch.where(do, pip, pi)
        perm[lanes, ip] = torch.where(do, pi, pip)
        it += active.long()
        improved = torch.where(active, do, improved)
    return perm, converged
