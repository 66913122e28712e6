"""Plain PyTorch versions of the auction bid top-2 reduction and of the
auction's whole round loop.

``masked_row_top2_ref`` has the same float order and tie rule as
``repro.kernels.auction_bid.ref``: one subtraction ``W − p`` per entry,
first-index argmax, and the second best taken over the other columns with
the winner masked to ``NEG``.

``auction_rounds_ref`` runs every ε-phase and bidding round of the forward
(``repro.core.jaxopt.matching.match_auction``) or forward-reverse
(``match_auction_fr``) auction, round by round, with the reference's
``_forward_round`` / ``_reverse_round`` written for a leading batch
dimension. It is the plain version of ``csrc/auction_rounds.cu``.
"""

from __future__ import annotations

import torch

NEG = -1e30


def masked_row_top2_ref(W: torch.Tensor, prices: torch.Tensor):
    """Per-row top-2 of ``V = W − prices`` for a batch.

    ``W`` is (B, n, m) float32 and ``prices`` (B, m) float32. Returns
    ``(v1, v2, j1)``, each (B, n): the best value, the second best over the
    remaining columns, and the argmax column (int32, first index on ties).
    For m == 1, v2 = NEG.
    """
    V = W - prices[:, None, :]
    j1 = torch.argmax(V, dim=2)
    v1 = torch.gather(V, 2, j1[..., None])[..., 0]
    cols = torch.arange(V.shape[2], device=V.device)
    V2 = torch.where(cols[None, None, :] == j1[..., None], NEG, V)
    v2 = V2.amax(dim=2)
    return v1, v2, j1.to(torch.int32)


def _drop_scatter(x: torch.Tensor, idx: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``x.at[idx].set(src, mode="drop")`` per lane: index n is dropped."""
    n = x.shape[1]
    return torch.cat([x, x[:, :1]], dim=1).scatter(1, idx, src)[:, :n]


def _forward_round(W, row2col, col2row, prices, profits, eps, lanes, top2):
    """One Jacobi bidding round on the lanes where ``lanes`` (B,) is set;
    with ``profits`` given, also maintains row profits (``π_i = v2 − ε``
    for winners) for the forward-reverse auction. ``top2`` computes the
    round's per-row top-2 (``masked_row_top2_ref`` or its kernel).

    In a lane that is not set no row bids, so no column takes a bid and the
    round leaves that lane exactly as it was: the done mask costs no select.
    """
    B, n, _ = W.shape
    arange = torch.arange(n, device=W.device).expand(B, n)
    unassigned = (row2col < 0) & lanes[:, None]
    # In a reverse round `prices` are the row profits, a scatter's slice.
    v1, v2, j1 = top2(W, prices.contiguous())
    j1 = j1.long()
    w_j1 = torch.gather(W, 2, j1[..., None])[..., 0]
    bid = torch.where(unassigned, w_j1 - v2 + eps[:, None], NEG)
    # Columns take the best bid; the reference's dense (n, n) scatter and
    # first-index argmax over rows become an amax and an amin of row ids.
    col_best = torch.full((B, n), NEG, dtype=W.dtype, device=W.device).scatter_reduce(
        1, j1, bid, "amax", include_self=True
    )
    at_best = bid == torch.gather(col_best, 1, j1)
    col_winner = torch.full((B, n), n, dtype=torch.int64, device=W.device).scatter_reduce(
        1, j1, torch.where(at_best, arange, n), "amin", include_self=True
    )
    has_bid = col_best > NEG / 2
    col2row = torch.where(has_bid, col_winner, col2row)
    prices = torch.where(has_bid, col_best, prices)
    # row2col stays the inverse of col2row: a winner was unassigned (it bid)
    # and a kicked owner was assigned (it did not), so rebuilding the inverse
    # equals the reference's kick-then-install scatters.
    row2col = torch.full((B, n + 1), -1, dtype=torch.int64, device=W.device).scatter(
        1, torch.where(col2row >= 0, col2row, n), arange
    )[:, :n]
    if profits is not None:
        winner = torch.where(has_bid, col_winner, n)
        safe_winner = torch.clamp(col_winner, 0, n - 1)
        profits = _drop_scatter(
            profits, winner,
            torch.where(has_bid, torch.gather(v2, 1, safe_winner) - eps[:, None], 0.0),
        )
    return row2col, col2row, prices, profits


def _reverse_round(Wt, row2col, col2row, prices, profits, eps, lanes, top2):
    """Column-side bidding: the forward round on ``Wᵀ`` with roles swapped."""
    col2row, row2col, profits, prices = _forward_round(
        Wt, col2row, row2col, profits, prices, eps, lanes, top2
    )
    return row2col, col2row, prices, profits


def auction_rounds_ref(W: torch.Tensor, eps: torch.Tensor, max_iters: int, *, reverse: bool,
                       top2=masked_row_top2_ref, prices0: torch.Tensor | None = None):
    """Every ε-phase and bidding round of the auction on each lane of ``W``.

    ``W`` is (B, n, n) float32 and ``eps`` the (B, P) ε schedule. Prices
    start at ``prices0`` ((B, n) float32, a warm start; None: 0) and persist
    across phases; row profits start at 0. Each phase restarts the
    assignment and runs rounds until every row is assigned or ``max_iters``
    rounds have run. With ``reverse`` the rounds are those of the combined
    forward-reverse auction: rows and columns take turns bidding, a lane
    flips sides whenever a round grows its assignment, each phase starts on
    the row side, and row profits persist across phases.

    Returns ``(row2col, col2row, prices, rounds, bids)``: (B, n) int64 maps
    (−1 for unassigned), (B, n) float32 prices, and (B,) int64 counts of the
    bidding rounds and of the bids (rows or columns that bid) over all
    phases. A lane that is done is never updated again (its round counter
    stops too), so a lane's result equals its own single-instance run. The
    loop reads one flag from the device per round to decide whether to go on.

    ``top2`` is each round's top-2 reduction. The matchers run this loop
    with the ``masked_row_top2`` wrapper (one kernel launch a round on the
    card) where ``auction_rounds`` cannot hold W, so both paths share this
    one definition of a round's arithmetic.
    """
    B, n, _ = W.shape
    dev = W.device
    Wt = W.transpose(1, 2).contiguous() if reverse else None
    prices = (torch.zeros((B, n), dtype=torch.float32, device=dev) if prices0 is None
              else prices0.to(torch.float32).clone())
    profits = torch.zeros((B, n), dtype=torch.float32, device=dev) if reverse else None
    rounds = torch.zeros((B,), dtype=torch.int64, device=dev)
    bids = torch.zeros((B,), dtype=torch.int64, device=dev)
    row2col = torch.full((B, n), -1, dtype=torch.int64, device=dev)
    col2row = row2col.clone()
    for p in range(eps.shape[1]):
        e = eps[:, p]
        row2col = torch.full((B, n), -1, dtype=torch.int64, device=dev)
        col2row = row2col.clone()
        fwd = torch.ones((B,), dtype=torch.bool, device=dev)
        it = torch.zeros((B,), dtype=torch.int64, device=dev)
        while True:
            active = (row2col < 0).any(dim=1) & (it < max_iters)
            if not reverse:
                if not bool(active.any()):
                    break
                bids += ((row2col < 0) & active[:, None]).sum(dim=1)
                row2col, col2row, prices, _ = _forward_round(W, row2col, col2row, prices, None, e, active, top2)
            else:
                go_f, go_r = active & fwd, active & ~fwd
                # Each lane takes one of the two rounds; the other is a no-op there.
                any_f, any_r = torch.stack([go_f.any(), go_r.any()]).tolist()
                if not (any_f or any_r):
                    break
                bids += ((row2col < 0) & go_f[:, None]).sum(dim=1) + ((col2row < 0) & go_r[:, None]).sum(dim=1)
                new = (row2col, col2row, prices, profits)
                if any_f:
                    new = _forward_round(W, *new, e, go_f, top2)
                if any_r:
                    new = _reverse_round(Wt, *new, e, go_r, top2)
                # A lane that did not bid did not grow, so its side stays.
                fwd = fwd ^ ((new[0] >= 0).sum(dim=1) > (row2col >= 0).sum(dim=1))
                row2col, col2row, prices, profits = new
            it += active
        rounds += it
    return row2col, col2row, prices, rounds, bids
