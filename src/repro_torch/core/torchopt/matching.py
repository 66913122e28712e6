"""Batched max-weight assignment solvers for DECOMPOSE (PyTorch port).

Counterpart of ``repro.core.jaxopt.matching``: the same three ε-scaling
auction matchers, the same ε schedule and thresholds, written for a leading
batch dimension. Every matcher takes ``W`` (B, n, n) float32 and returns a
:class:`MatchResult` of per-lane tensors.

    auction        forward auction (Jacobi: every unassigned row bids at
                   once); one ``auction_bid`` kernel launch per round.
    auction_fr     combined forward-reverse auction; reverse rounds run the
                   forward round on ``Wᵀ``, made contiguous once per call.
    auction_fused  the whole auction in one ``auction_fused`` kernel launch,
                   then greedy completion and a 2-swap polish.

JAX ``vmap``s its ``while_loop``s; here each loop keeps a per-lane done mask
and never updates a finished lane (its round counter stops too), so a lane's
result equals its own single-instance run. The loops read one flag from the
device per round to decide whether to go on.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ...kernels.auction_bid.ops import masked_row_top2
from ...kernels.auction_fused.ops import fused_auction

_NEG = -1e30

# float32 prices saturate once ε < ulp(price); floor ε at two ulps of wmax.
_EPS_FLOOR = 2.0**-22

AUTOTUNE_N_THRESHOLD = 32
AUTOTUNE_FUSED_N_THRESHOLD = 128


class MatchResult(NamedTuple):
    perm: torch.Tensor       # (B, n) int64: a permutation per lane
    converged: torch.Tensor  # (B,) bool: every phase finished within budget
    prices: torch.Tensor     # (B, n) float32: final column prices
    rounds: torch.Tensor     # (B,) int64: bidding rounds over all phases


def default_num_phases(n: int) -> int:
    """ε-schedule length: 8 phases to n = 32, 12 to 256, 16 above."""
    if n <= 32:
        return 8
    if n <= 256:
        return 12
    return 16


def default_max_iters(n: int) -> int:
    """Per-phase bidding-round budget."""
    return max(2000, 60 * n)


def default_matcher(n: int) -> str:
    """Matcher for an (n, n) shape bucket: ``auction`` to 32, ``auction_fr``
    to 128, ``auction_fused`` above."""
    if n <= AUTOTUNE_N_THRESHOLD:
        return "auction"
    if n <= AUTOTUNE_FUSED_N_THRESHOLD:
        return "auction_fr"
    return "auction_fused"


def _eps_ratio(W: torch.Tensor, num_phases: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(B,) first ε (``wmax/2``) and per-phase ratio of the ε schedule, on
    the host.

    ``ratio`` is a float32 ``pow``. The CPU's and the GPU's ``pow`` may
    round differently, so the schedule is always formed on the host, from
    the device's exact ``wmax``: every device bids with the same ε. PyTorch
    and XLA may also round it differently: they agree to within 2 ulps.
    """
    n = W.shape[-1]
    wmax = torch.clamp_min(W.abs().amax(dim=(1, 2)).cpu(), 1e-12)
    eps_final = torch.maximum(wmax * 1e-6 / n, wmax * _EPS_FLOOR)
    ratio = (eps_final / (wmax / 2.0)) ** (1.0 / max(num_phases - 1, 1))
    return wmax / 2.0, ratio


def _eps_schedule(W: torch.Tensor, num_phases: int) -> torch.Tensor:
    """(B, P) geometric ε schedule from ``wmax/2`` down to the floored final ε.

    Given the same ``ratio`` it equals the reference's schedule exactly; a
    1–2 ulp difference in ``ratio`` grows to about k·2 ulps in phase k.
    """
    start, ratio = _eps_ratio(W, num_phases)
    steps = torch.arange(num_phases)
    return (start[:, None] * ratio[:, None] ** steps[None, :]).to(W.device)


def _drop_scatter(x: torch.Tensor, idx: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``x.at[idx].set(src, mode="drop")`` per lane: index n is dropped."""
    n = x.shape[1]
    return torch.cat([x, x[:, :1]], dim=1).scatter(1, idx, src)[:, :n]


def _forward_round(W, row2col, col2row, prices, profits, eps, lanes):
    """One Jacobi bidding round on the lanes where ``lanes`` (B,) is set;
    with ``profits`` given, also maintains row profits (``π_i = v2 − ε``
    for winners) for the forward-reverse matcher.

    In a lane that is not set no row bids, so no column takes a bid and the
    round leaves that lane exactly as it was: the done mask costs no select.
    """
    B, n, _ = W.shape
    arange = torch.arange(n, device=W.device).expand(B, n)
    unassigned = (row2col < 0) & lanes[:, None]
    # In a reverse round `prices` are the row profits, a scatter's slice.
    v1, v2, j1 = masked_row_top2(W, prices.contiguous())
    j1 = j1.long()
    w_j1 = torch.gather(W, 2, j1[..., None])[..., 0]
    bid = torch.where(unassigned, w_j1 - v2 + eps[:, None], _NEG)
    # Columns take the best bid; the reference's dense (n, n) scatter and
    # first-index argmax over rows become an amax and an amin of row ids.
    col_best = torch.full((B, n), _NEG, dtype=W.dtype, device=W.device).scatter_reduce(
        1, j1, bid, "amax", include_self=True
    )
    at_best = bid == torch.gather(col_best, 1, j1)
    col_winner = torch.full((B, n), n, dtype=torch.int64, device=W.device).scatter_reduce(
        1, j1, torch.where(at_best, arange, n), "amin", include_self=True
    )
    has_bid = col_best > _NEG / 2
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


def _reverse_round(Wt, row2col, col2row, prices, profits, eps, lanes):
    """Column-side bidding: the forward round on ``Wᵀ`` with roles swapped."""
    col2row, row2col, profits, prices = _forward_round(
        Wt, col2row, row2col, profits, prices, eps, lanes
    )
    return row2col, col2row, prices, profits


def _complete_greedy(row2col: torch.Tensor, col2row: torch.Tensor) -> torch.Tensor:
    """Pair leftover rows with leftover columns in rank order, so the result
    is always a permutation."""
    n = row2col.shape[1]
    un_r = row2col < 0
    un_c = col2row < 0
    rank_r = torch.cumsum(un_r.long(), dim=1) - 1
    order_c = torch.argsort((~un_c).to(torch.int8), dim=1, stable=True)
    fill = torch.gather(order_c, 1, torch.clamp(rank_r, 0, n - 1))
    return torch.where(un_r, fill, row2col)


def _run_phases(W, eps_sched, prices, max_iters, step, state, phase_start):
    """The ε-phase loop shared by ``auction`` and ``auction_fr``.

    ``step(row2col, col2row, prices, state, eps, active)`` runs one round and
    returns the new ``(row2col, col2row, prices, state)``, leaving lanes
    outside ``active`` unchanged (their round counters stop too), or returns
    ``None`` when no lane is active; it reads the device once to decide.
    ``state`` persists across phases; ``phase_start(state)`` resets what a
    new phase resets.
    """
    B, n, _ = W.shape
    dev = W.device
    rounds = torch.zeros((B,), dtype=torch.int64, device=dev)
    row2col = torch.full((B, n), -1, dtype=torch.int64, device=dev)
    col2row = row2col.clone()
    for p in range(eps_sched.shape[1]):
        eps = eps_sched[:, p]
        row2col = torch.full((B, n), -1, dtype=torch.int64, device=dev)
        col2row = row2col.clone()
        state = phase_start(state)
        it = torch.zeros((B,), dtype=torch.int64, device=dev)
        while True:
            active = (row2col < 0).any(dim=1) & (it < max_iters)
            out = step(row2col, col2row, prices, state, eps, active)
            if out is None:
                break
            row2col, col2row, prices, state = out
            it += active
        rounds += it
    return row2col, col2row, prices, rounds


def _prepare(W, num_phases, max_iters):
    W = W.to(torch.float32).contiguous()
    n = W.shape[-1]
    num_phases = default_num_phases(n) if num_phases is None else num_phases
    max_iters = default_max_iters(n) if max_iters is None else max_iters
    return W, n, num_phases, max_iters


def match_auction(
    W: torch.Tensor,
    *,
    num_phases: int | None = None,
    max_iters: int | None = None,
) -> MatchResult:
    """Forward ε-scaling auction on each lane of ``W`` (B, n, n)."""
    W, n, num_phases, max_iters = _prepare(W, num_phases, max_iters)
    B = W.shape[0]
    prices = torch.zeros((B, n), dtype=torch.float32, device=W.device)

    def step(row2col, col2row, prices, state, eps, active):
        if not bool(active.any()):
            return None
        new = _forward_round(W, row2col, col2row, prices, None, eps, active)
        return (*new[:3], state)

    row2col, col2row, prices, rounds = _run_phases(
        W, _eps_schedule(W, num_phases), prices, max_iters, step, None,
        lambda state: state,
    )
    converged = (row2col >= 0).all(dim=1)
    return MatchResult(_complete_greedy(row2col, col2row), converged, prices, rounds)


def match_auction_fr(
    W: torch.Tensor,
    *,
    num_phases: int | None = None,
    max_iters: int | None = None,
) -> MatchResult:
    """Combined forward-reverse auction on each lane of ``W`` (B, n, n).

    Rows and columns take turns bidding; a lane flips sides whenever a round
    grows its assignment. Each round runs the forward round on the lanes
    bidding from the row side and the reverse round on the others, each a
    no-op on the lanes it does not cover (the reference's ``lax.cond``
    under ``vmap``). Row profits persist across phases, as in the reference.
    """
    W, n, num_phases, max_iters = _prepare(W, num_phases, max_iters)
    B = W.shape[0]
    Wt = W.transpose(1, 2).contiguous()  # constant for the whole call
    prices = torch.zeros((B, n), dtype=torch.float32, device=W.device)
    profits = torch.zeros((B, n), dtype=torch.float32, device=W.device)
    true = torch.ones((B,), dtype=torch.bool, device=W.device)

    def step(row2col, col2row, prices, state, eps, active):
        profits, fwd = state
        new = (row2col, col2row, prices, profits)
        go_f, go_r = active & fwd, active & ~fwd
        # Each lane takes one of the two rounds; the other is a no-op there.
        any_f, any_r = torch.stack([go_f.any(), go_r.any()]).tolist()
        if not (any_f or any_r):
            return None
        if any_f:
            new = _forward_round(W, *new, eps, go_f)
        if any_r:
            new = _reverse_round(Wt, *new, eps, go_r)
        # A lane that did not bid did not grow, so its side stays.
        grew = (new[0] >= 0).sum(dim=1) > (row2col >= 0).sum(dim=1)
        fwd = fwd ^ grew
        return new[0], new[1], new[2], (new[3], fwd)

    row2col, col2row, prices, rounds = _run_phases(
        W, _eps_schedule(W, num_phases), prices, max_iters, step, (profits, true),
        lambda state: (state[0], true),  # each phase starts on the row side
    )
    converged = (row2col >= 0).all(dim=1)
    return MatchResult(_complete_greedy(row2col, col2row), converged, prices, rounds)


def _polish_2swap(W: torch.Tensor, perm: torch.Tensor, max_swaps: int) -> torch.Tensor:
    """Greedy best-pair 2-swap polish, per lane, until no transposition
    improves the assignment or ``max_swaps`` swaps ran."""
    B, n, _ = W.shape
    perm = perm.clone()
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
    return perm


def match_auction_fused(
    W: torch.Tensor,
    *,
    num_phases: int | None = None,
    max_iters: int | None = None,
    prices0: torch.Tensor | None = None,
) -> MatchResult:
    """The whole forward auction in one ``fused_auction`` call, then greedy
    completion and the 2-swap polish.

    With ``prices0`` (a warm start) the call enters the ε schedule at its
    tail: the last ``max(2, num_phases // 2)`` phases.
    """
    W, n, num_phases, max_iters = _prepare(W, num_phases, max_iters)
    B = W.shape[0]
    eps_sched = _eps_schedule(W, num_phases)
    if prices0 is not None:
        eps_sched = eps_sched[:, -max(2, num_phases // 2):]
    if prices0 is None:
        prices = torch.zeros((B, n), dtype=torch.float32, device=W.device)
    else:
        prices = torch.as_tensor(prices0, dtype=torch.float32, device=W.device).expand(B, n).contiguous()
    r2c, c2r, prices, rounds, _ = fused_auction(
        W, prices, eps_sched.contiguous(), max_iters=max_iters
    )
    r2c, c2r = r2c.long(), c2r.long()
    converged = (r2c >= 0).all(dim=1)
    perm = _polish_2swap(W, _complete_greedy(r2c, c2r), max_swaps=2 * n)
    return MatchResult(perm, converged, prices, rounds.long())


MatcherFn = Callable[..., MatchResult]

MATCHERS: dict[str, MatcherFn] = {
    "auction": match_auction,
    "auction_fr": match_auction_fr,
    "auction_fused": match_auction_fused,
}


def get_matcher(name: str) -> MatcherFn:
    if name not in MATCHERS:
        raise KeyError(f"unknown matcher {name!r}; available: {sorted(MATCHERS)}")
    return MATCHERS[name]
