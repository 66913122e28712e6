"""Batched max-weight assignment solvers for DECOMPOSE (PyTorch port).

Counterpart of ``repro.core.jaxopt.matching``: the same three ε-scaling
auction matchers, the same ε schedule and thresholds, written for a leading
batch dimension. Every matcher takes ``W`` (B, n, n) float32 and returns a
:class:`MatchResult` of per-lane tensors.

    auction        forward auction (Jacobi: every unassigned row bids at
                   once); every phase and round in one ``auction_rounds``
                   kernel launch (n ≤ 128).
    auction_fr     combined forward-reverse auction; the same launch with
                   reverse rounds on.
    auction_fused  the whole auction in one ``auction_fused`` kernel launch,
                   then greedy completion and a 2-swap polish.

JAX ``vmap``s its ``while_loop``s; here each lane runs its own loop (in its
own thread block on the card, under a per-lane done mask in the plain
version), so a lane's result equals its own single-instance run. The ε
schedule is formed on the host; no matcher reads the device per round.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ...kernels.auction_bid.ops import auction_rounds
from ...kernels.auction_fused.ops import fused_auction

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
    """Forward ε-scaling auction on each lane of ``W`` (B, n, n), n ≤ 128
    (``auction_fused`` above)."""
    W, n, num_phases, max_iters = _prepare(W, num_phases, max_iters)
    row2col, col2row, prices, rounds, _ = auction_rounds(
        W, _eps_schedule(W, num_phases).contiguous(), max_iters, reverse=False
    )
    converged = (row2col >= 0).all(dim=1)
    return MatchResult(_complete_greedy(row2col, col2row), converged, prices, rounds)


def match_auction_fr(
    W: torch.Tensor,
    *,
    num_phases: int | None = None,
    max_iters: int | None = None,
) -> MatchResult:
    """Combined forward-reverse auction on each lane of ``W`` (B, n, n),
    n ≤ 128 (``auction_fused`` above).

    Rows and columns take turns bidding; a lane flips sides whenever a round
    grows its assignment, and each phase starts on the row side. Row profits
    persist across phases, as in the reference.
    """
    W, n, num_phases, max_iters = _prepare(W, num_phases, max_iters)
    row2col, col2row, prices, rounds, _ = auction_rounds(
        W, _eps_schedule(W, num_phases).contiguous(), max_iters, reverse=True
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
