"""Batched max-weight assignment solvers for DECOMPOSE (PyTorch port).

Counterpart of ``repro.core.jaxopt.matching``: the same three ε-scaling
auction matchers, the same ε schedule and thresholds, written for a leading
batch dimension. Every matcher takes ``W`` (B, n, n) float32 and returns a
:class:`MatchResult` of per-lane tensors.

    auction        forward auction (Jacobi: every unassigned row bids at
                   once); every phase and round in one ``auction_rounds``
                   kernel launch at n ≤ 128, one ``masked_row_top2``
                   launch a round above (``auction_round_loop``).
    auction_fr     combined forward-reverse auction; the same launches with
                   reverse rounds on.
    auction_fused  the whole auction in one ``auction_fused`` kernel launch,
                   then greedy completion and a 2-swap polish in one
                   ``polish_2swap`` launch.

JAX ``vmap``s its ``while_loop``s; here each lane runs its own loop (in its
own thread block on the card, under a per-lane done mask in the round
loop), so a lane's result equals its own single-instance run. The ε
schedule is formed on the host from one table per phase count
(``eps_table``); only the round loop above n = 128 reads the device per
round. At n ≤ 128 on the card ``decompose`` runs ``auction`` and
``auction_fr`` inside its own kernel (``decompose_torch``), bit for bit
these functions' calls.

A matcher is ``fn(W (B, n, n), *, num_phases=None, max_iters=None,
prices0=None) -> MatchResult``: the reference's ``(perm, converged)`` and
its ``with_prices`` return folded into one named tuple. ``register_matcher``
adds one under a name; ``set_default_matcher_policy`` replaces the shape
rule of ``default_matcher``. Nothing caches a matcher by name: every
consumer (``decompose``, the online step and scan, the solver registry's
device entries, the scenario runner, the serving plane through
``solve_many``, ``bench.matching``) resolves the name at its next call, so
a replacement or a policy takes effect there.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch

from ...kernels.auction_bid.ops import ROUNDS_MAX_N, auction_round_loop, auction_rounds
from ...kernels.auction_fused.ops import fused_auction, polish_2swap
from ...kernels.auction_fused.ref import complete_greedy as _complete_greedy

# float32 prices saturate once ε < ulp(price); floor ε at two ulps of wmax.
_EPS_FLOOR = 2.0**-22

AUTOTUNE_N_THRESHOLD = 32
AUTOTUNE_FUSED_N_THRESHOLD = 128

_DEFAULT_POLICY = None  # None: the threshold rule of ``default_matcher``


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
    """Matcher for an (n, n) shape bucket: the installed policy's choice, else
    ``auction`` to 32, ``auction_fr`` to 128, ``auction_fused`` above."""
    if _DEFAULT_POLICY is not None:
        name = _DEFAULT_POLICY(n)
        if name not in MATCHERS:
            # The install-time probe sees one n; an n-dependent policy can
            # still name an unknown matcher at another.
            raise KeyError(
                f"default matcher policy returned unknown matcher {name!r} "
                f"for n={n}; available: {list_matchers()}"
            )
        return name
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


@functools.lru_cache(maxsize=None)
def _eps_table(num_phases: int, device: torch.device) -> torch.Tensor:
    ratio = torch.tensor([_EPS_FLOOR * 2.0]) ** (1.0 / max(num_phases - 1, 1))
    # One element a pow: the CPU's scalar pow, whatever its vector width.
    table = torch.cat([ratio ** torch.tensor([p]) for p in range(num_phases)])
    return table.to(device)


def eps_table(num_phases: int, device: str | torch.device = "cpu") -> torch.Tensor:
    """(P,) float32 ``ratio ** arange(P)``: the ε schedule of a call on W
    with n ≥ 5 is ``(wmax/2) · eps_table(P)``.

    For n ≥ 5 the final ε is ``wmax · 2⁻²²`` (the ``1e-6 / n`` term is
    smaller), an exact power-of-two scaling of ``wmax``, so the schedule's
    ratio ``(2⁻²¹) ** (1/(P-1))`` is the same for every ``wmax``: the table
    is formed once on the host, per P, with the CPU's pow, and cached on
    each device it is asked for (do not write to it).
    """
    return _eps_table(num_phases, torch.device(device))


def _eps_schedule(W: torch.Tensor, num_phases: int) -> torch.Tensor:
    """(B, P) geometric ε schedule from ``wmax/2`` down to the floored final ε.

    Given the same ``ratio`` it equals the reference's schedule exactly; a
    1–2 ulp difference in ``ratio`` grows to about k·2 ulps in phase k.
    For n ≥ 5 it is ``(wmax/2) · eps_table(P)``: every lane of every batch
    bids with the same ratio.
    """
    if W.shape[-1] >= 5:
        wmax = torch.clamp_min(W.abs().amax(dim=(1, 2)).cpu(), 1e-12)
        return ((wmax / 2.0)[:, None] * eps_table(num_phases)[None, :]).to(W.device)
    start, ratio = _eps_ratio(W, num_phases)
    steps = torch.arange(num_phases)
    return (start[:, None] * ratio[:, None] ** steps[None, :]).to(W.device)


def _prepare(W, num_phases, max_iters):
    W = W.to(torch.float32).contiguous()
    n = W.shape[-1]
    num_phases = default_num_phases(n) if num_phases is None else num_phases
    max_iters = default_max_iters(n) if max_iters is None else max_iters
    return W, n, num_phases, max_iters


def _warm_prices(prices0, W: torch.Tensor) -> torch.Tensor | None:
    """``prices0`` as contiguous (B, n) float32 on W's device (None stays None)."""
    if prices0 is None:
        return None
    B, n = W.shape[0], W.shape[-1]
    return torch.as_tensor(prices0, dtype=torch.float32, device=W.device).expand(B, n).contiguous()


def _run_rounds(W: torch.Tensor, num_phases: int, max_iters: int, reverse: bool, prices0) -> MatchResult:
    """Every phase and round of one matcher call: one ``auction_rounds``
    launch while W fits its block (n ≤ 128), else ``auction_round_loop``.
    Both give the same result bit for bit where both can run."""
    run = auction_rounds if W.shape[-1] <= ROUNDS_MAX_N else auction_round_loop
    row2col, col2row, prices, rounds, _ = run(
        W, _eps_schedule(W, num_phases).contiguous(), max_iters, reverse=reverse,
        prices0=_warm_prices(prices0, W),
    )
    converged = (row2col >= 0).all(dim=1)
    return MatchResult(_complete_greedy(row2col, col2row), converged, prices, rounds)


def match_auction(
    W: torch.Tensor,
    *,
    num_phases: int | None = None,
    max_iters: int | None = None,
    prices0: torch.Tensor | None = None,
) -> MatchResult:
    """Forward ε-scaling auction on each lane of ``W`` (B, n, n).

    ``prices0`` ((n,) or (B, n)) warm-starts the column prices, e.g. with a
    previous similar instance's final prices (``MatchResult.prices``); the
    whole ε schedule still runs, as in the reference.
    """
    W, n, num_phases, max_iters = _prepare(W, num_phases, max_iters)
    return _run_rounds(W, num_phases, max_iters, False, prices0)


def match_auction_fr(
    W: torch.Tensor,
    *,
    num_phases: int | None = None,
    max_iters: int | None = None,
    prices0: torch.Tensor | None = None,
) -> MatchResult:
    """Combined forward-reverse auction on each lane of ``W`` (B, n, n).

    Rows and columns take turns bidding; a lane flips sides whenever a round
    grows its assignment, and each phase starts on the row side. Prices start
    at ``prices0`` (as on ``match_auction``) and row profits at 0; both
    persist across phases, as in the reference.
    """
    W, n, num_phases, max_iters = _prepare(W, num_phases, max_iters)
    return _run_rounds(W, num_phases, max_iters, True, prices0)


def match_auction_fused(
    W: torch.Tensor,
    *,
    num_phases: int | None = None,
    max_iters: int | None = None,
    prices0: torch.Tensor | None = None,
) -> MatchResult:
    """The whole forward auction in one ``fused_auction`` call, then greedy
    completion and the 2-swap polish in one ``polish_2swap`` call.

    With ``prices0`` (a warm start) the call enters the ε schedule at its
    tail: the last ``max(2, num_phases // 2)`` phases.
    """
    W, n, num_phases, max_iters = _prepare(W, num_phases, max_iters)
    B = W.shape[0]
    eps_sched = _eps_schedule(W, num_phases)
    if prices0 is not None:
        eps_sched = eps_sched[:, -max(2, num_phases // 2):]
        match_auction_fused.warm_entries += 1
    if prices0 is None:
        prices = torch.zeros((B, n), dtype=torch.float32, device=W.device)
    else:
        prices = _warm_prices(prices0, W)
    r2c, c2r, prices, rounds, _ = fused_auction(
        W, prices, eps_sched.contiguous(), max_iters=max_iters
    )
    perm, converged = polish_2swap(W, r2c, c2r, max_swaps=2 * n)
    return MatchResult(perm, converged, prices, rounds.long())


match_auction_fused.warm_entries = 0  # calls that entered the ε schedule at its tail


MatcherFn = Callable[..., MatchResult]

MATCHERS: dict[str, MatcherFn] = {
    "auction": match_auction,
    "auction_fr": match_auction_fr,
    "auction_fused": match_auction_fused,
}


def get_matcher(name: str) -> MatcherFn:
    if name not in MATCHERS:
        raise KeyError(f"unknown matcher {name!r}; available: {list_matchers()}")
    return MATCHERS[name]


def list_matchers() -> list[str]:
    return sorted(MATCHERS)


def register_matcher(name: str, fn: MatcherFn, *, overwrite: bool = False) -> None:
    """Add a matcher under ``name`` (see the module docstring for its
    contract). A name already taken raises ``ValueError`` unless
    ``overwrite``; a replacement takes effect at every consumer's next call."""
    if name in MATCHERS and not overwrite:
        raise ValueError(f"matcher {name!r} already registered")
    MATCHERS[name] = fn


def set_default_matcher_policy(policy: Callable[[int], str] | None) -> None:
    """Install ``policy(n) -> matcher name`` in place of the threshold rule
    of ``default_matcher`` (``None`` restores the rule). The policy is probed
    at n = 8 here and checked again at every n it is asked."""
    global _DEFAULT_POLICY
    if policy is not None:
        name = policy(8)
        if name not in MATCHERS:
            raise KeyError(f"policy returned unknown matcher {name!r}; available: {list_matchers()}")
    _DEFAULT_POLICY = policy
