"""Batched device SPECTRA pipeline in PyTorch (``repro.core.jaxopt``).

Every function takes a leading batch dimension and runs on the device of
its tensors (``device=None`` means CUDA):

    matching            the matchers (ε-scaling auction, forward-reverse
                        auction, fused auction) behind the ``MATCHERS``
                        registry, ``default_matcher`` and its policy
    auction             legacy entry point for the "auction" matcher
    decompose_torch     Alg. 1 + greedy REFINE + optional repair sweeps;
                        LPT (Alg. 3); ``spectra_torch`` = both in one call
    equalize_torch      Alg. 4 (incl. merge-aware SPECTRA++)
    lower_bounds_torch  §IV bounds over all 2n lines of every lane
    e2e                 fused DECOMPOSE → SCHEDULE → EQUALIZE (+ LB)
    online_torch        stateful cross-period steps and the rolling solve
"""

from .auction import auction_maximize, auction_maximize_batch
from .decompose_torch import (
    TorchDecomposition,
    decompose,
    decompose_prices,
    lpt_schedule,
    spectra_torch,
    to_decomposition,
)
from .e2e import E2EResult, spectra_torch_e2e_many
from .equalize_torch import equalize_ir, equalize_torch
from .lower_bounds_torch import lower_bound
from .matching import (
    MATCHERS,
    MatchResult,
    default_matcher,
    get_matcher,
    list_matchers,
    match_auction,
    match_auction_fr,
    match_auction_fused,
    register_matcher,
    set_default_matcher_policy,
)
from .online_torch import (
    OnlineDeviceState,
    OnlineStepResult,
    online_initial_state,
    online_step,
    spectra_online_scan,
)

__all__ = [
    "E2EResult",
    "MATCHERS",
    "MatchResult",
    "OnlineDeviceState",
    "OnlineStepResult",
    "TorchDecomposition",
    "auction_maximize",
    "auction_maximize_batch",
    "decompose",
    "decompose_prices",
    "default_matcher",
    "equalize_ir",
    "equalize_torch",
    "get_matcher",
    "list_matchers",
    "lower_bound",
    "lpt_schedule",
    "match_auction",
    "match_auction_fr",
    "match_auction_fused",
    "online_initial_state",
    "online_step",
    "register_matcher",
    "set_default_matcher_policy",
    "spectra_online_scan",
    "spectra_torch",
    "spectra_torch_e2e_many",
    "to_decomposition",
]
