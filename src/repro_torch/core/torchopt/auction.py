"""ε-scaling auction for max-weight assignment, the legacy entry point
(``repro.core.jaxopt.auction``).

The implementation lives in :mod:`repro_torch.core.torchopt.matching`, which
packages this forward auction and a forward-reverse variant behind the
``MATCHERS`` registry with an n- and spread-aware ε schedule. This module
keeps the original call surface: ``auction_maximize(W)`` is the registry's
``"auction"`` matcher with its n-aware defaults. There is no ``use_kernel``
knob: W's device decides, as everywhere in the port (a CUDA W reaches
``auction_rounds`` at n ≤ 128 and ``masked_row_top2`` a round above).
"""

from __future__ import annotations

import torch

from ...kernels.backend import resolve_device
from .matching import MATCHERS, get_matcher, list_matchers, match_auction

_NEG = -1e30  # re-exported for back-compat


def _as_tensor(W, device) -> torch.Tensor:
    if isinstance(W, torch.Tensor):
        return W
    return torch.as_tensor(W, dtype=torch.float32, device=resolve_device(device))


def auction_maximize(W, *, num_phases: int | None = None, max_iters: int | None = None,
                     device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Max-weight assignment of the square matrix W (n, n).

    Returns ``(perm, converged)`` with ``perm[i] = j``, on W's device. A W
    that is not a tensor goes to ``device`` (None: CUDA). ``num_phases`` and
    ``max_iters`` default to the n-aware schedule of ``matching``.
    """
    res = match_auction(_as_tensor(W, device)[None], num_phases=num_phases, max_iters=max_iters)
    return res.perm[0], res.converged[0]


def auction_maximize_batch(W, **kw) -> tuple[torch.Tensor, torch.Tensor]:
    """The auction on each of a batch of matrices (B, n, n) → (B, n)."""
    device = kw.pop("device", None)
    res = match_auction(_as_tensor(W, device), **kw)
    return res.perm, res.converged


__all__ = [
    "MATCHERS",
    "auction_maximize",
    "auction_maximize_batch",
    "get_matcher",
    "list_matchers",
]
