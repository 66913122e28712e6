"""Plain PyTorch version of the auction bid top-2 reduction.

Same float order and tie rule as ``repro.kernels.auction_bid.ref``: one
subtraction ``W − p`` per entry, first-index argmax, and the second best
taken over the other columns with the winner masked to ``NEG``.
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
