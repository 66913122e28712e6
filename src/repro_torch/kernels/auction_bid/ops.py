"""Wrapper for the auction bid kernel (``csrc/auction_bid.cu``).

A CUDA tensor launches the kernel; a CPU tensor takes the plain version in
``ref.py``. ``masked_row_top2.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from .. import backend
from .ref import masked_row_top2_ref


def _check(W: torch.Tensor, prices: torch.Tensor) -> None:
    if W.dim() != 3 or prices.dim() != 2:
        raise ValueError(f"need W (B, n, m) and prices (B, m), got {tuple(W.shape)}, {tuple(prices.shape)}")
    B, n, m = W.shape
    if tuple(prices.shape) != (B, m) or n < 1 or m < 1:
        raise ValueError(f"shape mismatch: W {tuple(W.shape)}, prices {tuple(prices.shape)}")
    if W.dtype != torch.float32 or prices.dtype != torch.float32:
        raise TypeError(f"need float32, got {W.dtype}, {prices.dtype}")
    if W.device != prices.device:
        raise ValueError(f"W on {W.device}, prices on {prices.device}")


def masked_row_top2(W: torch.Tensor, prices: torch.Tensor):
    """Per-row ``(v1, v2, j1)`` of ``V = W − prices``; see ``ref.py``."""
    _check(W, prices)
    if W.device.type == "cpu":
        return masked_row_top2_ref(W, prices)
    if W.device.type != "cuda":
        raise ValueError(f"unsupported device {W.device}")
    if not (W.is_contiguous() and prices.is_contiguous()):
        raise ValueError("masked_row_top2 needs contiguous W and prices")
    B, n, m = W.shape
    v1 = torch.empty((B, n), dtype=torch.float32, device=W.device)
    v2 = torch.empty_like(v1)
    j1 = torch.empty((B, n), dtype=torch.int32, device=W.device)
    backend.launch(
        "auction_bid_launch",
        W.data_ptr(), prices.data_ptr(), v1.data_ptr(), v2.data_ptr(),
        j1.data_ptr(), B, n, m, backend.current_stream(W),
    )
    masked_row_top2.launches += 1
    return v1, v2, j1


masked_row_top2.launches = 0
