"""Wrappers for the auction bid kernels.

``masked_row_top2`` wraps ``csrc/auction_bid.cu``, one bidding round's top-2
reduction (the counterpart of the reference's ``_bid_kernel``).
``auction_rounds`` wraps ``csrc/auction_rounds.cu``, which runs every phase
and bidding round of a matcher call in one launch; it is what the matchers
call at n ≤ 128. A CUDA tensor launches the kernel; a CPU tensor takes the
plain version in ``ref.py``. Each wrapper's ``launches`` counts its kernel
launches.
"""

from __future__ import annotations

import torch

from .. import backend
from .ref import auction_rounds_ref, masked_row_top2_ref

ROUNDS_MAX_N = 128  # W stays in one block's shared memory


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


def _check_rounds(W: torch.Tensor, eps: torch.Tensor, max_iters: int) -> None:
    if W.dim() != 3 or W.shape[1] != W.shape[2] or W.shape[1] < 1:
        raise ValueError(f"need W (B, n, n), got {tuple(W.shape)}")
    B, n, _ = W.shape
    if n > ROUNDS_MAX_N:
        raise ValueError(f"auction_rounds takes n <= {ROUNDS_MAX_N}, got {n}")
    if eps.dim() != 2 or eps.shape[0] != B or eps.shape[1] < 1:
        raise ValueError(f"eps must be (B, P) with P >= 1, got {tuple(eps.shape)}")
    for name, t in (("W", W), ("eps", eps)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != W.device:
            raise ValueError(f"{name} on {t.device}, W on {W.device}")
        if not t.is_contiguous():
            raise ValueError(f"auction_rounds needs a contiguous {name}")
    if not 0 <= max_iters < 2**31:
        raise ValueError(f"max_iters must be in [0, 2**31), got {max_iters}")


def auction_rounds(W: torch.Tensor, eps: torch.Tensor, max_iters: int, *, reverse: bool):
    """Every ε-phase and bidding round of the forward (``reverse=False``) or
    forward-reverse auction on each lane of ``W`` (B, n, n), n ≤ 128, under
    the (B, P) ε schedule ``eps``. Returns ``(row2col, col2row, prices,
    rounds, bids)`` as documented on ``ref.auction_rounds_ref``."""
    _check_rounds(W, eps, max_iters)
    if W.device.type == "cpu":
        return auction_rounds_ref(W, eps, max_iters, reverse=reverse)
    if W.device.type != "cuda":
        raise ValueError(f"unsupported device {W.device}")
    B, n, _ = W.shape
    r2c = torch.empty((B, n), dtype=torch.int32, device=W.device)
    c2r = torch.empty_like(r2c)
    prices = torch.empty((B, n), dtype=torch.float32, device=W.device)
    rounds = torch.empty((B,), dtype=torch.int32, device=W.device)
    bids = torch.empty((B,), dtype=torch.int64, device=W.device)
    backend.launch(
        "auction_rounds_launch",
        W.data_ptr(), eps.data_ptr(), r2c.data_ptr(), c2r.data_ptr(), prices.data_ptr(),
        rounds.data_ptr(), bids.data_ptr(), B, n, eps.shape[1], int(max_iters), int(reverse),
        backend.current_stream(W),
    )
    auction_rounds.launches += 1
    return r2c.long(), c2r.long(), prices, rounds.long(), bids


auction_rounds.launches = 0
