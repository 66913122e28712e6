"""Wrapper for the fused auction kernel (``csrc/auction_fused.cu``).

A CUDA tensor launches the kernel, which runs every phase and round of a
lane's auction in one thread block; a CPU tensor takes the plain version in
``ref.py``. Neither pads: the kernel masks its ragged edge itself, so both
work at the caller's n. ``fused_auction.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from .. import backend
from .ref import fused_auction_ref


def _check(W, prices0, eps, max_iters) -> None:
    if W.dim() != 3 or W.shape[1] != W.shape[2] or W.shape[1] < 1:
        raise ValueError(f"need W (B, n, n), got {tuple(W.shape)}")
    B, n, _ = W.shape
    if tuple(prices0.shape) != (B, n):
        raise ValueError(f"prices0 must be {(B, n)}, got {tuple(prices0.shape)}")
    if eps.dim() != 2 or eps.shape[0] != B or eps.shape[1] < 1:
        raise ValueError(f"eps must be (B, P) with P >= 1, got {tuple(eps.shape)}")
    for name, t in (("W", W), ("prices0", prices0), ("eps", eps)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != W.device:
            raise ValueError(f"{name} on {t.device}, W on {W.device}")
    if max_iters < 0:
        raise ValueError(f"max_iters must be >= 0, got {max_iters}")


def fused_auction(
    W: torch.Tensor,
    prices0: torch.Tensor,
    eps: torch.Tensor,
    *,
    max_iters: int,
):
    """Run the ε-scaling auction; returns ``(r2c, c2r, prices, rounds,
    bids)`` as documented on ``ref.fused_auction_ref``."""
    _check(W, prices0, eps, max_iters)
    if W.device.type == "cpu":
        return fused_auction_ref(W, prices0, eps, max_iters=max_iters)
    if W.device.type != "cuda":
        raise ValueError(f"unsupported device {W.device}")
    if not (W.is_contiguous() and prices0.is_contiguous() and eps.is_contiguous()):
        raise ValueError("fused_auction needs contiguous W, prices0 and eps")
    B, n, _ = W.shape
    dev = W.device
    r2c = torch.empty((B, n), dtype=torch.int32, device=dev)
    c2r = torch.empty_like(r2c)
    prices = torch.empty((B, n), dtype=torch.float32, device=dev)
    rounds = torch.empty((B,), dtype=torch.int32, device=dev)
    bids = torch.empty((B,), dtype=torch.int64, device=dev)
    backend.launch(
        "auction_fused_launch",
        W.data_ptr(), prices0.data_ptr(), eps.data_ptr(), r2c.data_ptr(),
        c2r.data_ptr(), prices.data_ptr(), rounds.data_ptr(), bids.data_ptr(),
        B, n, eps.shape[1], int(max_iters), backend.current_stream(W),
    )
    fused_auction.launches += 1
    return r2c, c2r, prices, rounds, bids


fused_auction.launches = 0
