"""Wrapper for the fused auction kernels (``csrc/auction_fused.cu``).

A CUDA tensor launches one of two kernels, each running every phase and
round of a lane's auction in one launch; a CPU tensor takes the plain
version in ``ref.py``. :func:`fused_kernel_for` picks the kernel by n:

- ``"cluster"``: one thread block cluster of ``cluster`` CTAs a lane, each
  CTA holding its share of W's rows in shared memory. It serves every n whose
  share (plus the CTA's column arrays) fits in one block's 227 KB:
  n ≤ ``cluster_max_n(8)`` = 645 at the portable 8 CTAs, ≤ 893 at 16.
- ``"block"``: one block of 1024 threads a lane, W streamed from L2; every
  larger n.

Neither pads: the kernels mask their ragged edges themselves.
``fused_auction.launches`` counts launches of either kernel,
``fused_auction.cluster_launches`` those of the cluster kernel.
"""

from __future__ import annotations

import torch

from .. import backend
from .ref import fused_auction_ref

CLUSTER = 8  # CTAs a lane: the largest portable cluster
MAX_CLUSTER = 16  # the largest the H100 allows, as a non-portable size
SMEM_PER_BLOCK = 232448  # 227 KB, the most shared memory one block may use
_HEAD = 16  # the kernels' bid total and unassigned count


def cluster_smem_bytes(n: int, cluster: int) -> int:
    """Shared memory of one CTA of the cluster kernel (``auction_fused.cu``'s
    ``cluster_smem_bytes``): R = ⌈n / cluster⌉ rows of W, a replica of the
    prices, r2c and c2r, a packed bid word a column and two inboxes of one
    8-byte bid a row."""
    R = -(-n // cluster)
    return _HEAD + 36 * n + 4 * R * n


def cluster_max_n(cluster: int = CLUSTER) -> int:
    """The largest n the cluster kernel serves at this cluster size."""
    n = 1
    while cluster_smem_bytes(n + 1, cluster) <= SMEM_PER_BLOCK:
        n += 1
    return n


def fused_kernel_for(n: int, cluster: int = CLUSTER) -> str:
    """``"cluster"`` where a lane's W fits in ``cluster`` CTAs' shared memory,
    else ``"block"``."""
    _check_cluster(cluster)
    return "cluster" if cluster_smem_bytes(n, cluster) <= SMEM_PER_BLOCK else "block"


def _check_cluster(cluster: int) -> None:
    if cluster not in (1, 2, 4, 8, 16):
        raise ValueError(f"cluster must be a power of two in 1..{MAX_CLUSTER}, got {cluster}")


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
    kernel: str | None = None,
    cluster: int = CLUSTER,
):
    """Run the ε-scaling auction; returns ``(r2c, c2r, prices, rounds,
    bids)`` as documented on ``ref.fused_auction_ref``. ``kernel`` names the
    kernel (``None``: :func:`fused_kernel_for`); ``"cluster"`` raises where
    W does not fit."""
    _check(W, prices0, eps, max_iters)
    n = W.shape[1]
    chosen = fused_kernel_for(n, cluster) if kernel is None else kernel
    if chosen not in ("cluster", "block"):
        raise ValueError(f"kernel must be 'cluster' or 'block', got {kernel!r}")
    if chosen == "cluster" and fused_kernel_for(n, cluster) != "cluster":
        raise ValueError(f"n = {n} does not fit the cluster kernel at {cluster} CTAs "
                         f"(n ≤ {cluster_max_n(cluster)})")
    if W.device.type == "cpu":
        return fused_auction_ref(W, prices0, eps, max_iters=max_iters)
    if W.device.type != "cuda":
        raise ValueError(f"unsupported device {W.device}")
    if not (W.is_contiguous() and prices0.is_contiguous() and eps.is_contiguous()):
        raise ValueError("fused_auction needs contiguous W, prices0 and eps")
    B = W.shape[0]
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
        B, n, eps.shape[1], int(max_iters), cluster if chosen == "cluster" else 0,
        backend.current_stream(W),
    )
    fused_auction.launches += 1
    if chosen == "cluster":
        fused_auction.cluster_launches += 1
    return r2c, c2r, prices, rounds, bids


fused_auction.launches = 0
fused_auction.cluster_launches = 0
