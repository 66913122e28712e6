"""Plain PyTorch version of demand-matrix accumulation from traffic events.

The semantics are those of the reference's ``repro.kernels.demand_accum.ops.
demand_accum``: an event whose ``src`` or ``dst`` lies outside ``[0, n)``
adds nothing (the reference's one-hot never matches it), and ``w`` of any
float type is summed in float32.
"""

from __future__ import annotations

import torch


def in_range(src: torch.Tensor, dst: torch.Tensor, n: int) -> torch.Tensor:
    """Boolean mask of the events whose cell lies inside the (n, n) matrix."""
    return (src >= 0) & (src < n) & (dst >= 0) & (dst < n)


def demand_accum_ref(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor, n: int) -> torch.Tensor:
    """D (n, n) float32 with D[src[t], dst[t]] += w[t] for the in-range events."""
    keep = in_range(src, dst, n)
    D = torch.zeros((n, n), dtype=torch.float32, device=src.device)
    return D.index_put_((src[keep].long(), dst[keep].long()), w[keep].float(), accumulate=True)
