"""§IV lower bounds for a batch of demand matrices (PyTorch port).

Counterpart of ``repro.core.jaxopt.lower_bounds_jax``: all ``2n`` lines
(rows, then columns) of every lane are bounded at once — Theorem 1 for every
line, Theorem 2 where a line has exactly ``s`` nonzeros — and Property 2
takes the max over lines.
"""

from __future__ import annotations

import torch


def lower_bound(D: torch.Tensor, s: int, delta: torch.Tensor) -> torch.Tensor:
    """(B,) §IV lower bounds of ``D`` (B, n, n) with per-lane ``delta`` (B,)."""
    D = D.to(torch.float32)
    delta = delta.to(torch.float32)
    B, n, _ = D.shape
    lines = torch.cat([D, D.transpose(1, 2)], dim=1)   # (B, 2n, n)
    k = (lines > 0).sum(dim=2)
    w = lines.sum(dim=2, dtype=torch.float64).float()  # same on every device
    d = delta[:, None]
    lb1 = (w + d * torch.clamp_min(k, s)) / s

    # Theorem 2: sorted descending, zeros padding each line out to s²+1.
    x = torch.sort(lines, dim=2, descending=True).values
    width = max(n, s * s + 1)
    x = torch.nn.functional.pad(x, (0, width - n))
    opt0 = x[:, :, 0]
    opt1 = torch.maximum(torch.maximum(x[:, :, 1], (w + d) / s), x[:, :, s - 1] + d)
    inner = torch.minimum(opt0, opt1)
    if s >= 2:  # m in [2, s²]: x_{m+1} is column m (0-based)
        m = torch.arange(2, s * s + 1, device=D.device)
        opts_m = torch.maximum(x[:, :, m], (w[:, :, None] + m * d[:, :, None]) / s)
        inner = torch.minimum(inner, opts_m.amin(dim=2))
    lb2 = d + inner

    per_line = torch.where(k == s, torch.maximum(lb1, lb2), lb1)
    per_line = torch.where(k == 0, 0.0, per_line)
    return per_line.amax(dim=1)
