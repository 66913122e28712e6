"""Model primitives: norms, rotary embeddings, the causal conv, initializers.

Counterpart of ``repro.models.layers``, with the same float order. Weights
keep the reference's 2-D layout ``(d_in, d_out)``, so ``dense`` is
``x @ w`` and the reference's parameters load without a transpose.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in float32 with the ``x·(1 + w)`` gain, cast back to x's type."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


# ---------------------------------------------------------------------------
# Rotary position embeddings (standard + multimodal sections).
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4,
               sections: tuple[int, ...] = ()) -> torch.Tensor:
    """x: (B, H, S, D); positions: (B, S), or (B, S, len(sections)) for M-RoPE.

    With ``sections`` (Qwen2-VL M-RoPE) the half-dim frequency bands split
    into groups, each rotated by its own position stream; identical streams
    reduce exactly to standard RoPE.
    """
    B, H, S, D = x.shape
    half = D // 2
    inv = rope_freqs(D, theta, device=x.device)
    if sections:
        if sum(sections) != half or positions.dim() != 3 or positions.shape[-1] != len(sections):
            raise ValueError(f"M-RoPE sections {sections} do not fit head_dim {D} / positions {tuple(positions.shape)}")
        pos = torch.cat([positions[..., i:i + 1].expand(B, S, sec) for i, sec in enumerate(sections)], dim=-1)
        ang = pos.float() * inv[None, None, :]
    else:
        if positions.dim() == 3:
            positions = positions[..., 0]
        ang = positions[..., None].float() * inv[None, None, :]
    cos = torch.cos(ang)[:, None]  # (B, 1, S, half)
    sin = torch.sin(ang)[:, None]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, state: torch.Tensor | None = None):
    """Depthwise causal conv. x: (B, S, C); w: (K, C). Returns (y, new_state).

    ``state`` holds the last K−1 inputs of the previous segment (B, K−1, C);
    None means zero history. Taps are summed in the reference's order.
    """
    B, S, C = x.shape
    K = w.shape[0]
    if state is None:
        state = torch.zeros((B, K - 1, C), dtype=x.dtype, device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)  # (B, S+K−1, C)
    wx = w.to(x.dtype)
    y = xp[:, 0:S, :] * wx[0]
    for i in range(1, K):
        y = y + xp[:, i:i + S, :] * wx[i]
    new_state = xp[:, S:, :] if K > 1 else state
    return y, new_state


# ---------------------------------------------------------------------------
# Initializers: an explicit generator, the reference's scales.
# ---------------------------------------------------------------------------

def winit(gen: torch.Generator, shape: tuple[int, ...], scale: float | None = None,
          dtype=torch.float32, device=None) -> torch.Tensor:
    fan_in = shape[0] if len(shape) > 1 else shape[-1]
    scale = fan_in ** -0.5 if scale is None else scale
    return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)


def zinit(shape: tuple[int, ...], dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=device)
