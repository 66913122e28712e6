"""Plain PyTorch oracle for GQA attention (causal / sliding-window / full).

Counterpart of ``repro.kernels.flash_attention.ref.mha_ref``: scores in
float32, the reference's mask with queries aligned to the end of the KV
stream, a max-shifted softmax. It is the kernel's plain version and the CPU
path of ``ops.mha``.
"""

from __future__ import annotations

import torch

NEG = -1e30


def _mask(sq: int, sk: int, causal: bool, window: int | None, device) -> torch.Tensor:
    """(sq, sk) boolean keep-mask; query i sits at absolute position sk − sq + i."""
    q_pos = torch.arange(sq, device=device)[:, None] + (sk - sq)
    k_pos = torch.arange(sk, device=device)[None, :]
    keep = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        keep &= k_pos <= q_pos
    if window is not None:
        keep &= k_pos > q_pos - window
    return keep


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
            window: int | None = None, scale: float | None = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D), Hq % Hkv == 0 → (B, Hq, Sq, D)."""
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    if Hq % Hkv:
        raise ValueError(f"{Hq} query heads are not a multiple of {Hkv} KV heads")
    group = Hq // Hkv
    scale = D ** -0.5 if scale is None else scale
    kk = k.repeat_interleave(group, dim=1)
    vv = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk.float()) * scale
    keep = _mask(Sq, Sk, causal, window, q.device)
    s = torch.where(keep[None, None], s, NEG)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vv.float())
    return out.to(q.dtype)
