"""Plain PyTorch versions of the Mamba-2 SSD recurrence.

Per (batch·head): H_t = a_t · H_{t−1} + B_tᵀ ⊗ xd_t, y_t = C_t @ H_t with
decay a_t = exp(loga_t) ∈ (0, 1] and state H ∈ (N, P). Shapes: xd (BH, S, P),
loga (BH, S), B/C (BH, S, N) → y (BH, S, P).

``ssd_ref`` (the exact sequential scan) and ``ssd_decode_step_ref`` are the
counterparts of ``repro.kernels.ssd_scan.ref``; ``ssd_chunk_ref`` is the
counterpart of ``repro.kernels.ssd_scan.ops._chunk_jnp``, the plain version
of the ``ssd_chunk`` kernel.
"""

from __future__ import annotations

import torch


def ssd_decode_step_ref(h: torch.Tensor, xd: torch.Tensor, loga: torch.Tensor, B: torch.Tensor,
                        C: torch.Tensor):
    """One-token update: h (BH, N, P), xd (BH, P), loga (BH,), B/C (BH, N)."""
    h = torch.exp(loga)[:, None, None] * h + torch.einsum("bn,bp->bnp", B.float(), xd.float())
    y = torch.einsum("bn,bnp->bp", C.float(), h)
    return h, y.to(xd.dtype)


def ssd_ref(xd: torch.Tensor, loga: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
            h0: torch.Tensor | None = None):
    """Exact sequential scan → (y (BH, S, P) in xd's type, final state (BH, N, P) f32)."""
    BH, S, P = xd.shape
    N = B.shape[-1]
    h = torch.zeros((BH, N, P), dtype=torch.float32, device=xd.device) if h0 is None else h0.float()
    ys = []
    for t in range(S):
        h = torch.exp(loga[:, t])[:, None, None] * h + torch.einsum(
            "bn,bp->bnp", B[:, t].float(), xd[:, t].float())
        ys.append(torch.einsum("bn,bnp->bp", C[:, t].float(), h))
    return torch.stack(ys, dim=1).to(xd.dtype), h


def ssd_chunk_ref(xd: torch.Tensor, loga: torch.Tensor, B: torch.Tensor, C: torch.Tensor, chunk: int):
    """The intra-chunk pass for every (BH, chunk) at once, in float32.

    Returns ``y_intra`` (BH, S, P) = ((C Bᵀ) ⊙ causal exp(la_t − la_u)) · xd
    within each chunk, ``states`` (BH, nc, N, P) = (B ⊙ exp(la_L − la))ᵀ · xd
    and ``gates`` (BH, nc) = exp(la_L), with la the inclusive cumulative sum
    of loga inside the chunk. Every exp is of a non-positive number.
    """
    BH, S, P = xd.shape
    N = B.shape[-1]
    nc = S // chunk
    xd_c = xd.reshape(BH, nc, chunk, P).float()
    la = torch.cumsum(loga.reshape(BH, nc, chunk).float(), dim=-1)
    B_c = B.reshape(BH, nc, chunk, N).float()
    C_c = C.reshape(BH, nc, chunk, N).float()
    la_tot = la[..., -1]
    diff = la[..., :, None] - la[..., None, :]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=xd.device))
    decay = torch.where(tri, torch.exp(torch.clamp(diff, max=0.0)), 0.0)
    scores = torch.einsum("bcln,bcmn->bclm", C_c, B_c) * decay
    y_intra = torch.einsum("bclm,bcmp->bclp", scores, xd_c).reshape(BH, S, P)
    to_end = torch.exp(la_tot[..., None] - la)
    states = torch.einsum("bcln,bclp->bcnp", B_c * to_end[..., None], xd_c)
    gates = torch.exp(la_tot)
    return y_intra, states, gates
