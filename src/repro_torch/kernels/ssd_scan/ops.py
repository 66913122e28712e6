"""Public SSD op: the CUDA intra-chunk kernel plus the cross-chunk glue.

``ssd_chunk`` wraps ``csrc/ssd_chunk.cu`` (the counterpart of
``repro.kernels.ssd_scan.kernel.ssd_chunk_pallas``): a CUDA tensor launches
the kernel, a CPU tensor takes the plain ``ssd_chunk_ref``.
``ssd_chunk.launches`` counts kernel launches.

``ssd_scan`` follows the reference's ``_ssd_fwd_impl``: the chunk pass, the
cross-chunk recurrence ``H_out(c) = gate_c · H_in(c) + state_c`` (here in its
closed form, one batched product with the decays between chunks, where the
reference runs an associative scan), and the inter-chunk correction
``y += (C ⊙ exp(la)) @ H_in``. It is a ``torch.autograd.Function`` whose
backward recomputes through ``ssd_chunked``, the same function with the
plain ``ssd_chunk_ref`` in place of the kernel (the counterpart of the
reference's ``ssd_chunked``, which its training paths differentiate), so
``h0`` gets its gradient too. ``ssd_decode_step`` is the one-token serving
update.
"""

from __future__ import annotations

import torch

from .. import backend
from .ref import ssd_chunk_ref, ssd_decode_step_ref

MAX_DIM = 128  # the kernel's bound on the chunk length, N and P
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _pick_chunk(S: int) -> int:
    for c in (128, 64, 32, 16, 8, 4, 2, 1):
        if S % c == 0:
            return c
    return 1


def ssd_chunk(xd: torch.Tensor, loga: torch.Tensor, B: torch.Tensor, C: torch.Tensor, chunk: int):
    """Intra-chunk pass → (y_intra (BH, S, P), states (BH, nc, N, P), gates (BH, nc)), float32."""
    if xd.dim() != 3 or loga.dim() != 2 or B.dim() != 3 or B.shape != C.shape:
        raise ValueError(f"need xd (BH, S, P), loga (BH, S), B/C (BH, S, N); got {tuple(xd.shape)}, "
                         f"{tuple(loga.shape)}, {tuple(B.shape)}, {tuple(C.shape)}")
    BH, S, P = xd.shape
    N = B.shape[-1]
    if tuple(loga.shape) != (BH, S) or B.shape[:2] != xd.shape[:2]:
        raise ValueError(f"shape mismatch: xd {tuple(xd.shape)}, loga {tuple(loga.shape)}, B {tuple(B.shape)}")
    if chunk < 1 or S % chunk:
        raise ValueError(f"S={S} not divisible by chunk={chunk}")
    if not (xd.device == loga.device == B.device == C.device):
        raise ValueError("ssd_chunk inputs lie on different devices")
    if xd.device.type == "cpu":
        return ssd_chunk_ref(xd, loga, B, C, chunk)
    if xd.device.type != "cuda":
        raise ValueError(f"unsupported device {xd.device}")
    if xd.dtype not in _DTYPES or not (xd.dtype == B.dtype == C.dtype) or loga.dtype != torch.float32:
        raise TypeError(f"ssd_chunk takes xd/B/C in float32 or bfloat16 (one type) and loga in float32; "
                        f"got {xd.dtype}, {B.dtype}, {C.dtype}, {loga.dtype}")
    if max(chunk, N, P) > MAX_DIM:
        raise ValueError(f"ssd_chunk takes chunk, N, P ≤ {MAX_DIM}; got {chunk}, {N}, {P}")
    if not all(t.is_contiguous() for t in (xd, loga, B, C)):
        raise ValueError("ssd_chunk needs contiguous inputs")
    nc = S // chunk
    y = torch.empty((BH, S, P), dtype=torch.float32, device=xd.device)
    states = torch.empty((BH * nc, N, P), dtype=torch.float32, device=xd.device)  # row b·nc + c
    gates = torch.empty((BH, nc), dtype=torch.float32, device=xd.device)
    if xd.numel():
        backend.launch(
            "ssd_chunk_launch",
            xd.data_ptr(), loga.data_ptr(), B.data_ptr(), C.data_ptr(),
            y.data_ptr(), states.data_ptr(), gates.data_ptr(),
            BH, S, chunk, N, P, _DTYPES[xd.dtype], backend.current_stream(xd),
        )
        ssd_chunk.launches += 1
    return y, states.view(BH, nc, N, P), gates


ssd_chunk.launches = 0


def _ssd_fwd(xd, loga, B, C, h0, chunk_fn=ssd_chunk):
    BH, S, P = xd.shape
    N = B.shape[-1]
    chunk = _pick_chunk(S)
    nc = S // chunk
    y_intra, states, _ = chunk_fn(xd, loga, B, C, chunk)
    la = torch.cumsum(loga.float().reshape(BH, nc, chunk), dim=-1)
    # Log-decay from the start to the start of chunk c, for c = 0..nc. The
    # gates are exp(la[..., -1]); their logs would underflow to −inf.
    lx = torch.cat([torch.zeros((BH, 1), device=xd.device), torch.cumsum(la[..., -1], dim=-1)], dim=1)
    # H(c) = exp(lx_c)·h0 + Σ_{c' < c} exp(lx_c − lx_{c'+1})·state_c': the state
    # entering chunk c; H(nc) is the final state.
    diff = lx[:, :, None] - lx[:, None, 1:]  # (BH, nc+1, nc)
    before = torch.tril(torch.ones((nc + 1, nc), dtype=torch.bool, device=xd.device), diagonal=-1)
    decay = torch.where(before, torch.exp(torch.clamp(diff, max=0.0)), 0.0)
    H = (decay @ states.reshape(BH, nc, N * P)).reshape(BH, nc + 1, N, P)
    H = H + torch.exp(lx)[..., None, None] * h0.float()[:, None]
    h_in, hT = H[:, :nc], H[:, nc]
    Cc = C.reshape(BH, nc, chunk, N)
    y_inter = torch.einsum("bcln,bcnp->bclp", Cc * torch.exp(la)[..., None], h_in).reshape(BH, S, P)
    return (y_intra + y_inter).to(xd.dtype), hT


class _SSD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xd, loga, B, C, h0):
        ctx.save_for_backward(xd, loga, B, C, h0)
        return _ssd_fwd(xd.contiguous(), loga.contiguous(), B.contiguous(), C.contiguous(), h0)

    @staticmethod
    def backward(ctx, gy, ghT):
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            y, hT = ssd_chunked(*inputs)
            return torch.autograd.grad((y, hT), inputs, (gy, ghT))


def ssd_chunked(xd: torch.Tensor, loga: torch.Tensor, B: torch.Tensor, C: torch.Tensor, h0: torch.Tensor):
    """The differentiable plain chunked SSD: ``ssd_scan``'s forward with
    ``ssd_chunk_ref`` in place of the kernel (no launch on any device)."""
    return _ssd_fwd(xd.contiguous(), loga.contiguous(), B.contiguous(), C.contiguous(), h0, ssd_chunk_ref)


def ssd_scan(xd: torch.Tensor, loga: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
             h0: torch.Tensor | None = None):
    """SSD sequence transform → (y (BH, S, P) in xd's type, final state (BH, N, P) f32)."""
    BH, S, P = xd.shape
    if h0 is None:
        h0 = torch.zeros((BH, B.shape[-1], P), dtype=torch.float32, device=xd.device)
    return _SSD.apply(xd, loga, B, C, h0)


def ssd_decode_step(h, xd, loga, B, C):
    """One-token state update (BH, N, P), (BH, P), (BH,), (BH, N), (BH, N)."""
    return ssd_decode_step_ref(h, xd, loga, B, C)
