"""Public attention op: the CUDA flash kernel forward, a plain-recompute backward.

``flash_attention`` wraps ``csrc/flash_attention.cu`` (the counterpart of
``repro.kernels.flash_attention.kernel.flash_attention_pallas``): a CUDA
tensor launches the kernel (bfloat16 on the tensor cores, wgmma fed by TMA;
float32 on the CUDA cores), a CPU tensor takes the plain ``mha_ref``.
``flash_attention.launches`` counts kernel launches. A dry run's counter
(``backend.cost_hook``) counts a call at the kernel's cost, not at its
plain version's.

``mha`` is what the model calls: a ``torch.autograd.Function`` whose forward
is ``flash_attention`` and whose backward recomputes through ``mha_ref``,
as the reference's ``custom_vjp`` does. Unlike the reference wrapper it does
not pad the head dim to 128: the kernel takes D in {32, 64, 128} as it is.
On DTensors (the sharded step, ``parallel/steps.py``) it runs on each
rank's shard through ``local_map``: batch over the data axes and heads over
the model axis where they divide, the rest gathered first.
"""

from __future__ import annotations

import torch

from .. import backend
from .ref import mha_ref

HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"need q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, _, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or Hq % k.shape[1]:
        raise ValueError(f"q {tuple(q.shape)} does not fit k/v {tuple(k.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v types differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    window: int | None = None, scale: float | None = None) -> torch.Tensor:
    """GQA attention, q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D) → (B, Hq, Sq, D).

    Query head h reads KV head ``h // (Hq // Hkv)``; queries are aligned to
    the end of the KV stream. A query row that no key may attend (only
    possible with Sq > Sk under ``causal``: the first Sq − Sk rows) comes
    out 0 on every device, as from the reference kernel: the CUDA kernel
    writes 0 there, and the CPU path zeroes the rows where ``mha_ref``
    would give the mean of V.
    """
    _check(q, k, v)
    if window is not None and window < 1:
        raise ValueError(f"window must be at least 1, got {window}")
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    scale = D ** -0.5 if scale is None else float(scale)
    if backend.cost_hook is not None:
        return backend.cost_hook(
            "flash_attention", dict(B=B, Hq=Hq, Hkv=Hkv, Sq=Sq, Sk=Sk, D=D, causal=causal, window=window,
                                    itemsize=q.element_size()),
            lambda: _flash_attention(q, k, v, causal, window, scale))
    return _flash_attention(q, k, v, causal, window, scale)


def _flash_attention(q, k, v, causal, window, scale):
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if q.device.type == "cpu":
        o = mha_ref(q, k, v, causal=causal, window=window, scale=scale)
        if causal and Sq > Sk:
            o[:, :, :Sq - Sk] = 0
        return o
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got {q.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention takes head_dim in {HEAD_DIMS}, got {D}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention needs contiguous q, k, v")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention needs 16-byte aligned bfloat16 q, k, v (the TMA reads them)")
    o = torch.empty_like(q)
    if q.numel():
        backend.launch(
            "flash_attention_launch",
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            B * Hq, Hq // Hkv, Sq, Sk, D, scale, int(causal),
            -1 if window is None else int(window), _DTYPES[q.dtype], backend.current_stream(q),
        )
        flash_attention.launches += 1
    return o


flash_attention.launches = 0


class _MHA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        ctx.save_for_backward(q, k, v)
        ctx.opts = (causal, window, scale)
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=causal, window=window, scale=scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        causal, window, scale = ctx.opts
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in (q, k, v)]
            out = mha_ref(*inputs, causal=causal, window=window, scale=scale)
            grads = torch.autograd.grad(out, inputs, g)
        return (*(t.contiguous() for t in grads), None, None, None)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
        window: int | None = None, scale: float | None = None) -> torch.Tensor:
    """Grouped-query attention. q: (B, Hq, Sq, D); k/v: (B, Hkv, Sk, D)."""
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    from ...parallel.sharding import head_placements, is_dtensor, local_call

    if is_dtensor(q):
        pl = head_placements(q.device_mesh, q.shape[0], k.shape[1])
        return local_call(lambda q, k, v: _MHA.apply(q, k, v, causal, window, scale), (pl, pl, pl), pl, q, k, v)
    return _MHA.apply(q, k, v, causal, window, scale)
