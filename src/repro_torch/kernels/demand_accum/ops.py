"""Public op: accumulate (src, dst, w) traffic events into an (n, n) demand matrix.

``demand_accum`` wraps ``csrc/demand_accum.cu`` (the counterpart of
``repro.kernels.demand_accum.kernel.demand_accum_pallas``): a CUDA tensor
launches the kernel, a CPU tensor takes the plain ``demand_accum_ref``.
``demand_accum.launches`` counts kernel launches. No path of the system
calls it yet; it is the port of the reference's op.
"""

from __future__ import annotations

import torch

from .. import backend
from .ref import demand_accum_ref

_INDEX_TYPES = {torch.int32: 0, torch.int64: 1}


def demand_accum(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor, *, n: int) -> torch.Tensor:
    """(n, n) float32 demand from T events: D[src[t], dst[t]] += w[t].

    ``src``/``dst`` are (T,) int32 or int64, ``w`` (T,) of any float type
    (summed in float32). Events with an index outside ``[0, n)`` add
    nothing; ``T = 0`` gives zeros. On the card the sum's order varies from
    run to run (float atomics).
    """
    if src.dim() != 1 or src.shape != dst.shape or src.shape != w.shape:
        raise ValueError(f"need src, dst, w of one shape (T,); got {tuple(src.shape)}, "
                         f"{tuple(dst.shape)}, {tuple(w.shape)}")
    if n < 1:
        raise ValueError(f"n must be positive, got {n}")
    if not (src.device == dst.device == w.device):
        raise ValueError("demand_accum inputs lie on different devices")
    if src.dtype not in _INDEX_TYPES or dst.dtype != src.dtype:
        raise TypeError(f"demand_accum takes int32 or int64 indices of one type; got {src.dtype}, {dst.dtype}")
    if not w.dtype.is_floating_point:
        raise TypeError(f"demand_accum takes float weights; got {w.dtype}")
    if src.device.type == "cpu":
        return demand_accum_ref(src, dst, w, n)
    if src.device.type != "cuda":
        raise ValueError(f"unsupported device {src.device}")
    out = torch.zeros((n, n), dtype=torch.float32, device=src.device)
    T = src.shape[0]
    if T:
        src, dst = src.contiguous(), dst.contiguous()
        w = w.to(torch.float32).contiguous()
        backend.launch(
            "demand_accum_launch",
            src.data_ptr(), dst.data_ptr(), w.data_ptr(), out.data_ptr(),
            T, n, _INDEX_TYPES[src.dtype], backend.current_stream(src),
        )
        demand_accum.launches += 1
    return out


demand_accum.launches = 0
