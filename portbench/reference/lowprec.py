"""The control: the reference put in the program's place and computed one
precision below the configuration's float32, in bfloat16.

The demand is rounded to bfloat16 before the reference solves it, and the
weights it returns are rounded to bfloat16 again, as a bfloat16 solver
would hold them. The check must find such a schedule not correct.
"""

from __future__ import annotations

import numpy as np

from .spectra import spectra


def to_bf16(x) -> np.ndarray:
    """Round to the nearest bfloat16 (ties to even), returned as float64."""
    f = np.ascontiguousarray(x, dtype=np.float32)
    bits = f.view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32).astype(np.float64)


def control_switches(D: np.ndarray, s: int, delta: float):
    """The bfloat16 control's schedule of D as ``(perms, alphas)`` per switch."""
    res = spectra(to_bf16(D), s, delta)
    return [
        (np.stack(sw.perms) if sw.perms else np.zeros((0, D.shape[0]), np.int64), to_bf16(sw.alphas))
        for sw in res.schedule.switches
    ]
