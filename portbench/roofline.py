"""The yardstick's peaks and work counts.

Peaks are NVIDIA's data-sheet figures for one H100 SXM at its full 700 W
(dense rates): they are what a roofline share is stated against, whatever
power limit the card runs at (the run prints that limit beside it).

A matcher call's work is counted from its inputs alone, so the count stays
the same whatever implements the matcher: DECOMPOSE makes ``degree(D)``
matcher calls on D (the reference's decomposition size, Property 1); each
reads its n x n float32 weights once, writes one permutation (n int32) once,
and needs at least one float32 operation per weight (the bid ``w - p``).
"""

from __future__ import annotations

PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}
PEAK_HBM_BYTES_PER_S = 3.35e12


def matcher_call_work(n: int) -> tuple[float, float]:
    """(float32 operations, bytes) of one matcher call on an n x n matrix."""
    return float(n * n), float(4 * n * n + 4 * n)


def least_seconds(ops: float, nbytes: float, dtype: str = "float32") -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(ops / PEAK_FLOPS[dtype], nbytes / PEAK_HBM_BYTES_PER_S)


def matcher_roofline_pct(ns_and_calls, kernel_seconds: float) -> float | None:
    """Share, in %, of the least time for ``sum(calls)`` matcher calls (given
    as ``(n, calls)`` pairs) in the kernels' measured device time."""
    if kernel_seconds <= 0:
        return None
    least = 0.0
    for n, calls in ns_and_calls:
        ops, nbytes = matcher_call_work(n)
        least += calls * least_seconds(ops, nbytes)
    return 100.0 * least / kernel_seconds if least > 0 else None
