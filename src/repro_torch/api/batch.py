"""Batched solving: many demand matrices through one entry point.

``solve_many(..., solver="spectra_torch")`` groups the instances into shape
buckets and runs each bucket's whole pipeline in one fused batched call;
results come back in submission order. Any other registered solver runs
per instance.
"""

from __future__ import annotations

import numpy as np

from .problem import Problem, SolveOptions, SolveReport
from .registry import solve
from .torch_backend import solve_many_torch


def _as_stack(Ds) -> list[np.ndarray]:
    """Normalize to a list of square matrices."""
    if isinstance(Ds, np.ndarray) and Ds.ndim == 3:
        return [Ds[b] for b in range(Ds.shape[0])]
    return [np.asarray(D) for D in Ds]


def shape_buckets(mats: list[np.ndarray]) -> dict[tuple[int, ...], list[int]]:
    """Group instance indices by matrix shape, preserving submission order."""
    buckets: dict[tuple[int, ...], list[int]] = {}
    for i, D in enumerate(mats):
        buckets.setdefault(D.shape, []).append(i)
    return buckets


def _as_deltas(delta, B: int) -> np.ndarray:
    """Normalize δ (scalar or per-instance sequence) to a (B,) vector."""
    arr = np.asarray(delta, dtype=np.float64)
    if arr.ndim == 0:
        return np.full((B,), float(arr))
    if arr.shape != (B,):
        raise ValueError(f"per-instance delta must have length {B}, got shape {arr.shape}")
    return arr


def solve_many(
    Ds,
    s: int,
    delta,
    *,
    solver: str = "spectra_torch",
    options: SolveOptions | None = None,
) -> list[SolveReport]:
    """Solve a batch of demand matrices; one SolveReport per instance.

    ``Ds`` is a stacked (B, n, n) array or a sequence of square matrices of
    any sizes; ``delta`` is one δ or a length-B vector. With
    ``spectra_torch`` each distinct shape costs one fused batched call on
    ``options.extra["device"]`` (default CUDA; raises without a GPU).
    """
    options = options or SolveOptions()
    mats = _as_stack(Ds)
    if not mats:
        return []
    deltas = _as_deltas(delta, len(mats))
    if solver != "spectra_torch":
        return [
            solve(Problem(D, s, float(d)), solver=solver, options=options)
            for D, d in zip(mats, deltas)
        ]
    out: list[SolveReport | None] = [None] * len(mats)
    for _shape, idxs in shape_buckets(mats).items():
        reports = solve_many_torch(
            np.stack([mats[i] for i in idxs]), s, deltas[idxs], options
        )
        for i, rep in zip(idxs, reports):
            out[i] = rep
    return out  # type: ignore[return-value]
