"""Batched solving: many demand matrices through one entry point.

``solve_many(..., solver="spectra_torch")`` groups the instances into shape
buckets and runs each bucket's whole pipeline in one fused batched call;
results come back in submission order. Any other registered solver runs
per instance, optionally fanned out over worker processes. The batch and
each bucket run inside a ``solve_many`` / ``bucket`` span of the tracer.
"""

from __future__ import annotations

import multiprocessing as mp

import numpy as np
import torch

from ..obs.trace import get_tracer
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


def _solve_one(args) -> SolveReport:
    D, s, delta, solver, options = args
    return solve(Problem(D, s, delta), solver=solver, options=options)


def _start_method() -> str:
    """Fork only while CUDA is uninitialised in this process (a forked child
    cannot use a CUDA context its parent made); else forkserver, else spawn."""
    methods = mp.get_all_start_methods()
    if not torch.cuda.is_initialized() and "fork" in methods:
        return "fork"
    return "forkserver" if "forkserver" in methods else "spawn"


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
    processes: int | None = None,
) -> list[SolveReport]:
    """Solve a batch of demand matrices; one SolveReport per instance.

    ``Ds`` is a stacked (B, n, n) array or a sequence of square matrices of
    any sizes; ``delta`` is one δ or a length-B vector. With
    ``spectra_torch`` each distinct shape costs one fused batched call on
    ``options.extra["device"]`` (default CUDA; raises without a GPU). Every
    other solver loops, across ``processes`` workers when given; workers
    start by forkserver or spawn once CUDA is initialised, so scripts using
    ``processes`` need the ``if __name__ == "__main__":`` guard.
    """
    options = options or SolveOptions()
    mats = _as_stack(Ds)
    if not mats:
        return []
    deltas = _as_deltas(delta, len(mats))
    tracer = get_tracer()
    if solver == "spectra_torch":
        buckets = shape_buckets(mats)
        with tracer.span(
            "solve_many",
            {"B": len(mats), "solver": solver, "buckets": len(buckets)} if tracer.enabled else None,
        ):
            out: list[SolveReport | None] = [None] * len(mats)
            for shape, idxs in buckets.items():
                with tracer.span(
                    "bucket", {"shape": list(shape), "count": len(idxs)} if tracer.enabled else None
                ):
                    reports = solve_many_torch(
                        np.stack([mats[i] for i in idxs]), s, deltas[idxs], options
                    )
                for i, rep in zip(idxs, reports):
                    out[i] = rep
            return out  # type: ignore[return-value]
    work = [(D, s, float(d), solver, options) for D, d in zip(mats, deltas)]
    with tracer.span("solve_many", {"B": len(work), "solver": solver} if tracer.enabled else None):
        if processes and processes > 1 and len(work) > 1:
            with mp.get_context(_start_method()).Pool(min(processes, len(work))) as pool:
                return pool.map(_solve_one, work)
        return [_solve_one(w) for w in work]
