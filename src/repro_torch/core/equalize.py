"""Host EQUALIZE (Alg. 4), a copy of ``repro.core.equalize``.

The batched device EQUALIZE can run out of free slots; this host pass then
finishes the job from where it stopped (Alg. 4 is an iterative improvement
loop). It moves a ``τ = (L_max − L_min − δ)/2`` slice of the longest
permutation on the most-loaded switch to the least-loaded one, until the
spread is at most δ or the longest permutation is too short to split.
``merge_aware=True`` merges into an identical permutation already on the
target switch, with no extra δ.
"""

from __future__ import annotations

import numpy as np

from .schedule import ParallelSchedule


def perm_key(perm: np.ndarray) -> bytes:
    """Dtype-normalized hash key for a permutation (its int64 bytes)."""
    return np.ascontiguousarray(perm, dtype=np.int64).tobytes()


def equalize(
    sched: ParallelSchedule,
    *,
    merge_aware: bool = False,
    max_iters: int | None = None,
    load_offset: np.ndarray | None = None,
) -> ParallelSchedule:
    """Alg. 4, in place on ``sched`` (also returned for chaining).

    ``load_offset`` shifts each switch's effective load by a constant.
    """
    s = sched.s
    delta = sched.delta
    if s <= 1:
        return sched
    loads = sched.loads()
    if load_offset is not None:
        loads = loads + np.asarray(load_offset, dtype=np.float64)
    if max_iters is None:
        max_iters = 64 * (sched.num_configs() + s) + 64
    # One hash per permutation, first slot kept on duplicates.
    tables: list[dict[bytes, int]] = []
    if merge_aware:
        for sw in sched.switches:
            table: dict[bytes, int] = {}
            for j, p in enumerate(sw.perms):
                table.setdefault(perm_key(p), j)
            tables.append(table)
    for _ in range(max_iters):
        h_max = int(np.argmax(loads))
        h_min = int(np.argmin(loads))
        if loads[h_max] - loads[h_min] <= delta:
            break
        src = sched.switches[h_max]
        z = src.longest()
        if z < 0:
            break
        dst = sched.switches[h_min]
        merged = -1
        if merge_aware:
            key = perm_key(src.perms[z])
            merged = tables[h_min].get(key, -1)
        # Target load µ includes the δ a brand-new configuration costs.
        setup = 0.0 if merged >= 0 else delta
        mu = (loads[h_max] + loads[h_min] + setup) / 2.0
        tau = loads[h_max] - mu
        if tau <= 0 or src.alphas[z] <= tau:
            break
        src.alphas[z] -= tau
        if merged >= 0:
            dst.alphas[merged] += tau
        else:
            dst.perms.append(src.perms[z].copy())
            dst.alphas.append(tau)
            if merge_aware:
                tables[h_min].setdefault(key, len(dst.perms) - 1)
        loads[h_max] -= tau
        loads[h_min] += setup + tau
    return sched
