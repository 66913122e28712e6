"""2-hop Valiant load balancing: what a window carries besides its own pair
(a copy of ``repro.flowsim.indirection``).

When circuit (a → b) has leftover capacity after serving relay and direct
traffic, VLB spends it on hop-1 detours: bytes queued at ``a`` for *other*
destinations ride to ``b`` now and are forwarded from ``b``'s indirect
buffer when a later (b → dst) window comes up. Because each window's
leftover is at most one slot's worth, injection self-spreads across
intermediates as the rotor sequence cycles — the classic RotorNet/Opus
behavior — without any demand knowledge beyond the local queue depths.

The policy here is deterministic: destinations are offered in order of
descending local queue depth (ties by index), so heavy flows detour first.
"""

from __future__ import annotations

import numpy as np

from .buffers import FabricBuffers

__all__ = ["vlb_injections"]


def vlb_injections(
    buffers: FabricBuffers,
    a: int,
    b: int,
    capacity: float,
    tol: float = 1e-12,
) -> list[tuple[int, float]]:
    """Hop-1 plan for window (a → b): [(dst, units to park at b), ...].

    Respects ``b``'s free buffer space (finite ``buffer_limit`` throttles
    admission) and never detours traffic already destined ``b`` (that is
    direct) nor ``a``'s intra-rack demand. Callers stage the returned
    amounts via ``buffers.stage_arrival`` so they only become forwardable
    at the window boundary.
    """
    if capacity <= tol:
        return []
    space = buffers.free_space(b)
    if space <= tol:
        return []
    row = buffers.direct[a]
    order = np.argsort(-row, kind="stable")
    plan: list[tuple[int, float]] = []
    budget = min(capacity, space)
    for d in order:
        d = int(d)
        if d == b or d == a:
            continue
        queued = float(row[d])
        if queued <= tol:
            break  # descending order: nothing left worth detouring
        x = min(queued, budget)
        plan.append((d, x))
        budget -= x
        if budget <= tol:
            break
    return plan
