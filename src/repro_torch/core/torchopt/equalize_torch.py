"""Batched EQUALIZE (Alg. 4) over the dense ``DeviceSchedule`` slot table.

Counterpart of ``repro.core.jaxopt.equalize_jax``. Each iteration moves a
``τ = (L_max − L_min − setup)/2`` slice of the longest slot on the most
loaded switch into a free slot on the least loaded one (or, with
``merge_aware``, into an identical permutation already there), until the
spread is at most δ, the longest slot is too short to split, or the table
runs out of free slots. A lane that stops is never updated again.
``equalize_torch`` takes a host ``ParallelSchedule`` through it.
"""

from __future__ import annotations

import torch

from ...kernels.backend import resolve_device
from ..equalize import equalize
from ..schedule import ParallelSchedule
from ..schedule_ir import DeviceSchedule, ir_to_schedule, schedule_to_ir


def _canonical_ids(perms: torch.Tensor) -> torch.Tensor:
    """canon[b, r] = smallest r' with perms[b, r'] == perms[b, r].

    Folds the (R, R) row-equality matrix a block of columns at a time, so
    peak memory stays near B·R²·block instead of B·R²·n.
    """
    B, R, n = perms.shape
    eq = torch.ones((B, R, R), dtype=torch.bool, device=perms.device)
    block = max(1, (1 << 26) // max(B * R * R, 1))
    for c0 in range(0, n, block):
        p = perms[:, :, c0:c0 + block]
        eq &= (p[:, :, None, :] == p[:, None, :, :]).all(dim=3)
    return torch.argmax(eq.to(torch.int8), dim=2)


def device_loads(alphas: torch.Tensor, switch: torch.Tensor, delta: torch.Tensor, s: int) -> torch.Tensor:
    """Per-switch loads ``Σα + δ·configs`` over live slots, (B, s).

    A masked sum over slots, in float64 and rounded once, so the result is
    the same on every device and does not depend on a reduction order.
    """
    live = switch >= 0
    contrib = torch.where(live, alphas + delta[:, None], 0.0)
    onehot = switch[:, :, None] == torch.arange(s, device=switch.device)
    return torch.where(onehot, contrib[:, :, None], 0.0).sum(dim=1, dtype=torch.float64).float()


def _at(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b]] for (B, R) x and (B,) idx."""
    return torch.gather(x, 1, idx[:, None])[:, 0]


def equalize_ir(
    ds: DeviceSchedule,
    s: int,
    *,
    merge_aware: bool = False,
    max_iters: int | None = None,
    load_offset: torch.Tensor | None = None,
) -> tuple[DeviceSchedule, torch.Tensor]:
    """Alg. 4 on each lane; returns ``(schedule, exhausted)``.

    ``ds`` holds batched tensors: perms (B, R, n), alphas (B, R), switch
    (B, R), delta (B,). ``load_offset`` is an optional (s,) or (B, s) shift
    on each switch's effective load. ``exhausted`` (B,) is set where the slot
    table ran out of split headroom while a split was still wanted — the one
    stop the host EQUALIZE does not have. ``max_iters`` defaults to the host
    path's ``64·(configs + s) + 64`` per lane. ``equalize_ir.iterations``
    counts the loop's iterations over all calls, each a host read.
    """
    perms = ds.perms.clone()
    alphas = ds.alphas.to(torch.float32).clone()
    switch = ds.switch.clone()
    delta = ds.delta.to(torch.float32)
    B, R, _ = perms.shape
    dev = perms.device
    exhausted = torch.zeros((B,), dtype=torch.bool, device=dev)
    if s <= 1:
        return DeviceSchedule(perms, alphas, switch, delta), exhausted
    lanes = torch.arange(B, device=dev)
    slots = torch.arange(R, device=dev)
    count = (switch >= 0).sum(dim=1)
    offset = (
        torch.zeros((B, s), dtype=torch.float32, device=dev)
        if load_offset is None
        else torch.as_tensor(load_offset, dtype=torch.float32, device=dev).expand(B, s)
    )
    iter_cap = (
        torch.full((B,), max_iters, dtype=torch.int64, device=dev)
        if max_iters is not None
        else 64 * (count + s) + 64
    )
    canon = _canonical_ids(perms) if merge_aware else torch.zeros((B, R), dtype=torch.int64, device=dev)
    it = torch.zeros((B,), dtype=torch.int64, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    while True:
        active = ~done & (it < iter_cap)
        if not bool(active.any()):
            break
        live = switch >= 0
        loads = device_loads(alphas, switch, delta, s) + offset
        h_max = torch.argmax(loads, dim=1)
        h_min = torch.argmin(loads, dim=1)
        l_max, l_min = _at(loads, h_max), _at(loads, h_min)
        spread_ok = l_max - l_min <= delta
        on_max = live & (switch == h_max[:, None])
        z = torch.argmax(torch.where(on_max, alphas, -torch.inf), dim=1)
        no_source = ~on_max.any(dim=1)
        if merge_aware:
            mmask = live & (switch == h_min[:, None]) & (canon == _at(canon, z)[:, None])
            can_merge = mmask.any(dim=1)
            j = torch.argmax(mmask.to(torch.int8), dim=1)
        else:
            can_merge = torch.zeros((B,), dtype=torch.bool, device=dev)
            j = torch.zeros((B,), dtype=torch.int64, device=dev)
        setup = torch.where(can_merge, 0.0, delta)
        mu = (l_max + l_min + setup) / 2.0
        tau = l_max - mu
        other_stop = spread_ok | no_source | (tau <= 0) | (_at(alphas, z) <= tau)
        out_of_slots = ~can_merge & (count >= R) & ~other_stop
        stop = other_stop | out_of_slots
        go = active & ~stop
        tau = torch.where(go, tau, 0.0)
        alphas[lanes, z] += -tau
        alphas[lanes, j] += torch.where(go & can_merge, tau, 0.0)
        do_split = go & ~can_merge
        # Write the split into slot `count`; lanes without a split (or with a
        # full table) leave every slot as it was.
        into = (slots[None, :] == count[:, None]) & do_split[:, None]
        alphas = torch.where(into, tau[:, None], alphas)
        switch = torch.where(into, h_min[:, None], switch)
        perms = torch.where(into[:, :, None], perms[lanes, z][:, None, :], perms)
        canon = torch.where(into, _at(canon, z)[:, None], canon)
        count = count + do_split.long()
        it += active.long()
        done = done | (active & stop)
        exhausted = exhausted | (active & out_of_slots)
        equalize_ir.iterations += 1
    return DeviceSchedule(perms, alphas, switch, delta), exhausted


equalize_ir.iterations = 0


def equalize_torch(
    sched: ParallelSchedule,
    n: int | None = None,
    *,
    merge_aware: bool = False,
    extra_slots: int = 64,
    max_iters: int | None = None,
    device: str | torch.device | None = None,
) -> ParallelSchedule:
    """Host ``ParallelSchedule`` → one lane of ``equalize_ir`` on ``device``
    → ``ParallelSchedule``; the counterpart of the reference's
    ``equalize_jax`` (the ``torch`` EQUALIZE stage).

    ``n`` defaults to the size of the first permutation; ``device=None``
    means CUDA and raises without a GPU. The slot table holds the live
    slots plus ``extra_slots``, rounded up to a multiple of 64. If it runs
    out of split headroom and ``max_iters`` is None, host EQUALIZE finishes
    the job from where the device stopped (Alg. 4 is an iterative
    improvement loop).
    """
    s = sched.s
    if n is None:
        for sw in sched.switches:
            if sw.perms:
                n = len(sw.perms[0])
                break
        else:
            return sched  # nothing scheduled anywhere
    capacity = -(-(sched.num_configs() + extra_slots) // 64) * 64
    ds = schedule_to_ir(sched, n, capacity=capacity)
    dev = resolve_device(device)
    out, exhausted = equalize_ir(
        DeviceSchedule(
            perms=torch.as_tensor(ds.perms, dtype=torch.int64, device=dev)[None],
            alphas=torch.as_tensor(ds.alphas, dtype=torch.float32, device=dev)[None],
            switch=torch.as_tensor(ds.switch, dtype=torch.int64, device=dev)[None],
            delta=torch.tensor([ds.delta], dtype=torch.float32, device=dev),
        ),
        s, merge_aware=merge_aware, max_iters=max_iters,
    )
    result = ir_to_schedule(
        DeviceSchedule(*(x[0].cpu().numpy() for x in out)), s
    )
    if bool(exhausted[0]) and max_iters is None:
        result = equalize(result, merge_aware=merge_aware)
    return result
