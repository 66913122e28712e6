"""Batched EQUALIZE (Alg. 4) over the dense ``DeviceSchedule`` slot table.

Counterpart of ``repro.core.jaxopt.equalize_jax``. Each iteration moves a
``τ = (L_max − L_min − setup)/2`` slice of the longest slot on the most
loaded switch into a free slot on the least loaded one (or, with
``merge_aware``, into an identical permutation already there), until the
spread is at most δ, the longest slot is too short to split, or the table
runs out of free slots. A lane that stops is never updated again.
"""

from __future__ import annotations

import torch

from ..schedule_ir import DeviceSchedule


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
    path's ``64·(configs + s) + 64`` per lane.
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
    return DeviceSchedule(perms, alphas, switch, delta), exhausted
