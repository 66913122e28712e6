"""Fused DECOMPOSE → SCHEDULE → EQUALIZE → §IV bound for a batch (PyTorch port).

Counterpart of ``repro.core.jaxopt.e2e``: ``spectra_torch_e2e_many`` runs
the whole SPECTRA pipeline for stacked (B, n, n) demand matrices on one
device and returns a dense ``DeviceSchedule`` per lane. Where the reference
``vmap``s one instance's program, every stage here is written for the batch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...kernels.backend import resolve_device
from ..schedule_ir import DeviceSchedule
from .decompose_torch import TorchDecomposition, decompose, lpt_schedule
from .equalize_torch import device_loads, equalize_ir
from .lower_bounds_torch import lower_bound


class E2EResult(NamedTuple):
    """Device-resident result of the fused pipeline (one lane per instance)."""

    schedule: DeviceSchedule      # post-EQUALIZE slot table, batched
    dec: TorchDecomposition       # DECOMPOSE output (pre-EQUALIZE weights)
    makespan: torch.Tensor        # (B,) max switch load after EQUALIZE
    lpt_makespan: torch.Tensor    # (B,) Alg. 3 makespan before EQUALIZE
    eq_exhausted: torch.Tensor    # (B,) EQUALIZE ran out of split slots
    lb: torch.Tensor              # (B,) §IV lower bound


def slot_table(dec: TorchDecomposition, assignment: torch.Tensor, deltas: torch.Tensor,
               extra_slots: int) -> DeviceSchedule:
    """The decomposition's n slots (round r on switch ``assignment[:, r]``)
    and ``extra_slots`` free ones, EQUALIZE's split headroom."""
    B, n = dec.alphas.shape
    dev = dec.alphas.device
    return DeviceSchedule(
        perms=torch.cat([dec.perms, torch.arange(n, device=dev).expand(B, extra_slots, n)], dim=1),
        alphas=torch.cat([dec.alphas, torch.zeros((B, extra_slots), device=dev)], dim=1),
        switch=torch.cat(
            [assignment, torch.full((B, extra_slots), -1, dtype=torch.int64, device=dev)], dim=1
        ),
        delta=deltas,
    )


def schedule_decomposition(
    dec: TorchDecomposition,
    s: int,
    deltas: torch.Tensor,
    *,
    do_equalize: bool = True,
    merge_aware: bool = False,
    extra_slots: int = 64,
) -> tuple[DeviceSchedule, torch.Tensor, torch.Tensor]:
    """LPT then EQUALIZE of a batched decomposition; returns ``(schedule,
    lpt_makespan, eq_exhausted)``. ``extra_slots`` free slots are appended
    to the n decomposition slots as EQUALIZE's split headroom."""
    assignment, _, lpt_makespan = lpt_schedule(dec, s, deltas)
    ds = slot_table(dec, assignment, deltas, extra_slots)
    eq_exhausted = torch.zeros((dec.alphas.shape[0],), dtype=torch.bool, device=dec.alphas.device)
    if do_equalize:
        ds, eq_exhausted = equalize_ir(ds, s, merge_aware=merge_aware)
    return ds, lpt_makespan, eq_exhausted


def spectra_torch_e2e_many(
    Ds,
    s: int,
    delta,
    *,
    device: str | torch.device | None = None,
    do_equalize: bool = True,
    merge_aware: bool = False,
    extra_slots: int = 64,
    matcher: str = "auction",
    repair_rounds: int = 0,
) -> E2EResult:
    """Full SPECTRA pipeline for each (n, n) matrix of ``Ds`` (B, n, n).

    ``delta`` is a scalar or a (B,) vector. ``device=None`` means CUDA and
    raises without a GPU. ``extra_slots`` is the EQUALIZE split headroom;
    ``matcher`` picks the matcher (``matching.MATCHERS``); ``repair_rounds``
    bounds the post-REFINE local-search sweeps.
    """
    dev = resolve_device(device)
    Ds = torch.as_tensor(Ds, dtype=torch.float32, device=dev)
    B = Ds.shape[0]
    deltas = torch.as_tensor(delta, dtype=torch.float32, device=dev).expand(B).contiguous()
    dec = decompose(Ds, matcher=matcher, repair_rounds=repair_rounds)
    ds, lpt_makespan, eq_exhausted = schedule_decomposition(
        dec, s, deltas, do_equalize=do_equalize, merge_aware=merge_aware,
        extra_slots=extra_slots,
    )
    return E2EResult(
        schedule=ds,
        dec=dec,
        makespan=device_loads(ds.alphas, ds.switch, ds.delta, s).amax(dim=1),
        lpt_makespan=lpt_makespan,
        eq_exhausted=eq_exhausted,
        lb=lower_bound(Ds, s, deltas),
    )
