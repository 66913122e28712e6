"""Faults planted in the program, for reading what the check makes of them.

Each is a context manager that patches one stage of the port's solve path
while it is open and restores it on exit. The benchmark's own runs plant
none: ``control.py`` reads them on the card at a cell's own size, and the
CPU tests see each come out ``correct: false`` at a tiny size.

- ``answer_altered``: one weight of each schedule 0.1% short, where the
  schedule is produced;
- ``refine_unchanged``: REFINE returns the weights it was given;
- ``half_batch``: half of a ``solve_many`` batch solved, its answers handed
  to the rest;
- ``early_stop``: every matcher call stops after the first half of its ε
  schedule;
- ``no_polish``: the fused matcher completes its matching greedily with no
  2-swap polish;
- ``no_equalize``: LPT's placement is returned without EQUALIZE;
- ``one_switch``: LPT places every configuration on switch 0 (EQUALIZE still
  runs).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Callable, Iterator

import numpy as np


@contextmanager
def _patched(module, name: str, make: Callable) -> Iterator[None]:
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def answer_altered():
    from repro_torch.api import torch_backend

    def make(orig):
        def schedule_thunk(self, b, s):
            build = orig(self, b, s)

            def altered():
                sched = build()
                sw = max(sched.switches, key=lambda w: len(w.alphas))
                sw.alphas[0] *= 0.999
                return sched
            return altered
        return schedule_thunk

    return _patched(torch_backend._HostBatch, "schedule_thunk", make)


def refine_unchanged():
    from repro_torch.core.torchopt import decompose_torch

    return _patched(decompose_torch, "_refine", lambda orig: lambda D, perms, alphas, k: alphas)


def half_batch():
    from repro_torch.api import batch

    def make(orig):
        def half(Ds, s, delta, options):
            Ds = np.asarray(Ds)
            h = max(1, len(Ds) // 2)
            reps = orig(Ds[:h], s, np.broadcast_to(delta, (len(Ds),))[:h], options)
            return [reps[i % h] for i in range(len(Ds))]
        return half

    return _patched(batch, "solve_many_torch", make)


def early_stop():
    from repro_torch.core.torchopt import matching

    def make(orig):
        def first_half(W, num_phases):
            return orig(W, num_phases)[:, : max(1, num_phases // 2)]
        return first_half

    return _patched(matching, "_eps_schedule", make)


def no_polish():
    from repro_torch.core.torchopt import matching

    def make(orig):
        def complete_only(W, r2c, c2r, *, max_swaps):
            return orig(W, r2c, c2r, max_swaps=0)
        return complete_only

    return _patched(matching, "polish_2swap", make)


def no_equalize():
    import torch

    from repro_torch.core.torchopt import e2e

    def make(orig):
        def lpt_only(ds, s, merge_aware=False):
            return ds, torch.zeros((ds.alphas.shape[0],), dtype=torch.bool, device=ds.alphas.device)
        return lpt_only

    return _patched(e2e, "equalize_ir", make)


def one_switch():
    import torch

    from repro_torch.core.torchopt import e2e

    def make(orig):
        def all_on_zero(dec, s, deltas):
            assignment, loads, makespan = orig(dec, s, deltas)
            return torch.where(assignment >= 0, torch.zeros_like(assignment), assignment), loads, makespan
        return all_on_zero

    return _patched(e2e, "lpt_schedule", make)


FAULTS: dict[str, Callable] = {
    "answer_altered": answer_altered, "refine_unchanged": refine_unchanged, "half_batch": half_batch,
    "early_stop": early_stop, "no_polish": no_polish, "no_equalize": no_equalize, "one_switch": one_switch,
}
