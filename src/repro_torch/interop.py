"""Solver state carried across from the reference's numpy arrays.

``from_reference`` turns the arrays of a reference ``JaxDecomposition``,
``DeviceSchedule`` or ``E2EResult`` (taken out with ``np.asarray``) into the
port's tensor twins, so one stage of the port can start from the
reference's output of the stage before it. It imports nothing of the
reference: the caller passes plain arrays, each with a leading batch
dimension, keyed by field name. An ``E2EResult`` is passed flat, its nested
fields keyed as ``"schedule.<field>"`` and ``"dec.<field>"``.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.schedule_ir import DeviceSchedule
from .core.torchopt.decompose_torch import TorchDecomposition
from .core.torchopt.e2e import E2EResult

_SCHEDULE = {"perms", "alphas", "switch", "delta"}
_DECOMPOSITION = {"perms", "alphas", "k", "converged"}
_E2E = {"makespan", "lpt_makespan", "eq_exhausted", "lb"}


def _t(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a), device=device).to(dtype)  # own copy


def _nested(arrays: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix)}


def from_reference(arrays: dict[str, np.ndarray], device) -> DeviceSchedule | TorchDecomposition | E2EResult:
    """The port's twin of a reference result given as numpy arrays.

    The kind is read from the keys: ``perms, alphas, switch, delta`` make a
    ``DeviceSchedule``; ``perms, alphas, k, converged`` a
    ``TorchDecomposition`` (its ``rounds`` is 0: the reference does not
    export it); ``makespan, lpt_makespan, eq_exhausted, lb`` plus nested
    ``schedule.*`` and ``dec.*`` keys an ``E2EResult``.
    """
    keys = set(arrays)
    if _E2E <= keys:
        return E2EResult(
            schedule=from_reference(_nested(arrays, "schedule."), device),
            dec=from_reference(_nested(arrays, "dec."), device),
            makespan=_t(arrays["makespan"], torch.float32, device),
            lpt_makespan=_t(arrays["lpt_makespan"], torch.float32, device),
            eq_exhausted=_t(arrays["eq_exhausted"], torch.bool, device),
            lb=_t(arrays["lb"], torch.float32, device),
        )
    if _SCHEDULE <= keys:
        return DeviceSchedule(
            perms=_t(arrays["perms"], torch.int64, device),
            alphas=_t(arrays["alphas"], torch.float32, device),
            switch=_t(arrays["switch"], torch.int64, device),
            delta=_t(arrays["delta"], torch.float32, device),
        )
    if _DECOMPOSITION <= keys:
        k = _t(arrays["k"], torch.int64, device)
        return TorchDecomposition(
            perms=_t(arrays["perms"], torch.int64, device),
            alphas=_t(arrays["alphas"], torch.float32, device),
            k=k,
            converged=_t(arrays["converged"], torch.bool, device),
            rounds=torch.zeros_like(k),
        )
    raise ValueError(f"cannot tell which reference result has keys {sorted(keys)}")
