"""Composable DECOMPOSE → SCHEDULE → EQUALIZE pipelines (declarative stages).

The port's counterpart of ``repro.api.pipeline``: a ``Pipeline`` names its
three stages instead of closing over functions, so variants are data::

    Pipeline()                                  # paper-faithful SPECTRA
    Pipeline(equalize="none")                   # SPECTRA w/o EQUALIZE
    Pipeline(decompose="eclipse")               # SPECTRA (ECLIPSE)
    Pipeline(schedule="wrap", equalize="none")  # wrap-around scheduler
    Pipeline(decompose="torch_auction", equalize="torch")  # device stages

Each stage is looked up in a registry (``DECOMPOSERS`` / ``SCHEDULERS`` /
``EQUALIZERS``); ``register_stage`` adds new ones without touching this
module. The device stages (names starting with ``torch``; the reference's
``jax_*``) take ``device``: None means CUDA and raises without a GPU. When
a device stage's kwargs name no device, the pipeline passes
``options.extra.get("device")``, the key ``solve_many`` reads.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping

import numpy as np
import torch

from ..core.baselines import eclipse_decompose
from ..core.decompose import Decomposition, decompose
from ..core.equalize import equalize
from ..core.improved import local_search, schedule_wrap
from ..core.schedule import ParallelSchedule, schedule_lpt
from ..core.torchopt.decompose_torch import decompose as decompose_torch
from ..core.torchopt.decompose_torch import to_decomposition
from ..core.torchopt.equalize_torch import equalize_torch
from ..kernels.backend import resolve_device
from ..obs.trace import get_tracer
from .problem import Problem, SolveOptions, SolveReport, finish_report

# Stage signatures. Every stage sees the Problem so stage functions can use
# s / delta without closures (ECLIPSE's decomposition needs delta, say).
DecomposeFn = Callable[..., Decomposition]        # (problem, **kw) -> dec
ScheduleFn = Callable[..., ParallelSchedule]      # (dec, problem, **kw) -> sched
EqualizeFn = Callable[..., ParallelSchedule]      # (sched, problem, **kw) -> sched


def _decompose_torch_stage(
    problem, *, matcher: str = "auction", repair_rounds: int = 0, device=None, **kw
):
    """The batched device DECOMPOSE on one lane, materialized to a host
    ``Decomposition`` for the host stages."""
    D = torch.as_tensor(np.asarray(problem.D, dtype=np.float32)[None], device=resolve_device(device))
    return to_decomposition(decompose_torch(D, matcher=matcher, repair_rounds=repair_rounds, **kw))


DECOMPOSERS: dict[str, DecomposeFn] = {
    "spectra": lambda problem, **kw: decompose(problem.D, **kw),
    "eclipse": lambda problem, **kw: eclipse_decompose(problem.D, problem.delta, **kw),
    # torch_auction is the paper-faithful Alg. 1+2 on the device matcher;
    # torch_refined adds the bounded post-REFINE local-search sweeps.
    "torch_auction": _decompose_torch_stage,
    "torch_refined": lambda problem, **kw: _decompose_torch_stage(
        problem, **{"repair_rounds": 2, **kw}
    ),
}

SCHEDULERS: dict[str, ScheduleFn] = {
    "lpt": lambda dec, problem, **kw: schedule_lpt(dec, problem.s, problem.delta),
    "lpt_local_search": lambda dec, problem, **kw: local_search(
        schedule_lpt(dec, problem.s, problem.delta), **kw
    ),
    "wrap": lambda dec, problem, **kw: schedule_wrap(dec, problem.s, problem.delta, **kw),
}

EQUALIZERS: dict[str, EqualizeFn] = {
    "none": lambda sched, problem, **kw: sched,
    "standard": lambda sched, problem, **kw: equalize(sched, **kw),
    "merge_aware": lambda sched, problem, **kw: equalize(sched, merge_aware=True, **kw),
    # The device EQUALIZE round-trips through the DeviceSchedule slot table.
    "torch": lambda sched, problem, **kw: equalize_torch(sched, problem.n, **kw),
    "torch_merge_aware": lambda sched, problem, **kw: equalize_torch(
        sched, problem.n, merge_aware=True, **kw
    ),
}

_STAGE_TABLES = {"decompose": DECOMPOSERS, "schedule": SCHEDULERS, "equalize": EQUALIZERS}


def register_stage(kind: str, name: str, fn: Callable, *, overwrite: bool = False) -> None:
    """Add a named stage implementation (kind ∈ decompose/schedule/equalize)."""
    try:
        table = _STAGE_TABLES[kind]
    except KeyError:
        raise ValueError(
            f"unknown stage kind {kind!r}; expected one of {sorted(_STAGE_TABLES)}"
        ) from None
    if name in table and not overwrite:
        raise ValueError(f"{kind} stage {name!r} already registered")
    table[name] = fn


def _lookup(kind: str, name: str) -> Callable:
    table = _STAGE_TABLES[kind]
    if name not in table:
        raise KeyError(f"unknown {kind} stage {name!r}; available: {sorted(table)}")
    return table[name]


def _is_device_stage(name: str) -> bool:
    return name.startswith("torch")


@dataclass(frozen=True)
class Pipeline:
    """Declarative three-stage solver; callable as ``pipeline(problem, options)``."""

    decompose: str = "spectra"
    schedule: str = "lpt"
    equalize: str = "standard"
    decompose_kwargs: Mapping[str, Any] = field(default_factory=dict)
    schedule_kwargs: Mapping[str, Any] = field(default_factory=dict)
    equalize_kwargs: Mapping[str, Any] = field(default_factory=dict)

    def describe(self) -> str:
        return f"{self.decompose} → {self.schedule} → {self.equalize}"

    @property
    def backend(self) -> str:
        """"torch" when any stage runs on the device (names the float32
        tolerance, 1e-4), else "numpy" (1e-9)."""
        stages = (self.decompose, self.schedule, self.equalize)
        return "torch" if any(_is_device_stage(name) for name in stages) else "numpy"

    def __call__(
        self,
        problem: Problem,
        options: SolveOptions = SolveOptions(),
        *,
        solver_name: str | None = None,
    ) -> SolveReport:
        dec_fn = _lookup("decompose", self.decompose)
        sched_fn = _lookup("schedule", self.schedule)
        eq_fn = _lookup("equalize", self.equalize)
        device = options.extra.get("device")

        def kw(name: str, kwargs: Mapping[str, Any]) -> dict:
            if _is_device_stage(name) and "device" not in kwargs:
                return {**kwargs, "device": device}
            return dict(kwargs)

        tracer = get_tracer()
        t0 = time.perf_counter()
        with tracer.span("decompose", {"impl": self.decompose} if tracer.enabled else None):
            dec = dec_fn(problem, **kw(self.decompose, self.decompose_kwargs))
        with tracer.span("schedule", {"impl": self.schedule} if tracer.enabled else None):
            sched = sched_fn(dec, problem, **kw(self.schedule, self.schedule_kwargs))
        with tracer.span("equalize", {"impl": self.equalize} if tracer.enabled else None):
            sched = eq_fn(sched, problem, **kw(self.equalize, self.equalize_kwargs))
        runtime = time.perf_counter() - t0
        return finish_report(
            solver=solver_name or self.describe(),
            backend=self.backend,
            schedule=sched,
            problem=problem,
            options=options,
            runtime_s=runtime,
            decomposition=dec,
            extras={"pipeline": self.describe()},
        )
