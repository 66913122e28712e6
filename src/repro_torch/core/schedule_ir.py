"""Dense, fixed-shape schedule table shared by the device and host paths.

A copy of the parts of ``repro.core.schedule_ir`` the port uses.
``DeviceSchedule`` is the array-of-slots mirror of ``ParallelSchedule``;
in the port its fields are batched tensors (a leading lane dimension) on
the device, or one lane's numpy arrays on the host:

    perms  (R, n) int   slot r serves port i → perms[r, i]; free slots hold
                        the identity
    alphas (R,)   float slot duration; 0 for free slots
    switch (R,)   int   owning switch id, or -1 for free slots
    delta  ()     float reconfiguration delay

Live slots are exactly ``switch >= 0`` and are packed at the front; free
slots at the tail are headroom for EQUALIZE splits.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np

from .schedule import ParallelSchedule, SwitchSchedule


class DeviceSchedule(NamedTuple):
    """Fixed-shape slot table for a parallel-OCS schedule (see module doc)."""

    perms: Any
    alphas: Any
    switch: Any
    delta: Any

    @property
    def capacity(self) -> int:
        return int(self.perms.shape[-2])

    @property
    def n(self) -> int:
        return int(self.perms.shape[-1])


def ir_to_schedule(ds: DeviceSchedule, s: int) -> ParallelSchedule:
    """Materialize a host ``ParallelSchedule`` from one lane's numpy arrays."""
    perms = np.asarray(ds.perms)
    alphas = np.asarray(ds.alphas, dtype=np.float64)
    switch = np.asarray(ds.switch)
    switches = [SwitchSchedule() for _ in range(s)]
    for r in np.flatnonzero(switch >= 0):
        h = int(switch[r])
        if h >= s:
            raise ValueError(f"slot {r} assigned to switch {h} but s={s}")
        switches[h].perms.append(perms[r].astype(np.int64))
        switches[h].alphas.append(float(alphas[r]))
    return ParallelSchedule(switches=switches, delta=float(ds.delta))


class LazySchedule(ParallelSchedule):
    """A ``ParallelSchedule`` that materializes from a thunk on first use.

    The batched backend returns one per instance: device results (makespan,
    slot counts) are known at once, and the Python-object switch lists are
    built only when something touches them (validation, inspection).
    """

    def __init__(self, factory: Callable[[], ParallelSchedule], delta: float):
        # Skip the dataclass __init__: `switches` is a property here.
        object.__setattr__(self, "_factory", factory)
        object.__setattr__(self, "_inner", None)
        object.__setattr__(self, "_delta", float(delta))

    @property
    def materialized(self) -> bool:
        return self._inner is not None

    def _force(self) -> ParallelSchedule:
        if self._inner is None:
            object.__setattr__(self, "_inner", self._factory())
        return self._inner

    @property
    def switches(self):  # type: ignore[override]
        return self._force().switches

    @property
    def delta(self) -> float:  # type: ignore[override]
        return self._delta

    def __repr__(self) -> str:
        state = repr(self._inner) if self.materialized else "unmaterialized"
        return f"LazySchedule({state})"
