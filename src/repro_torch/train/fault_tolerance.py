"""Fault-tolerance utilities: failure injection, heartbeats, elastic meshes
(``repro.train.fault_tolerance``). ``largest_mesh`` gives the grid an
elastic restore reshards onto (``train.checkpoint.restore_checkpoint``
with ``shardings``; meshes in ``launch.mesh``, rules in
``parallel.sharding``)."""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from .loop import SimulatedFailure


def fail_at(steps: set[int]):
    """Failure injector that crashes once at each step in ``steps``."""
    fired: set[int] = set()

    def inject(step: int):
        if step in steps and step not in fired:
            fired.add(step)
            raise SimulatedFailure(f"injected failure at step {step}")

    return inject


@dataclass
class Heartbeat:
    """Worker-liveness monitor (thread-based single-host simulation).

    Workers ping; a monitor thread marks any worker silent for
    ``timeout_s`` as dead and invokes the callback (at scale: trigger
    checkpoint-restore with a shrunken mesh — see ``largest_mesh``).
    """

    num_workers: int
    timeout_s: float = 1.0
    last_seen: dict = field(default_factory=dict)
    dead: set = field(default_factory=set)
    _stop: bool = False

    def ping(self, worker: int):
        self.last_seen[worker] = time.monotonic()

    def check(self) -> set:
        now = time.monotonic()
        for w in range(self.num_workers):
            seen = self.last_seen.get(w)
            if seen is not None and now - seen > self.timeout_s:
                self.dead.add(w)
        return self.dead

    def watch(self, on_dead, poll_s: float = 0.05):
        def loop():
            while not self._stop:
                dead = self.check()
                if dead:
                    on_dead(dead)
                    return
                time.sleep(poll_s)

        t = threading.Thread(target=loop, daemon=True)
        t.start()
        return t

    def stop(self):
        self._stop = True


def largest_mesh(n_devices: int, prefer_model: int = 16) -> tuple[int, int]:
    """Elastic re-mesh: biggest (data × model) grid ≤ n_devices.

    Keeps the model axis as close to ``prefer_model`` as divisibility
    allows, shrinking data parallelism first (the cheap direction: only
    the per-device batch changes, parameters reshard along data only).
    """
    model = min(prefer_model, n_devices)
    while model > 1 and n_devices % model:
        model //= 2
    data = n_devices // model
    return (data, model)
