"""Reading the device timeline from a ``torch.profiler`` Chrome trace.

Device activity is every event of the categories ``kernel``, ``gpu_memcpy``
and ``gpu_memset``; host activity the ``cpu_op`` and ``user_annotation``
events. The traced window runs from the first event to the last event
of either side, and is at least the profiled span by the host's clock.
"""

from __future__ import annotations

import json
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "user_annotation"}


@dataclass
class DeviceTrace:
    window_s: float
    busy_s: float
    kernels: list[tuple[str, float]] = field(default_factory=list)   # (name, seconds), every launch
    device_ops: list[tuple[str, float]] = field(default_factory=list)  # top 10 by total seconds
    idle_gaps: list[tuple[str, float]] = field(default_factory=list)   # top 10 host activities by idle seconds

    def kernel_seconds(self, names) -> float:
        """Device seconds of the kernels whose name contains any of ``names``."""
        return sum(sec for name, sec in self.kernels if any(k in name for k in names))


def _short(name: str) -> str:
    """A kernel's name without its return type, namespace and arguments."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(", 1)[0].strip()[:160] or name[:160]


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def read_trace(path: str | Path, window_s: float = 0.0) -> DeviceTrace | None:
    """The window, the device's busy time and the breakdown, or None when the
    trace holds no device event. ``window_s``, the profiled span by the host's
    clock, is the least the window can be: a thread that runs no operator
    leaves no host event."""
    events = json.loads(Path(path).read_text()).get("traceEvents", [])
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        item = (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", "?"))
        if cat in DEVICE_CATS:
            dev.append(item)
        elif cat in HOST_CATS:
            host.append(item)
    if not dev:
        return None
    start = min(e[0] for e in host + dev)
    end = max(max(e[1] for e in host + dev), start + window_s * 1e6)
    busy = _merge([(max(a, start), min(b, end)) for a, b, _ in dev if b > start and a < end])
    busy_us = sum(b - a for a, b in busy)
    totals: dict[str, float] = defaultdict(float)
    for a, b, name in dev:
        totals[_short(name)] += (b - a) * 1e-6
    # Each idle gap is put down to the innermost host event (the shortest)
    # running at its midpoint: what the host was doing while the card idled.
    gaps = []
    cursor = start
    for a, b in busy + [[end, end]]:
        if a > cursor:
            gaps.append((cursor, a))
        cursor = max(cursor, b)
    host.sort()
    idle: dict[str, float] = defaultdict(float)
    active: list[tuple[float, float, str]] = []
    i = 0
    for ga, gb in gaps:
        mid = 0.5 * (ga + gb)
        while i < len(host) and host[i][0] <= mid:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[1] >= mid]
        label = min(active, key=lambda h: h[1] - h[0])[2] if active else "no host operator"
        idle[label] += (gb - ga) * 1e-6
    top = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:10]  # noqa: E731
    return DeviceTrace(
        window_s=(end - start) * 1e-6,
        busy_s=busy_us * 1e-6,
        kernels=[(name, (b - a) * 1e-6) for a, b, name in dev],
        device_ops=top(totals),
        idle_gaps=top(idle),
    )
