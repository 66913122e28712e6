"""Nested-span tracer with Chrome trace-event export, a copy of
``repro.obs.trace``.

The tracer the solver layer is wired through: ``span("decompose")`` /
``"schedule"`` / ``"equalize"`` around each ``Pipeline`` stage,
``span("solve_many")`` and ``span("bucket")`` around batched solves, and
``span("torch.dispatch")`` / ``span("torch.collect")`` around the fused
device calls. One module-level default tracer (``get_tracer()``) is what
the wiring uses; tests and tools may construct their own ``Tracer``.

Cost discipline — the tracer is wired into hot paths, so:

* **Disabled** (the default), ``span()`` is one attribute check and
  returns a shared no-op context-manager singleton: no allocation, no
  timestamps, nothing recorded. Call sites that want to attach argument
  dicts guard on ``tracer.enabled`` (or pass ``args`` only when cheap) so
  the disabled path stays allocation-free end to end.
* **Enabled**, each span costs two ``perf_counter`` reads, one small
  object, one list append and a check whether a profiler records. Spans
  nest via a per-thread stack; every finished span records its parent, so
  containment invariants (child ⊆ parent interval) are checkable directly.

Export is the Chrome trace-event JSON format (``ph: "X"`` complete
events, microsecond timestamps) — load the file in Perfetto
(https://ui.perfetto.dev) or ``chrome://tracing`` to see the pipeline as
a flame chart. ``device_sync=True`` asks the device wiring to call
``torch.cuda.synchronize()`` *inside* its dispatch spans so device time
lands in the span that launched it (off by default: it serializes the
async pipeline).

Two additions to the reference's tracer, both only while it is enabled:

* While a ``torch.profiler`` session records, every span also opens a
  ``record_function`` range of its name, so the spans land in the
  profiler's trace as ``user_annotation`` events on the device timeline's
  clock, and an idle gap of the card can be put down to the span the host
  was in.
* A span given a CUDA ``device`` counts the host reads made while it is
  open (``obs.host_reads.count_host_reads``) into its arg ``host_reads``.
  Counts nest: a span's count holds its children's.
"""

from __future__ import annotations

import json
import threading
import time
from pathlib import Path
from typing import Any, Mapping

import torch

from .host_reads import count_host_reads

__all__ = ["SpanEvent", "Tracer", "get_tracer", "span"]


class SpanEvent:
    """One finished (or in-flight) span: absolute perf_counter interval."""

    __slots__ = ("name", "cat", "start", "end", "parent", "tid", "args")

    def __init__(
        self,
        name: str,
        cat: str,
        start: float,
        parent: int | None,
        tid: int,
        args: Mapping[str, Any] | None,
    ) -> None:
        self.name = name
        self.cat = cat
        self.start = start
        self.end: float | None = None  # filled when the span closes
        self.parent = parent           # index into Tracer.events, or None
        self.tid = tid
        self.args = args

    @property
    def duration(self) -> float:
        return (self.end - self.start) if self.end is not None else 0.0

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"SpanEvent({self.name!r}, dur={self.duration:.6f})"


class _NullSpan:
    """Shared no-op context manager returned while tracing is disabled."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **kw) -> None:
        """No-op counterpart of ``_LiveSpan.set``."""


_NULL_SPAN = _NullSpan()


class _LiveSpan:
    """Context manager recording one SpanEvent on the owning tracer."""

    __slots__ = ("_tracer", "_index")

    def __init__(self, tracer: "Tracer", index: int) -> None:
        self._tracer = tracer
        self._index = index

    def __enter__(self) -> "_LiveSpan":
        return self

    def __exit__(self, *exc) -> bool:
        self._tracer._close(self._index)
        return False

    def set(self, **kw) -> None:
        """Attach/extend args on the open span (e.g. results known at exit)."""
        ev = self._tracer.events[self._index]
        ev.args = {**(ev.args or {}), **kw}


class Tracer:
    """Nested span recorder; disabled by default, O(1) no-op when off."""

    def __init__(self, *, enabled: bool = False, device_sync: bool = False):
        self.enabled = bool(enabled)
        self.device_sync = bool(device_sync)
        self.events: list[SpanEvent] = []
        self._t0 = time.perf_counter()
        self._local = threading.local()
        self._hooks: dict[int, tuple] = {}  # open span -> (profiler range, read count)

    # ----------------------------------------------------------- control
    def enable(self, *, device_sync: bool | None = None) -> None:
        if device_sync is not None:
            self.device_sync = bool(device_sync)
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        """Drop all recorded events and restart the clock."""
        self.events = []
        self._t0 = time.perf_counter()
        self._local = threading.local()
        self._hooks = {}

    # --------------------------------------------------------- recording
    def _stack(self) -> list[int]:
        try:
            return self._local.stack
        except AttributeError:
            stack: list[int] = []
            self._local.stack = stack
            return stack

    def span(self, name: str, args: Mapping[str, Any] | None = None, *, device=None):
        """Context manager timing one nested span.

        ``args`` (an optional mapping) lands in the exported event's
        ``args`` field. When the tracer is disabled this returns a shared
        no-op singleton — build arg dicts only under ``tracer.enabled``
        if the call site is hot. On a CUDA ``device`` the span's arg
        ``host_reads`` counts the host reads made while it is open.
        """
        if not self.enabled:
            return _NULL_SPAN
        stack = self._stack()
        ev = SpanEvent(
            name,
            "repro",
            time.perf_counter(),
            stack[-1] if stack else None,
            threading.get_ident(),
            dict(args) if args else None,
        )
        index = len(self.events)
        self.events.append(ev)
        stack.append(index)
        reads = count = annotation = None
        if device is not None and torch.device(device).type == "cuda":
            reads = count_host_reads(device)
            count = reads.__enter__()
        if torch._C._autograd._profiler_enabled():
            annotation = torch.profiler.record_function(name)
            annotation.__enter__()
        if reads is not None or annotation is not None:
            self._hooks[index] = (annotation, reads, count)
        return _LiveSpan(self, index)

    def _close(self, index: int) -> None:
        end = time.perf_counter()
        stack = self._stack()
        # The span being closed is the stack top in well-nested use; pop
        # down to it so an exception skipping inner __exit__s can't wedge
        # the stack (children left open are closed with their parent's end).
        while stack and stack[-1] >= index:
            j = stack.pop()
            hooks = self._hooks.pop(j, None)
            if hooks is not None:
                self._unhook(j, *hooks)
            if self.events[j].end is None:
                self.events[j].end = end

    def _unhook(self, index: int, annotation, reads, count) -> None:
        """Close a span's profiler range and host-read count, innermost
        first; the count lands in the span's arg ``host_reads``."""
        if annotation is not None:
            annotation.__exit__(None, None, None)
        if reads is not None:
            reads.__exit__(None, None, None)
            ev = self.events[index]
            ev.args = {**(ev.args or {}), "host_reads": count[0]}

    def instant(self, name: str, args: Mapping[str, Any] | None = None) -> None:
        """Point-in-time marker (Chrome ``ph: "i"`` instant event)."""
        if not self.enabled:
            return
        ev = SpanEvent(
            name, "repro.instant", time.perf_counter(), None,
            threading.get_ident(), dict(args) if args else None,
        )
        ev.end = ev.start
        self.events.append(ev)

    def counter(self, name: str, value: float) -> None:
        """Time-series counter sample (Chrome ``ph: "C"`` counter event)."""
        if not self.enabled:
            return
        ev = SpanEvent(
            name, "repro.counter", time.perf_counter(), None,
            threading.get_ident(), {"value": float(value)},
        )
        ev.end = ev.start
        self.events.append(ev)

    # ------------------------------------------------------------ export
    def spans(self) -> list[SpanEvent]:
        """Finished spans (open spans and instant/counter samples excluded)."""
        return [
            e for e in self.events
            if e.cat == "repro" and e.end is not None
        ]

    def to_chrome(self) -> dict[str, Any]:
        """The Chrome trace-event JSON object (Perfetto-loadable)."""
        out = []
        for e in self.events:
            if e.end is None:
                continue  # never-closed span: not representable as "X"
            ts = (e.start - self._t0) * 1e6
            common = {
                "name": e.name,
                "cat": e.cat,
                "ts": ts,
                "pid": 0,
                "tid": e.tid,
            }
            if e.args:
                common["args"] = dict(e.args)
            if e.cat == "repro.instant":
                common.update(ph="i", s="t")
            elif e.cat == "repro.counter":
                common.update(ph="C")
            else:
                common.update(ph="X", dur=(e.end - e.start) * 1e6)
            out.append(common)
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def save(self, path: str | Path) -> Path:
        """Write the Chrome trace JSON; returns the path written."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_chrome(), indent=1))
        return path


# The default tracer every pipeline call site records into. Enable it with
# ``get_tracer().enable()``.
_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def span(name: str, args: Mapping[str, Any] | None = None):
    """``get_tracer().span(...)`` — the form the pipeline wiring imports."""
    return _TRACER.span(name, args)
