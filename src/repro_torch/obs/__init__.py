"""Observability of the port: span tracing, time-expanded switch tables,
shared metrics (the counterpart of ``repro.obs``).

* ``trace``: a nested-span tracer. Disabled it costs one attribute check
  per call site; enabled it exports Chrome trace-event JSON viewable in
  Perfetto (``chrome://tracing``).
* ``timeline_table``: the time-expanded view of a schedule built on
  ``fabric.timeline``: per-switch occupancy rows, per-round utilization,
  and the makespan attribution identity
  ``transmission + δ paid + idle ≡ s · makespan``.
* ``metrics``: latency histograms, named counters and the solver-warning
  tally shared by serving and scenarios.

``python -m repro_torch.obs.dashboard <scenario>`` renders the terminal
timeline; ``--html`` / ``--trace`` write the HTML report and the Chrome
trace.
"""

from .metrics import (
    STAGES,
    Counters,
    LatencyHistogram,
    ServeMetrics,
    warning_category,
    warning_counts,
)
from .trace import SpanEvent, Tracer, get_tracer, span

# timeline_table builds on fabric.timeline (which builds on core.schedule),
# while api modules import obs.trace at module load, so its names resolve
# lazily (PEP 562) to keep the tracer importable from anywhere without a
# cycle.
_TIMELINE_NAMES = (
    "Interval",
    "MakespanAttribution",
    "ScenarioAttribution",
    "SwitchRow",
    "TimelineTable",
    "attribute_scenario",
    "timeline_table",
)


def __getattr__(name: str):
    if name in _TIMELINE_NAMES:
        # importlib (not ``from . import``): the submodule shares its name
        # with the ``timeline_table`` function, so a fromlist import would
        # re-enter this __getattr__. Bind every lazy name at once, which
        # also overwrites the package attribute ``timeline_table`` (set to
        # the module by the import) with the function.
        import importlib

        mod = importlib.import_module(".timeline_table", __name__)
        for lazy in _TIMELINE_NAMES:
            globals()[lazy] = getattr(mod, lazy)
        return globals()[name]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "Counters",
    "Interval",
    "LatencyHistogram",
    "MakespanAttribution",
    "STAGES",
    "ScenarioAttribution",
    "ServeMetrics",
    "SpanEvent",
    "SwitchRow",
    "TimelineTable",
    "Tracer",
    "attribute_scenario",
    "get_tracer",
    "span",
    "timeline_table",
    "warning_category",
    "warning_counts",
]
