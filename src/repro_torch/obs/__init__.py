"""Observability of the port: the nested-span tracer (``trace``).

Disabled it costs one attribute check per call site; enabled it exports
Chrome trace-event JSON viewable in Perfetto (``chrome://tracing``).
"""

from .trace import SpanEvent, Tracer, get_tracer, span

__all__ = ["SpanEvent", "Tracer", "get_tracer", "span"]
