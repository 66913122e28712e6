"""SLO observability for the scheduling control plane.

The implementation lives in ``repro_torch.obs.metrics`` so serving,
scenarios and benchmarks share one metrics vocabulary; this module
re-exports the serving-facing names, as ``repro.serve.metrics`` does.
"""

from __future__ import annotations

from ..obs.metrics import STAGES, LatencyHistogram, ServeMetrics

__all__ = ["STAGES", "LatencyHistogram", "ServeMetrics"]
