"""Mean host reads (synchronizing CUDA operations, counted by the sync debug
mode: a lower bound) of the port's ``torch.dispatch`` and ``torch.collect``
spans together, a call; the traced run's first call, the set-up's warm call,
left out."""

import numpy as np


def read(run):
    calls = sorted((sp for sp in run.spans if sp.name == "solve_many"), key=lambda sp: sp.start)[1:]
    spans = [sp for sp in run.spans
             if sp.name in ("torch.dispatch", "torch.collect") and "host_reads" in (sp.args or {})]
    if not calls or not spans:
        return None
    return float(np.mean([sum(sp.args["host_reads"] for sp in spans if c.start <= sp.start <= c.end) for c in calls]))
