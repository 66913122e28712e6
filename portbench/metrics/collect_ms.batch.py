"""Mean of the port's ``torch.collect`` span (PendingBatch.collect: the wait
for the device results and the reports' assembly), a bucket."""

import numpy as np


def read(run):
    d = [sp.duration for sp in run.spans if sp.name == "torch.collect"]
    return float(np.mean(d)) * 1e3 if d else None
