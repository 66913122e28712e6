"""95th percentile over every solve of the window of the host-clock time from
the call to the report's schedule on the host (a failed solve counts as
infinitely slow)."""

import numpy as np


def read(run):
    lat = [r.latency_s for r in run.records]
    with np.errstate(invalid="ignore"):  # inf - inf: a run past help reads NaN and is left out
        return float(np.percentile(lat, 95)) * 1e3 if lat else None
