"""Mean of the port's ``e2e.decompose`` span (the inputs' upload, DECOMPOSE's
matcher calls and REFINE, with the device time its host reads wait for), a
call; the traced run's first call, the set-up's warm call, left out."""

import numpy as np


def read(run):
    calls = sorted((sp for sp in run.spans if sp.name == "solve_many"), key=lambda sp: sp.start)[1:]
    stages = [sp for sp in run.spans if sp.name == "e2e.decompose"]
    if not calls or not stages:
        return None
    return 1e3 * float(np.mean([sum(sp.duration for sp in stages if c.start <= sp.start <= c.end) for c in calls]))
