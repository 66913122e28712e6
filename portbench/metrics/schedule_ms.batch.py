"""Mean of the port's ``e2e.lpt``, ``e2e.equalize`` and ``e2e.bound`` spans
together (LPT and the slot table, EQUALIZE, the makespan reduction and the
§IV bound), a call; the traced run's first call, the set-up's warm call, left
out. The device work enqueued after EQUALIZE's last host read is waited for
in ``torch.collect``, not here."""

import numpy as np

STAGES = ("e2e.lpt", "e2e.equalize", "e2e.bound")


def read(run):
    calls = sorted((sp for sp in run.spans if sp.name == "solve_many"), key=lambda sp: sp.start)[1:]
    stages = [sp for sp in run.spans if sp.name in STAGES]
    if not calls or not stages:
        return None
    return 1e3 * float(np.mean([sum(sp.duration for sp in stages if c.start <= sp.start <= c.end) for c in calls]))
