"""Mean over every schedule of the window of its makespan, replayed from the
returned permutations, weights and switches (Eq. 3), over the reference's
§IV lower bound of its demand."""

import numpy as np


def read(run):
    r = [x.reading.makespan / x.reading.lower_bound for x in run.valid if x.reading.lower_bound > 0]
    return float(np.mean(r)) if r else None
