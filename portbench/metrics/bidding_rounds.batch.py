"""Mean of the report's ``extras["bidding_rounds"]`` (DECOMPOSE's matcher
rounds), a schedule."""

import numpy as np


def read(run):
    r = [x.extras["bidding_rounds"] for x in run.records if "bidding_rounds" in x.extras]
    return float(np.mean(r)) if r else None
