"""moe n=64 through the port's fused pipeline against the reference's.

Kept in its own file: it is the heaviest parity case (a dense 64×64
matrix, 63 DECOMPOSE rounds of the forward-reverse auction), so the
file-level test distribution runs it beside the others.
"""

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.traffic.workloads import moe_workload  # noqa: E402
from test_torch_e2e import _one_torch_thread, assert_e2e_parity  # noqa: E402,F401


def test_moe_n64():
    Ds = moe_workload(rng=np.random.default_rng(3))[None]
    mine, _ = assert_e2e_parity(Ds, 4, 0.01)
    assert int(mine.dec.k[0]) == 63
