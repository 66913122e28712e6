"""The benchmark's generator copies give the same matrices as the port's
originals for the same seed, and a closed loop's pool gives every run the
same matrices."""

from __future__ import annotations

import numpy as np
import pytest

from portbench.traffic import generators as gen
from repro_torch.scenarios.registry import get_family
from repro_torch.scenarios.spec import TrafficSpec
from repro_torch.traffic import workloads


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11])
def test_moe_workload(seed):
    for kw in ({}, {"n": 16, "skew": 0.5, "noise": 0.01}):
        a = gen.moe_workload(rng=np.random.default_rng(seed), **kw)
        b = workloads.moe_workload(rng=np.random.default_rng(seed), **kw)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11])
def test_permutations_workload(seed):
    a = gen.permutations_workload(n=64, k=16, rng=np.random.default_rng(seed))
    b = workloads.permutations_workload(n=64, k=16, rng=np.random.default_rng(seed))
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("family,params", [("moe", {}), ("permutations", {"k": 16})])
def test_families_equal_the_registered_ones(family, params):
    for tenant_seed in (0, 2):
        spec = TrafficSpec(family=family, n=32, s=4, delta=0.01, periods=6, seed=tenant_seed, params=params)
        for t in range(6):
            a = gen.FAMILIES[family](32, tenant_seed, params, t, np.random.default_rng(100 + t))
            b, _ = get_family(family)(spec, t, np.random.default_rng(100 + t))
            np.testing.assert_array_equal(a, b)


def test_closed_loop_matrices_differ_by_index():
    a = gen.closed_loop_matrix("moe", 16, {}, 5, 0)
    b = gen.closed_loop_matrix("moe", 16, {}, 5, 1)
    c = gen.closed_loop_matrix("moe", 16, {}, 5, 0)
    assert not np.array_equal(a, b)
    np.testing.assert_array_equal(a, c)


def test_pool_is_the_same_set_for_every_seed_and_cycles():
    cfg = {"family": "moe", "n": 8, "params": {}}
    mix = {"pool": 6, "pool_seed": 11}
    a, b = gen.closed_loop_source(cfg, mix, 2**31 + 5), gen.closed_loop_source(cfg, mix, 3)
    key = [x.tobytes() for x in (a(j) for j in range(6))]
    assert sorted(key) == sorted(x.tobytes() for x in (b(j) for j in range(6)))
    assert len(set(key)) == 6
    assert all(a(j) is a(j + 6) for j in range(6))
    again = gen.closed_loop_source(cfg, mix, 2**31 + 5)
    assert all(np.array_equal(a(j), again(j)) for j in range(12))
    warm = gen.warm_matrices(cfg, mix, 3)
    assert not any(w.tobytes() in key for w in warm)
