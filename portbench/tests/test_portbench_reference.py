"""The frozen reference equals the port's host ``spectra`` at the commit it
was frozen from, and the replay reads schedules as the port's own objects
do. The test may import the port; the reference may not."""

from __future__ import annotations

import numpy as np
import pytest

from portbench.reference import replay
from portbench.reference import spectra as ref
from portbench.reference.lowprec import control_switches, to_bf16
from portbench.traffic.generators import closed_loop_matrix
from repro_torch.core import lower_bounds as port_lb
from repro_torch.core.spectra import spectra as port_spectra
from repro_torch.scenarios.registry import get_family
from repro_torch.scenarios.spec import TrafficSpec

PAPER_D = np.array([
    [0.60, 0.30, 0.00, 0.10],
    [0.00, 0.61, 0.39, 0.00],
    [0.00, 0.09, 0.61, 0.30],
    [0.40, 0.00, 0.00, 0.60],
])


def _instances():
    yield "paper", PAPER_D, 2, 0.01
    for seed in range(3):
        yield f"moe{seed}", closed_loop_matrix("moe", 12, {}, seed, 0), 4, 0.01
        yield f"perm{seed}", closed_loop_matrix("permutations", 16, {"k": 6}, seed, 0), 4, 0.01
        spec = TrafficSpec(family="moe_phases", n=16, s=3, delta=0.02, periods=4, seed=seed, params={"phases": 2})
        yield f"phases{seed}", get_family("moe_phases")(spec, seed, np.random.default_rng(seed))[0], 3, 0.02


@pytest.mark.parametrize("name,D,s,delta", list(_instances()), ids=lambda v: v if isinstance(v, str) else "")
def test_frozen_spectra_equals_port_host_spectra(name, D, s, delta):
    mine, theirs = ref.spectra(D, s, delta), port_spectra(D, s, delta)
    assert len(mine.decomposition.perms) == len(theirs.decomposition.perms) == ref.degree(D)
    for a, b in zip(mine.decomposition.perms, theirs.decomposition.perms):
        np.testing.assert_array_equal(a, b)
    assert mine.decomposition.alphas == theirs.decomposition.alphas
    assert len(mine.schedule.switches) == len(theirs.schedule.switches) == s
    for sa, sb in zip(mine.schedule.switches, theirs.schedule.switches):
        assert sa.alphas == sb.alphas
        for a, b in zip(sa.perms, sb.perms):
            np.testing.assert_array_equal(a, b)
    assert mine.makespan == theirs.makespan
    assert mine.lower_bound == theirs.lower_bound == port_lb.lower_bound(D, s, delta)


def test_paper_example_makespan():
    res = ref.spectra(PAPER_D, 2, 0.01)
    assert res.makespan == pytest.approx(0.53)
    np.testing.assert_allclose(res.schedule.loads(), [0.53, 0.53])


def test_hungarian_equals_scipy_matching():
    rng = np.random.default_rng(0)
    for n in (5, 12, 30):
        W = rng.random((n, n))
        a, b = ref.hungarian_min_cost(-W), ref.max_weight_perfect_matching(W)
        assert W[np.arange(n), a].sum() == pytest.approx(W[np.arange(n), b].sum())


@pytest.mark.parametrize("name,D,s,delta", list(_instances()), ids=lambda v: v if isinstance(v, str) else "")
def test_replay_reads_the_port_schedule(name, D, s, delta):
    theirs = port_spectra(D, s, delta)
    r = replay.read(D, replay.from_parallel_schedule(theirs.schedule), s, delta)
    assert r.invalid == ""
    assert r.cover_gap <= 1e-12
    assert r.makespan == pytest.approx(theirs.makespan, rel=1e-12)
    assert r.lower_bound == theirs.lower_bound
    assert r.k_ref == ref.degree(D)


def test_replay_finds_malformed_schedules():
    D = PAPER_D
    good = replay.from_parallel_schedule(ref.spectra(D, 2, 0.01).schedule)
    assert replay.read(D, good, 2, 0.01).invalid == ""
    bad_perm = [(p.copy(), a) for p, a in good]
    bad_perm[0][0][0, :] = 0
    assert "not a permutation" in replay.read(D, bad_perm, 2, 0.01).invalid
    neg = [(p, a.copy()) for p, a in good]
    neg[1][1][0] = -1.0
    assert "negative" in replay.read(D, neg, 2, 0.01).invalid
    assert "switches" in replay.read(D, good[:1], 2, 0.01).invalid
    short = [(p, a * 0.999) for p, a in good]
    assert replay.read(D, short, 2, 0.01).cover_gap > 1e-4


def test_bf16_rounding_matches_torch():
    import torch

    x = np.random.default_rng(1).random(4096) * 7
    ref_bits = torch.tensor(x, dtype=torch.float32).to(torch.bfloat16).double().numpy()
    np.testing.assert_array_equal(to_bf16(x), ref_bits)


def test_control_breaks_coverage():
    D = closed_loop_matrix("moe", 12, {}, 3, 0)
    r = replay.read(D, control_switches(D, 4, 0.01), 4, 0.01)
    assert r.invalid == ""
    assert r.cover_gap > 1e-4


@pytest.mark.parametrize("name,D,s,delta", list(_instances()), ids=lambda v: v if isinstance(v, str) else "")
def test_makespans_of_the_reference_schedule_read_no_excess(name, D, s, delta):
    """The reference's own schedule is no worse than the reference, and its
    configurations, merged over the switches, rescheduled give it again."""
    sched = replay.from_parallel_schedule(ref.spectra(D, s, delta).schedule)
    m = replay.makespans(D, sched, s, delta)
    assert abs(m.excess) <= 1e-12
    assert abs(m.schedule_excess) <= 1e-12


def test_configurations_merge_split_pieces():
    sched = ref.spectra(PAPER_D, 2, 0.01)
    dec = replay.configurations(replay.from_parallel_schedule(sched.schedule))
    assert len(dec.perms) == len(sched.decomposition.perms)
    for perm, a in zip(sched.decomposition.perms, sched.decomposition.alphas):
        i = next(i for i, p in enumerate(dec.perms) if np.array_equal(p, perm))
        assert dec.alphas[i] == pytest.approx(a, rel=1e-12)


def test_makespans_find_a_schedule_on_one_switch():
    sched = replay.from_parallel_schedule(ref.spectra(PAPER_D, 2, 0.01).schedule)
    merged = replay.configurations(sched)
    one = [(np.stack(merged.perms), np.asarray(merged.alphas)), (np.zeros((0, 4), np.int64), np.zeros(0))]
    m = replay.makespans(PAPER_D, one, 2, 0.01)
    assert m.excess > 0.5 and m.schedule_excess > 0.5
