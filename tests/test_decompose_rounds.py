"""DECOMPOSE's round loop in one launch (``decompose_rounds``), on the CPU.

At n ≤ 128 on the card, with the built-in ``auction`` or ``auction_fr``
matcher, ``_decompose_rounds`` runs Alg. 1's whole round loop in one kernel
launch (``kernels/auction_bid/ops.py::decompose_rounds``) in place of a
host loop of matcher calls. On a CPU tensor the op takes its plain version,
``decompose_rounds_ref``. Checked here: the ε-table identity that lets the
card form each call's schedule as ``(wmax/2) · T``; which inputs take the
one-launch loop; the op's argument errors; and the plain version equal to
the host loop bit for bit. ``test_torch_kernels_cuda.py`` holds the kernel
to the loop on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.torchopt import matching as tm  # noqa: E402
from repro_torch.core.torchopt.decompose_torch import _decompose, _decompose_rounds, uses_device_loop  # noqa: E402
from repro_torch.kernels.auction_bid import decompose_rounds  # noqa: E402

CPU, CUDA = torch.device("cpu"), torch.device("cuda")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread is as fast, and does
    not oversubscribe the cores the parallel test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _lanes(n, ks, seed):
    """Lane b: a sum of ks[b] random permutations with weights in [0.05, 1.05)
    (ks[b] = 0: an all-zero lane), so the lanes end at different rounds."""
    rng = np.random.default_rng(seed)
    D = np.zeros((len(ks), n, n), np.float32)
    for b, k in enumerate(ks):
        for _ in range(k):
            D[b, np.arange(n), rng.permutation(n)] += rng.random() + 0.05
    return torch.from_numpy(D)


def _wmax_values():
    """wmax over 1e-12..1e6, random and at powers of two, and below the clamp."""
    rng = np.random.default_rng(0)
    return np.concatenate([
        10.0 ** rng.uniform(-12, 6, 40), 2.0 ** np.arange(-39, 20, 3), [1e-12, 1e6, 1e-13, 0.0],
    ]).astype(np.float32)


@pytest.mark.parametrize("lo,hi", [(5, 32), (33, 128)])
def test_eps_schedule_is_half_wmax_times_the_table(lo, hi):
    """For n ≥ 5 the final ε is wmax·2⁻²², so the schedule's ratio is the
    same for every wmax: the per-lane schedule the ratio formula gives
    (``_eps_ratio``, one lane at a time) equals ``(wmax/2) · eps_table(P)``
    bit for bit, and so does ``_eps_schedule`` on the whole batch (more
    lanes than a vector register holds, so no lane depends on its place)."""
    w = _wmax_values()
    wmax = torch.clamp_min(torch.from_numpy(w), 1e-12)
    for n in range(lo, hi + 1):
        P = tm.default_num_phases(n)
        W = torch.zeros((len(w), n, n))
        W[:, 0, n - 1] = -torch.from_numpy(w)  # |W| is what counts
        want = (wmax / 2.0)[:, None] * tm.eps_table(P)[None, :]
        assert torch.equal(tm._eps_schedule(W, P), want), n
        for b in range(len(w)):
            start, ratio = tm._eps_ratio(W[b:b + 1], P)
            lane = start[:, None] * ratio[:, None] ** torch.arange(P)[None, :]
            assert torch.equal(lane[0], want[b]), (n, float(w[b]))


def test_eps_table_is_cached_per_device():
    T = tm.eps_table(12)
    assert T.dtype == torch.float32 and T.shape == (12,) and float(T[0]) == 1.0
    assert tm.eps_table(12) is T and tm.eps_table(12, "cpu") is T
    assert float(T[-1]) == pytest.approx(2.0**-21, rel=1e-6)


def _replaced(name):
    """``name`` replaced by a wrapper of itself: the same calls, another function."""
    orig = tm.MATCHERS[name]
    tm.register_matcher(name, lambda W, **kw: orig(W, **kw), overwrite=True)
    return orig


@pytest.mark.parametrize("device,n,matcher,want", [
    (CUDA, 64, "auction", True),
    (CUDA, 128, "auction_fr", True),
    (CUDA, 5, "auction", True),
    (CPU, 64, "auction_fr", False),
    (CUDA, 4, "auction", False),
    (CUDA, 129, "auction_fr", False),
    (CUDA, 64, "auction_fused", False),
    (CUDA, 64, "replaced auction", False),
    (CUDA, 64, "replaced auction_fr", False),
])
def test_device_loop_is_taken_where_it_applies(device, n, matcher, want):
    """The one-launch loop runs on a CUDA device, 5 ≤ n ≤ 128, with the
    built-in forward or forward-reverse auction itself: a built-in name
    replaced through ``register_matcher(..., overwrite=True)`` keeps the
    host loop, so the replacement takes effect."""
    name = matcher.removeprefix("replaced ")
    orig = _replaced(name) if matcher != name else None
    try:
        assert uses_device_loop(tm.get_matcher(name), n, device) is want
    finally:
        if orig is not None:
            tm.register_matcher(name, orig, overwrite=True)
    assert tm.get_matcher(name) is {"auction": tm.match_auction, "auction_fr": tm.match_auction_fr,
                                    "auction_fused": tm.match_auction_fused}[name]


def test_replaced_matcher_runs_in_the_host_loop():
    """On the CPU every matcher runs in the host loop; a replacement's calls
    are its own, one a round."""
    calls = []
    orig = tm.MATCHERS["auction"]

    def counting(W, **kw):
        calls.append(W.shape[0])
        return orig(W, **kw)

    D = _lanes(8, [2, 3], 1)
    tm.register_matcher("auction", counting, overwrite=True)
    try:
        _, _, k, *_ = _decompose_rounds(D, "auction")
    finally:
        tm.register_matcher("auction", orig, overwrite=True)
    assert len(calls) == int(k.max()) and calls[0] == 2


@pytest.mark.parametrize("change,err", [
    (dict(D=torch.zeros((8, 8))), ValueError),
    (dict(D=torch.zeros((2, 8, 7))), ValueError),
    (dict(D=torch.zeros((0, 8, 8))), ValueError),
    (dict(D=torch.zeros((2, 129, 129))), ValueError),
    (dict(D=torch.zeros((2, 8, 8), dtype=torch.float64)), TypeError),
    (dict(D=torch.zeros((2, 8, 8)).transpose(1, 2)), ValueError),
    (dict(T=torch.ones((2, 8))), ValueError),
    (dict(T=torch.ones((0,))), ValueError),
    (dict(T=torch.ones((8,), dtype=torch.float64)), TypeError),
    (dict(T=torch.ones((16,))[::2]), ValueError),
    (dict(prices0=torch.zeros((8,))), ValueError),
    (dict(prices0=torch.zeros((2, 8), dtype=torch.float64)), ValueError),
    (dict(max_iters=-1), ValueError),
    (dict(max_iters=2**31), ValueError),
])
def test_decompose_rounds_rejects_bad_arguments(change, err):
    args = dict(D=torch.rand((2, 8, 8)).transpose(1, 2).contiguous(), T=tm.eps_table(8), max_iters=100,
                prices0=None)
    args.update(change)
    with pytest.raises(err):
        decompose_rounds(args["D"], args["T"], args["max_iters"], reverse=False, carry=True,
                         prices0=args["prices0"])


def test_decompose_rounds_rejects_another_device():
    with pytest.raises(ValueError):
        decompose_rounds(torch.rand((2, 8, 8), device="meta"), tm.eps_table(8), 100, reverse=False, carry=False)


@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("matcher", ["auction", "auction_fr"])
@pytest.mark.parametrize("n,ks", [(8, [5, 1, 0, 8]), (32, [3, 1, 0, 4]), (64, [2, 0, 3, 1])])
def test_plain_version_equals_the_host_loop(n, ks, matcher, carry):
    """``decompose_rounds`` on a CPU tensor (its plain version) against
    ``_decompose_rounds``' host loop of ``match_auction`` /
    ``match_auction_fr`` calls: perms, alphas, k, converged, rounds and
    prices bit for bit, cold and with carried prices, over lanes that end
    at different rounds and an all-zero lane."""
    D = _lanes(n, ks, n)
    p0 = torch.rand((len(ks), n), generator=torch.Generator().manual_seed(n)) if carry else None
    *want, device_loop = _decompose_rounds(D, matcher, carry, p0)
    assert device_loop is False
    got = decompose_rounds(D, tm.eps_table(tm.default_num_phases(n)), tm.default_max_iters(n),
                           reverse=matcher == "auction_fr", carry=carry, prices0=p0)
    names = ("perms", "alphas", "k", "converged", "rounds", "prices")
    for name, g, w in zip(names, got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    k = want[2]
    assert k[ks.index(0)] == 0 and len(set(k.tolist())) == len(ks)
    if not carry:
        assert torch.equal(got[5], torch.zeros((len(ks), n)))


def test_matcher_calls_are_the_largest_k():
    """``_decompose``'s third result, the span's ``rounds`` arg, is the host
    loop's count of matcher calls: max(k), read once for REFINE."""
    D = _lanes(16, [3, 1, 0, 5], 2)
    calls = []
    orig = tm.MATCHERS["auction_fr"]

    def counting(W, **kw):
        calls.append(1)
        return orig(W, **kw)

    tm.register_matcher("auction_fr", counting, overwrite=True)
    try:
        dec, _, n_calls, device_loop = _decompose(D, "auction_fr", 0, False, None)
    finally:
        tm.register_matcher("auction_fr", orig, overwrite=True)
    assert n_calls == len(calls) == int(dec.k.max()) and device_loop is False


def test_refine_takes_the_rounds_that_ran(monkeypatch):
    """``_decompose`` hands REFINE the first max(k) rounds as ``(D, perms,
    alphas, k)`` and keeps the weights past them at 0: REFINE replaced by a
    function of those four arguments that returns its weights leaves the
    round loop's α as they came."""
    from repro_torch.core.torchopt import decompose_torch

    D = _lanes(16, [3, 1, 0, 5], 4)
    seen = []

    def unchanged(D, perms, alphas, k):
        seen.append((tuple(perms.shape), tuple(alphas.shape)))
        return alphas

    _, want, k, *_ = _decompose_rounds(D, "auction")
    refined = _decompose(D, "auction", 0, False, None)[0].alphas
    monkeypatch.setattr(decompose_torch, "_refine", unchanged)
    dec = _decompose(D, "auction", 0, False, None)[0]
    kmax = int(k.max())
    assert kmax < 16 and seen == [((4, kmax, 16), (4, kmax))]
    assert torch.equal(dec.alphas, want) and not torch.equal(refined, want)


def test_decompose_span_reports_the_loop():
    """The ``e2e.decompose`` span carries ``rounds`` (matcher calls) and
    ``device_loop`` (0 on the CPU, where the host loop runs)."""
    from repro_torch.core.torchopt.e2e import spectra_torch_e2e_many
    from repro_torch.obs.trace import get_tracer

    tracer = get_tracer()
    tracer.reset()
    tracer.enable()
    try:
        res = spectra_torch_e2e_many(_lanes(8, [2, 4], 3), 2, 0.01, device="cpu", matcher="auction_fr")
        (span,) = [s for s in tracer.spans() if s.name == "e2e.decompose"]
    finally:
        tracer.disable()
        tracer.reset()
    assert span.args == {"rounds": int(res.dec.k.max()), "device_loop": 0}
