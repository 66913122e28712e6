"""Each CUDA kernel of the port against its plain PyTorch version, on the card.

Marked ``requires_cuda``: they skip without a CUDA device. On the GPU host
(which has no JAX) run them with

    python -m pytest tests/test_torch_kernels_cuda.py -q -m requires_cuda

The auction kernels (``masked_row_top2``, ``auction_rounds``,
``fused_auction``) must equal their plain versions exactly, on inputs full
of ties; flash_attention (bfloat16 on the tensor cores, float32 on the CUDA
cores) and ssd_chunk hold to the tolerances stated below.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.torchopt.matching import _eps_schedule, default_max_iters, default_num_phases  # noqa: E402
from repro_torch.kernels.auction_bid import (  # noqa: E402
    auction_rounds,
    auction_rounds_ref,
    masked_row_top2,
    masked_row_top2_ref,
)
from repro_torch.kernels.auction_fused import fused_auction, fused_auction_ref  # noqa: E402

pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bonus_weights(rng, n, k=8, floor=0.05):
    """A sum of k random permutations plus DECOMPOSE's node-coverage M-bonus."""
    D = np.zeros((n, n))
    for _ in range(k):
        D[np.arange(n), rng.permutation(n)] += rng.random() + floor
    S = D > 0
    rd, cd = S.sum(1), S.sum(0)
    top = max(rd.max(), cd.max())
    M = D.max(axis=1).sum() + 1.0
    return (D + np.where(S, M * ((rd == top)[:, None] + (cd == top)[None, :]), 0)).astype(np.float32)


@pytest.mark.parametrize("B,n", [(8, 32), (8, 64), (8, 100), (4, 128), (2, 1)])
def test_bid_kernel_equals_plain(cuda, B, n):
    rng = np.random.default_rng(n)
    W = torch.from_numpy(rng.integers(0, 3, (B, n, n)).astype(np.float32)).to(cuda)
    p = torch.from_numpy(rng.integers(0, 2, (B, n)).astype(np.float32)).to(cuda)
    before = masked_row_top2.launches
    got = masked_row_top2(W, p)
    torch.cuda.synchronize()
    assert masked_row_top2.launches == before + 1
    for g, w in zip(got, masked_row_top2_ref(W, p)):
        assert torch.equal(g, w)


def test_bid_kernel_rejects_strided_input(cuda):
    W = torch.zeros((2, 8, 8), device=cuda)
    with pytest.raises(ValueError):
        masked_row_top2(W.transpose(1, 2), torch.zeros((2, 8), device=cuda))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 64, 100, 128])
def test_rounds_kernel_equals_plain(cuda, n, reverse):
    """Every phase and round in one launch, bit for bit: DECOMPOSE-like
    weights and a tie-rich integer lane, the full round budget and one cut
    to 5 rounds a phase."""
    rng = np.random.default_rng(n)
    W = torch.from_numpy(np.stack([_bonus_weights(rng, n), _bonus_weights(rng, n, k=3),
                                   rng.integers(0, 3, (n, n)).astype(np.float32)])).to(cuda)
    eps = _eps_schedule(W, default_num_phases(n)).contiguous()
    for max_iters in (default_max_iters(n), 5):
        before = auction_rounds.launches
        got = auction_rounds(W, eps, max_iters, reverse=reverse)
        torch.cuda.synchronize()
        assert auction_rounds.launches == before + 1
        for g, w in zip(got, auction_rounds_ref(W, eps, max_iters, reverse=reverse)):
            assert torch.equal(g, w)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n", [1, 32, 64, 100, 128])
def test_rounds_kernel_warm_prices_equal_plain(cuda, n, reverse):
    """``prices0`` (a previous call's final prices, at the M-bonus scale, and
    a strided view of them) bit for bit against the plain version; a zeros
    ``prices0`` equals ``None``. Each launch with prices counts as warm."""
    rng = np.random.default_rng(n + 1000)
    W = torch.from_numpy(np.stack([_bonus_weights(rng, n), _bonus_weights(rng, n, k=3),
                                   rng.integers(0, 3, (n, n)).astype(np.float32)])).to(cuda)
    eps = _eps_schedule(W, default_num_phases(n)).contiguous()
    mi = default_max_iters(n)
    W2 = (W * (1.0 + 0.01 * torch.rand_like(W))).contiguous()
    p0 = auction_rounds(W2, eps, mi, reverse=reverse)[2]
    for prices0 in (p0, torch.stack([p0, p0], dim=2)[:, :, 0]):
        before = auction_rounds.warm_launches
        got = auction_rounds(W, eps, mi, reverse=reverse, prices0=prices0)
        torch.cuda.synchronize()
        assert auction_rounds.warm_launches == before + 1
        for g, w in zip(got, auction_rounds_ref(W, eps, mi, reverse=reverse, prices0=prices0)):
            assert torch.equal(g, w)
    cold = auction_rounds(W, eps, mi, reverse=reverse)
    zeros = auction_rounds(W, eps, mi, reverse=reverse, prices0=torch.zeros_like(p0))
    for c, z in zip(cold, zeros):
        assert torch.equal(c, z)


@pytest.mark.parametrize("B,n", [(4, 129), (8, 37), (3, 1000)])
def test_bid_kernel_equals_plain_with_4_byte_loads(cuda, B, n):
    """Widths 4 does not divide take the op's 4-byte loads, bit for bit on
    random and tie-rich weights."""
    rng = np.random.default_rng(n)
    for W in (torch.from_numpy(rng.random((B, n, n), dtype=np.float32)).to(cuda),
              torch.from_numpy(rng.integers(0, 3, (B, n, n)).astype(np.float32)).to(cuda)):
        p = torch.from_numpy(rng.integers(0, 2, (B, n)).astype(np.float32)).to(cuda)
        for g, w in zip(masked_row_top2(W, p), masked_row_top2_ref(W, p)):
            assert torch.equal(g, w)


@pytest.mark.parametrize("B,n", [(4, 160), (4, 256), (4, 512)])
def test_bid_kernel_equals_plain_above_128(cuda, B, n):
    """The op at the widths the round loop gives it above n = 128: random
    and tie-rich, W and W.T."""
    rng = np.random.default_rng(n)
    for W in (torch.from_numpy(rng.random((B, n, n), dtype=np.float32)).to(cuda),
              torch.from_numpy(rng.integers(0, 3, (B, n, n)).astype(np.float32)).to(cuda)):
        p = torch.from_numpy(rng.integers(0, 2, (B, n)).astype(np.float32)).to(cuda)
        for Wx in (W, W.transpose(1, 2).contiguous()):
            for g, w in zip(masked_row_top2(Wx, p), masked_row_top2_ref(Wx, p)):
                assert torch.equal(g, w)


@pytest.mark.parametrize("matcher", ["auction", "auction_fr"])
@pytest.mark.parametrize("n", [160, 256])
def test_matchers_above_128_on_the_card_equal_the_cpu(cuda, matcher, n):
    """Above n = 128 a matcher call is the round loop, one ``masked_row_top2``
    launch a round on the card: perms, prices and rounds equal the CPU's
    plain path bit for bit (the round budget cut to keep the CPU side short)."""
    from repro_torch.core.torchopt.matching import MATCHERS

    rng = np.random.default_rng(n)
    W = np.stack([_bonus_weights(rng, n), rng.random((n, n), dtype=np.float32)])
    before = masked_row_top2.launches
    got = MATCHERS[matcher](torch.from_numpy(W).to(cuda), max_iters=400)
    torch.cuda.synchronize()
    assert masked_row_top2.launches > before
    want = MATCHERS[matcher](torch.from_numpy(W), max_iters=400)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("B,n,kernel", [(4, 100, "cluster"), (2, 256, "cluster"), (4, 100, "block"),
                                          (2, 256, "block"), (1, 1024, "block")])
def test_fused_kernel_equals_plain(cuda, B, n, kernel):
    rng = np.random.default_rng(n)
    W = torch.from_numpy(np.stack([_bonus_weights(rng, n) for _ in range(B)])).to(cuda)
    eps = ((W.amax(dim=(1, 2)) / 2)[:, None] * (0.25 ** torch.arange(8, device=cuda))[None, :]).contiguous()
    p0 = torch.zeros((B, n), device=cuda)
    before, before_cluster = fused_auction.launches, fused_auction.cluster_launches
    got = fused_auction(W, p0, eps, max_iters=default_max_iters(n), kernel=kernel)
    torch.cuda.synchronize()
    assert fused_auction.launches == before + 1
    assert fused_auction.cluster_launches == before_cluster + (kernel == "cluster")
    for g, w in zip(got, fused_auction_ref(W, p0, eps, max_iters=default_max_iters(n))):
        assert torch.equal(g, w)


@pytest.mark.parametrize("budget", ["full", "warm prices", "max_iters 5"])
@pytest.mark.parametrize("cluster,n", [(8, 129), (8, 500), (8, 512), (8, 645), (16, 500), (16, 893)])
def test_fused_cluster_kernel_equals_plain(cuda, cluster, n, budget):
    """The cluster kernel at ragged n (R = ⌈n / cluster⌉ rows a CTA, a short
    last CTA), at n = 512 and at the largest n it serves, bit for bit: from
    zero prices, from warm prices (as DECOMPOSE's carry would give), and with
    the round budget cut to 5 a phase."""
    from repro_torch.kernels.auction_fused.ops import cluster_max_n

    assert n <= cluster_max_n(cluster)
    rng = np.random.default_rng(n + cluster)
    B = 2
    W = torch.from_numpy(np.stack([_bonus_weights(rng, n, k=16) for _ in range(B)])).to(cuda)
    eps = _eps_schedule(W, default_num_phases(n)).contiguous()
    p0 = torch.zeros((B, n), device=cuda)
    if budget == "warm prices":
        p0 = (torch.from_numpy(rng.random((B, n)).astype(np.float32)).to(cuda) * W.amax(dim=(1, 2))[:, None] / 8).contiguous()
    mi = 5 if budget == "max_iters 5" else default_max_iters(n)
    before = fused_auction.cluster_launches
    got = fused_auction(W, p0, eps, max_iters=mi, kernel="cluster", cluster=cluster)
    torch.cuda.synchronize()
    assert fused_auction.cluster_launches == before + 1
    for g, w in zip(got, fused_auction_ref(W, p0, eps, max_iters=mi)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("B,n,kernel", [(1, 256, "cluster"), (4, 512, "cluster"), (1, 1024, "block"),
                                        (6, 256, "block")])
def test_fused_picked_kernel_equals_plain(cuda, B, n, kernel):
    """With no kernel named, the wrapper's pick (16-CTA clusters for up to
    four lanes where W fits them, else one block a lane) launches that kernel
    and equals the plain version bit for bit."""
    rng = np.random.default_rng(B * n)
    W = torch.from_numpy(np.stack([_bonus_weights(rng, n, k=16) for _ in range(B)])).to(cuda)
    eps = _eps_schedule(W, default_num_phases(n)).contiguous()
    p0 = torch.zeros((B, n), device=cuda)
    before = fused_auction.cluster_launches
    got = fused_auction(W, p0, eps, max_iters=default_max_iters(n))
    torch.cuda.synchronize()
    assert fused_auction.cluster_launches == before + (kernel == "cluster")
    for g, w in zip(got, fused_auction_ref(W, p0, eps, max_iters=default_max_iters(n))):
        assert torch.equal(g, w)


@pytest.mark.parametrize("max_swaps", ["2n", 3])
@pytest.mark.parametrize("kind", ["random", "ties", "bonus"])
@pytest.mark.parametrize("n", [7, 129, 256, 1024])
def test_polish_kernel_equals_plain(cuda, n, kind, max_swaps):
    """polish_2swap (greedy completion and the 2-swap polish in one launch)
    against its plain version, bit for bit in perm and converged, from maps
    with a seventh of the rows unassigned (so the polish swaps), with the
    matcher's budget (2n swaps) and with 3."""
    from repro_torch.kernels.auction_fused import polish_2swap, polish_2swap_ref

    rng = np.random.default_rng(n)
    B = 2
    if kind == "random":
        W = rng.random((B, n, n), dtype=np.float32)
    elif kind == "ties":
        W = rng.integers(0, 3, (B, n, n)).astype(np.float32)
    else:
        W = np.stack([_bonus_weights(rng, n, k=16) for _ in range(B)])
    r2c, c2r = [], []
    for _ in range(B):
        r, c = rng.permutation(n), np.empty(n, dtype=np.int64)
        c[r] = np.arange(n)
        drop = rng.choice(n, max(1, n // 7), replace=False)
        c[r[drop]] = -1
        r[drop] = -1
        r2c.append(r)
        c2r.append(c)
    W = torch.from_numpy(W).to(cuda)
    r2c = torch.from_numpy(np.stack(r2c)).to(cuda).int()
    c2r = torch.from_numpy(np.stack(c2r)).to(cuda).int()
    budget = 2 * n if max_swaps == "2n" else max_swaps
    before = polish_2swap.launches
    got = polish_2swap(W, r2c, c2r, max_swaps=budget)
    torch.cuda.synchronize()
    assert polish_2swap.launches == before + 1
    for g, w in zip(got, polish_2swap_ref(W, r2c, c2r, max_swaps=budget)):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# flash_attention and ssd_chunk: float32 to accumulation order (atol 1e-4),
# bfloat16 to the rounding of the output (atol 2e-2 on values of order 1).
# ---------------------------------------------------------------------------

from repro_torch.kernels.flash_attention import flash_attention, mha_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_chunk, ssd_chunk_ref, ssd_ref, ssd_scan  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import _pick_chunk  # noqa: E402

_ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,causal,window", [
    (2, 4, 4, 256, 256, 64, True, None),
    (1, 8, 2, 200, 200, 128, True, None),   # GQA, ragged tiles
    (1, 4, 4, 300, 300, 32, True, 64),      # sliding window
    (1, 4, 2, 100, 300, 64, True, None),    # Sq < Sk
    (1, 2, 1, 77, 130, 64, False, None),    # no mask
    (1, 6, 2, 333, 333, 64, True, None),    # Sq a multiple of neither query tile
    (1, 4, 4, 256, 250, 64, False, None),   # Sk not a multiple of the key tile
    (1, 4, 2, 100, 357, 32, True, 50),      # D = 32, window, Sq < Sk
    (1, 8, 4, 400, 401, 128, True, None),   # D = 128, GQA, Sq < Sk
    (2, 4, 1, 1000, 1000, 64, True, 128),   # GQA 4:1, window across key tiles
    (2, 32, 4, 2048, 2048, 128, True, None),  # qwen3-moe prefill, GQA 8:1
    (2, 12, 2, 4096, 4096, 128, True, None),  # qwen2-vl, GQA 6:1
    (4, 6, 6, 1500, 1500, 64, False, None),   # whisper encoder, Sk not a multiple of the key tile
    (4, 6, 6, 448, 1500, 64, False, None),    # whisper cross-attention, Sq ≠ Sk
    (4, 6, 6, 448, 448, 64, True, None),      # whisper decoder self-attention, a partial last key tile
])
def test_flash_kernel_equals_plain(cuda, dtype, B, Hq, Hkv, Sq, Sk, D, causal, window):
    gen = torch.Generator(device=cuda).manual_seed(Sq)
    q = torch.randn((B, Hq, Sq, D), generator=gen, device=cuda).to(dtype)
    k = torch.randn((B, Hkv, Sk, D), generator=gen, device=cuda).to(dtype)
    v = torch.randn((B, Hkv, Sk, D), generator=gen, device=cuda).to(dtype)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = mha_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=_ATOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BH,S,N,P", [(8, 512, 64, 64), (4, 96, 16, 16), (2, 256, 128, 128), (3, 40, 8, 24),
                                     (2, 192, 64, 64), (2, 64, 12, 20), (128, 96, 64, 64)])
def test_ssd_chunk_kernel_equals_plain(cuda, dtype, BH, S, N, P):
    gen = torch.Generator(device=cuda).manual_seed(S)
    xd = torch.randn((BH, S, P), generator=gen, device=cuda).to(dtype)
    loga = -0.5 * torch.rand((BH, S), generator=gen, device=cuda)
    B = (torch.randn((BH, S, N), generator=gen, device=cuda) / N ** 0.5).to(dtype)
    C = (torch.randn((BH, S, N), generator=gen, device=cuda) / N ** 0.5).to(dtype)
    L = _pick_chunk(S)
    before = ssd_chunk.launches
    got = ssd_chunk(xd, loga, B, C, L)
    torch.cuda.synchronize()
    assert ssd_chunk.launches == before + 1
    for g, w in zip(got, ssd_chunk_ref(xd, loga, B, C, L)):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    if S <= 256:  # the whole op against the sequential scan
        y, hT = ssd_scan(xd, loga, B, C)
        y_ref, h_ref = ssd_ref(xd, loga, B, C)
        torch.testing.assert_close(y.float(), y_ref.float(), rtol=0, atol=_ATOL[dtype])
        torch.testing.assert_close(hT, h_ref, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# Gradients through the kernel-backed ops: the forward launches the kernel,
# the backward recomputes through the plain version, so the gradients equal
# the plain versions' own (float32, to 1e-4 of each gradient's largest entry:
# the forward's sum order differs, the backward's does not).
# ---------------------------------------------------------------------------

from repro_torch.kernels.flash_attention import mha  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_chunked  # noqa: E402


def _grads(fn, inputs, seeds):
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*leaves)
    out = out if isinstance(out, tuple) else (out,)
    return torch.autograd.grad(out, leaves, seeds)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 32), (False, None)])
def test_mha_gradients_equal_plain(cuda, causal, window):
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn(s, generator=gen, device=cuda) for s in ((2, 4, 128, 64), (2, 2, 128, 64), (2, 2, 128, 64)))
    g = torch.randn((2, 4, 128, 64), generator=gen, device=cuda)
    before = flash_attention.launches
    got = _grads(lambda *a: mha(*a, causal=causal, window=window), (q, k, v), (g,))
    assert flash_attention.launches == before + 1
    want = _grads(lambda *a: mha_ref(*a, causal=causal, window=window), (q, k, v), (g,))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * float(b.abs().max()))


@pytest.mark.parametrize("BH,S,N,P", [(4, 256, 64, 64), (2, 96, 16, 32)])
def test_ssd_scan_gradients_equal_plain(cuda, BH, S, N, P):
    gen = torch.Generator(device=cuda).manual_seed(S)
    xd = torch.randn((BH, S, P), generator=gen, device=cuda)
    loga = -0.5 * torch.rand((BH, S), generator=gen, device=cuda)
    B, C = ((torch.randn((BH, S, N), generator=gen, device=cuda) / N ** 0.5) for _ in range(2))
    h0 = torch.randn((BH, N, P), generator=gen, device=cuda)
    seeds = (torch.randn((BH, S, P), generator=gen, device=cuda), torch.randn((BH, N, P), generator=gen, device=cuda))
    before = ssd_chunk.launches
    got = _grads(ssd_scan, (xd, loga, B, C, h0), seeds)
    assert ssd_chunk.launches == before + 1
    for fn in (ssd_chunked, ssd_ref):
        want = _grads(fn, (xd, loga, B, C, h0), seeds)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * float(b.abs().max()))


# ---------------------------------------------------------------------------
# demand_accum: float atomics sum in an order that changes from run to run,
# so the kernel is held to a float64 sum of the same events, within 1e-5 of
# each cell's mass Σ|w| (plus 1e-30 for empty cells), and to the plain
# version within twice that (each of the two is within 1e-5 of the exact sum).
# ---------------------------------------------------------------------------

from repro_torch.kernels.demand_accum import demand_accum, demand_accum_ref, in_range  # noqa: E402


def _exact(src, dst, w, n):
    keep = in_range(src, dst, n)
    out = torch.zeros((n, n), dtype=torch.float64, device=src.device)
    mass = torch.zeros_like(out)
    idx = (src[keep].long(), dst[keep].long())
    out.index_put_(idx, w[keep].double(), accumulate=True)
    mass.index_put_(idx, w[keep].double().abs(), accumulate=True)
    return out, mass


@pytest.mark.parametrize("T,n,kind", [
    (1 << 20, 64, "uniform"), (1 << 18, 512, "uniform"), (1000, 64, "uniform"), (1, 4, "uniform"),
    (1 << 16, 64, "one cell"), (5000, 130, "out of range"), (3000, 300, "out of range"),
])
@pytest.mark.parametrize("itype", [torch.int32, torch.int64])
def test_demand_accum_kernel_equals_plain(cuda, T, n, kind, itype):
    gen = torch.Generator(device=cuda).manual_seed(T + n)
    if kind == "one cell":
        src = dst = torch.full((T,), n // 3, dtype=itype, device=cuda)
    else:
        lo, hi = (-3, n + 3) if kind == "out of range" else (0, n)
        src, dst = (torch.randint(lo, hi, (T,), generator=gen, device=cuda, dtype=itype) for _ in range(2))
    w = torch.rand((T,), generator=gen, device=cuda) - (0.3 if kind == "out of range" else 0.0)
    before = demand_accum.launches
    got = demand_accum(src, dst, w, n=n)
    torch.cuda.synchronize()
    assert demand_accum.launches == before + 1
    exact, mass = _exact(src, dst, w, n)
    assert bool(((got.double() - exact).abs() <= 1e-5 * mass + 1e-30).all())
    plain = demand_accum_ref(src, dst, w, n)
    assert bool(((got.double() - plain.double()).abs() <= 2e-5 * mass + 1e-30).all())


def _views(src, dst, w, view):
    """``aligned``: as made; ``one in``: all three one element in (their
    16-byte groups start at event 3); ``w one in``: only w one in (the
    arrays' groups do not line up, so every event is loaded alone)."""
    if view == "one in":
        return src[1:], dst[1:], w[1:]
    if view == "w one in":
        return src[:-1], dst[:-1], w[1:]
    return src, dst, w


# n on each side of the launcher's edge (private copies in a CTA's shared
# memory up to n = 241, global atomics above) and well above it.
@pytest.mark.parametrize("n", [1, 64, 241, 242, 300, 512, 1024])
@pytest.mark.parametrize("itype", [torch.int32, torch.int64])
def test_demand_accum_every_path_equals_plain(cuda, n, itype):
    gen = torch.Generator(device=cuda).manual_seed(n)
    T = (1 << 18) + 3  # not a multiple of 4
    src, dst = (torch.randint(-2, n + 2, (T,), generator=gen, device=cuda, dtype=itype) for _ in range(2))
    w = torch.rand((T,), generator=gen, device=cuda) - 0.25
    for view in ("aligned", "one in", "w one in"):
        s, d, x = _views(src, dst, w, view)
        got = demand_accum(s, d, x, n=n)
        torch.cuda.synchronize()
        exact, mass = _exact(s, d, x, n)
        assert bool(((got.double() - exact).abs() <= 1e-5 * mass + 1e-30).all()), view
        plain = demand_accum_ref(s, d, x, n)
        assert bool(((got.double() - plain.double()).abs() <= 2e-5 * mass + 1e-30).all()), view


@pytest.mark.parametrize("n,kind", [(64, "one cell"), (512, "one cell"), (64, "skewed"), (300, "skewed"),
                                    (2000, "skewed")])
def test_demand_accum_contention_equals_plain(cuda, n, kind):
    """Many events on few cells: every event on one cell, or 90% of them on
    1% of the cells."""
    from chip_smoke import accum_events

    gen = torch.Generator(device=cuda).manual_seed(n)
    src, dst, w = accum_events(kind, 1 << 20, n, gen)
    got = demand_accum(src, dst, w, n=n)
    exact, mass = _exact(src, dst, w, n)
    assert bool(((got.double() - exact).abs() <= 1e-5 * mass + 1e-30).all())
    assert bool(((got.double() - demand_accum_ref(src, dst, w, n).double()).abs() <= 2e-5 * mass + 1e-30).all())


def test_demand_accum_kernel_low_precision_weights(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    src, dst = (torch.randint(0, 64, (4096,), generator=gen, device=cuda) for _ in range(2))
    w = torch.rand((4096,), generator=gen, device=cuda).to(torch.bfloat16)
    exact, mass = _exact(src, dst, w.float(), 64)
    assert bool(((demand_accum(src, dst, w, n=64).double() - exact).abs() <= 1e-5 * mass + 1e-30).all())
    e = torch.zeros((0,), dtype=torch.int32, device=cuda)
    assert not demand_accum(e, e, torch.zeros((0,), device=cuda), n=8).any()


# ---------------------------------------------------------------------------
# The MoE dispatch on the card: the stable top-K and the per-row groups.
# ---------------------------------------------------------------------------

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models.blocks import MoE, top_k_stable  # noqa: E402


def test_top_k_stable_ties_on_the_card_equal_the_cpu(cuda):
    probs = torch.from_numpy(np.random.default_rng(0).integers(0, 4, (4096, 128)).astype(np.float32))
    want_v, want_i = top_k_stable(probs, 8)
    got_v, got_i = top_k_stable(probs.to(cuda), 8)
    assert torch.equal(got_i.cpu(), want_i) and torch.equal(got_v.cpu(), want_v)


@pytest.mark.parametrize("B,S", [(2, 64), (1, 16)])  # one group per row (S ≥ 4·E), one global group
def test_moe_block_on_the_card_equals_the_cpu(cuda, B, S):
    cfg = get_arch("qwen3-moe-30b-a3b").reduced()
    cpu = MoE(cfg, torch.Generator().manual_seed(0))
    gpu = MoE(cfg, torch.Generator(device=cuda).manual_seed(1), device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    x = torch.from_numpy(np.random.default_rng(S).standard_normal((B, S, cfg.d_model), dtype=np.float32))
    with torch.no_grad():
        want, want_stats = cpu(x)
        got, got_stats = gpu(x.to(cuda))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5, atol=1e-5 * float(want.abs().max()))
    assert torch.equal(got_stats["expert_load"].cpu(), want_stats["expert_load"])


# ---------------------------------------------------------------------------
# The serving plane and the flow-level replay on the card.
# ---------------------------------------------------------------------------


def _serving_batch(n=32, B=4, seed=0):
    from repro_torch.scenarios import make_trace

    return make_trace("moe_phases", n=n, periods=B, seed=seed).normalized()[0]


def test_async_server_on_the_card_equals_sync(cuda):
    """The worker thread solves on the card; sync and async serve the same
    tickets with the same makespans, and both launch ``auction_rounds``."""
    from repro_torch.api import SolveOptions
    from repro_torch.serve import ScheduleServer

    mats = _serving_batch()
    outs = {}
    for mode in ("sync", "async"):
        srv = ScheduleServer(4, 0.01, mode=mode, options=SolveOptions(), max_batch=2,
                             install_latency_s=0.005)
        assert srv.mode == mode and srv.device.type == "cuda"
        before = auction_rounds.launches
        for i, D in enumerate(mats):
            srv.submit(f"t{i % 2}", D)
        res = srv.drain()
        assert auction_rounds.launches > before
        assert all(r.report.validated for r in res.values())
        outs[mode] = sorted((r.ticket, r.makespan, r.num_configs) for r in res.values())
    assert outs["sync"] == outs["async"] and len(outs["sync"]) == len(mats)


def test_flowsim_and_attribution_on_a_card_report(cuda):
    """A card report (backend "torch") passes attribution and the flow replay
    at 1e-4, and equals the plain CPU path's to 1e-4."""
    from repro_torch.api import SolveOptions
    from repro_torch.fabric import simulate
    from repro_torch.obs.timeline_table import attribute_scenario
    from repro_torch.scenarios import run_scenario

    reps = {dev: run_scenario("gpt", solver="spectra_torch", online=True, flowsim=True, simulate=True,
                              options=SolveOptions(extra={"device": dev}), n=16, periods=3)
            for dev in ("cuda", "cpu")}
    card = reps["cuda"]
    att = attribute_scenario(card)
    assert att.tol == 1e-4
    att.check()
    for p, rep, fs in zip(card.periods, card.reports, card.flowsim_reports):
        assert fs.conserved and fs.completed == fs.num_flows
        assert fs.finish_time == pytest.approx(simulate(rep, card.trace.normalized()[0][p.period],
                                                        tol=1e-4).finish_time, abs=1e-4)
    for key in ("fct_p50", "fct_p99", "cct_max", "delta_share"):
        assert card.flowsim_summary()[key] == pytest.approx(reps["cpu"].flowsim_summary()[key], rel=1e-4)
    got, want = card.attribution_summary(), reps["cpu"].attribution_summary()
    for key in ("transmission_share", "delta_share", "idle_share", "online_delta_share"):
        assert got[key] == pytest.approx(want[key], rel=1e-4, abs=1e-7)
    assert card.summary()["warnings"] == 0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_sharded_step_on_a_1x1_mesh_equals_the_unsharded_step(cuda):
    """An in-process NCCL group of one rank: the sharded step of a reduced
    dense model equals the unsharded one (loss 1e-6 relative, gradients 1e-5
    of each tensor's largest entry, parameters 1e-5), and flash_attention
    launches on the local shards through local_map."""
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs.base import ShapeCfg
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.registry import build_model, concrete_inputs
    from repro_torch.parallel.steps import (loss_and_grads, make_model_for_cell, make_optimizer,
                                            make_sharded_train_step, make_train_step, shard_state)

    cfg = get_arch("granite-3-8b").reduced()
    batch = concrete_inputs(cfg, ShapeCfg("t", 64, 4, "train"), device="cuda")
    model = build_model(cfg, device="cuda")
    opt = make_optimizer()
    params = model.init(0)
    p1, _, m1 = make_train_step(model, opt)(params, opt.init(params), batch)
    _, _, g1 = loss_and_grads(model, params, batch)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}", world_size=1, rank=0)
    try:
        mesh = make_debug_mesh(1, model=1)
        assert mesh.device_type == "cuda"
        smodel = make_model_for_cell(cfg, mesh, remat=False, device="cuda")
        ps, os_, bs = shard_state(params, opt.init(params), batch, mesh)
        before = flash_attention.launches
        p2, _, m2 = make_sharded_train_step(smodel, opt, mesh)(ps, os_, bs)
        assert flash_attention.launches - before == cfg.num_layers
        with implicit_replication():
            _, _, g2 = loss_and_grads(smodel, ps, bs)
        assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-6)
        for k in p1:
            g = g2[k].full_tensor()
            assert float((g - g1[k]).abs().max()) <= 1e-5 * float(g1[k].abs().max()), k
            torch.testing.assert_close(p2[k].full_tensor(), p1[k], rtol=0, atol=1e-5)
    finally:
        dist.destroy_process_group()


def test_auction_shim_on_the_card_equals_match_auction(cuda):
    """The legacy shim on a CUDA W reaches auction_rounds (n ≤ 128) and
    masked_row_top2 (above) and gives match_auction's permutation."""
    from repro_torch.core.torchopt.auction import auction_maximize
    from repro_torch.core.torchopt.matching import match_auction

    rng = np.random.default_rng(20)
    for n, counter in ((64, auction_rounds), (160, masked_row_top2)):
        W = torch.from_numpy(_bonus_weights(rng, n)).to(cuda)
        before = counter.launches
        perm, conv = auction_maximize(W)
        assert counter.launches > before and perm.device.type == "cuda" and bool(conv)
        assert torch.equal(perm, match_auction(W[None]).perm[0])
        assert torch.equal(perm.cpu(), auction_maximize(W.cpu())[0])
