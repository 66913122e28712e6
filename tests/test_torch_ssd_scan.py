"""The port's SSD op against the JAX reference, on the CPU.

Inputs are made with numpy from a seed. The reference runs ``ssd_scan`` with
its Pallas chunk kernel in interpret mode, and ``ssd_ref``; the port runs
``ssd_scan`` on CPU tensors, whose chunk pass is the plain ``ssd_chunk_ref``.
Tolerance rtol/atol 1e-4: the chunked and the sequential sums differ in
order, and the port forms the cross-chunk recurrence in closed form where
the reference runs an associative scan.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.ssd_scan.ops import _chunk_jnp, ssd_decode_step as jax_decode_step  # noqa: E402
from repro.kernels.ssd_scan.ops import _pick_chunk as jax_pick_chunk, ssd_scan as jax_ssd_scan  # noqa: E402
from repro.kernels.ssd_scan.ref import ssd_ref as jax_ssd_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_chunk, ssd_chunk_ref, ssd_decode_step, ssd_ref, ssd_scan  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_chunked  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import BLOCK_CHUNKS, _cross_chunk, _pick_chunk  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(seed, BH, S, P, N, with_h0=False):
    rng = np.random.default_rng(seed)
    xd = rng.standard_normal((BH, S, P), dtype=np.float32)
    loga = (-0.5 * rng.random((BH, S))).astype(np.float32)  # decays exp(loga) in (0.6, 1]
    B = (rng.standard_normal((BH, S, N)) / np.sqrt(N)).astype(np.float32)
    C = (rng.standard_normal((BH, S, N)) / np.sqrt(N)).astype(np.float32)
    h0 = rng.standard_normal((BH, N, P), dtype=np.float32) if with_h0 else None
    return xd, loga, B, C, h0


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("S", [32, 48, 64])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_scan_matches_reference(S, with_h0):
    args = _inputs(S, 3, S, 16, 8, with_h0)
    y_k, h_k = jax_ssd_scan(*map(_j, args), impl="pallas", interpret=True)
    y_r, h_r = jax_ssd_ref(*map(_j, args))
    before = ssd_chunk.launches
    y, hT = ssd_scan(*map(_t, args))
    assert ssd_chunk.launches == before  # a CPU tensor takes the plain version
    for want_y, want_h in ((y_k, h_k), (y_r, h_r)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
        np.testing.assert_allclose(hT.numpy(), np.asarray(want_h), **TOL)
    y_s, h_s = ssd_ref(*map(_t, args))
    np.testing.assert_allclose(y_s.numpy(), np.asarray(y_r), **TOL)
    np.testing.assert_allclose(h_s.numpy(), np.asarray(h_r), **TOL)


@pytest.mark.parametrize("S", [1, 33, 96, 256])
def test_pick_chunk_and_chunk_pass_match_reference(S):
    assert _pick_chunk(S) == jax_pick_chunk(S)
    xd, loga, B, C, _ = _inputs(7, 2, S, 8, 4)
    L = _pick_chunk(S)
    want = _chunk_jnp(jnp.asarray(xd), jnp.asarray(loga), jnp.asarray(B), jnp.asarray(C), L)
    got = ssd_chunk(*map(torch.from_numpy, (xd, loga, B, C)), L)
    assert ssd_chunk_ref(*map(torch.from_numpy, (xd, loga, B, C)), L)[1].shape == (2, S // L, 4, 8)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_decode_step_matches_reference_and_scan():
    xd, loga, B, C, h0 = _inputs(3, 4, 8, 16, 8, with_h0=True)
    h_j, y_j = jax_decode_step(jnp.asarray(h0), jnp.asarray(xd[:, 0]), jnp.asarray(loga[:, 0]),
                               jnp.asarray(B[:, 0]), jnp.asarray(C[:, 0]))
    h, y = ssd_decode_step(*map(torch.from_numpy, (h0, xd[:, 0], loga[:, 0], B[:, 0], C[:, 0])))
    np.testing.assert_allclose(h.numpy(), np.asarray(h_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=1e-6, atol=1e-6)
    # Stepping token by token equals the chunked scan.
    ys, hs = [], torch.from_numpy(h0)
    for t in range(8):
        hs, yt = ssd_decode_step(hs, *(torch.from_numpy(a[:, t]) for a in (xd, loga, B, C)))
        ys.append(yt)
    y_scan, h_scan = ssd_scan(*map(torch.from_numpy, (xd, loga, B, C, h0)))
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(), y_scan.numpy(), **TOL)
    np.testing.assert_allclose(hs.numpy(), h_scan.numpy(), **TOL)


def test_ssd_scan_gradients_match_jax():
    args = _inputs(5, 2, 32, 8, 4, with_h0=True)

    def loss(*a):
        y, hT = jax_ssd_scan(*a, impl="pallas", interpret=True)
        return (y ** 2).sum() + (hT ** 2).sum()

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, args))
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    y, hT = ssd_scan(*ts)
    ((y ** 2).sum() + (hT ** 2).sum()).backward()
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


def test_ssd_chunk_rejects_bad_input():
    xd, loga, B, C, _ = _inputs(0, 1, 32, 8, 4)
    t = list(map(torch.from_numpy, (xd, loga, B, C)))
    with pytest.raises(ValueError):
        ssd_chunk(*t, 24)  # 32 % 24
    with pytest.raises(ValueError):
        ssd_chunk(t[0], t[1][:, :16], t[2], t[3], 16)


def _split(x, on=True):
    """x as two bf16 parts, hi = bf16(x) and lo = bf16(x − hi), in float32."""
    hi = x.to(torch.bfloat16).float()
    return hi, ((x - hi).to(torch.bfloat16).float() if on else torch.zeros_like(x))


def _chunk_split_emulation(xd, loga, B, C, L, split=True):
    """The bf16 tensor-core kernel's arithmetic in plain torch: C Bᵀ from bf16
    operands in float32, decay and mask in float32, then each decayed score
    (and each B scaled by exp(la_L − la)) split into a bf16 high and low part,
    each part's products exact (float64 here, the float32 accumulator on the
    card) and summed."""
    BH, S, P = xd.shape
    N = B.shape[-1]
    nc = S // L
    x = xd.float().reshape(BH, nc, L, P).double()
    la = torch.cumsum(loga.reshape(BH, nc, L), -1)
    Bc, Cc = (t.float().reshape(BH, nc, L, N) for t in (B, C))
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool))
    scores = torch.where(tri, (Cc @ Bc.transpose(-1, -2)) * torch.exp(torch.clamp(la[..., :, None] - la[..., None, :],
                                                                                 max=0.0)), 0.0)
    hi, lo = _split(scores, split)
    y = (hi.double() @ x + lo.double() @ x).float().reshape(BH, S, P)
    hi, lo = _split(Bc * torch.exp(la[..., -1:] - la)[..., None], split)
    states = (hi.double().transpose(-1, -2) @ x + lo.double().transpose(-1, -2) @ x).float()
    return y, states


@pytest.mark.parametrize("L,N,P", [(128, 64, 64), (128, 128, 128), (32, 16, 16)])
def test_bf16_split_emulation_meets_the_kernel_gate(L, N, P):
    """The design of the bf16 ssd_chunk kernel, checked before the card: with
    the scores and the scaled B split into two bf16 parts, y and the states
    stay within rtol/atol 1e-4 of ``ssd_chunk_ref`` on zamba2-like chunks
    (L = 128, N = P = 64, loga as in chip_smoke's ssd phase); rounding them to
    one bf16 part instead would miss that gate."""
    xd, loga, B, C, _ = _inputs(L + N, 4, 2 * L, P, N)
    xd, B, C = (torch.from_numpy(a).to(torch.bfloat16) for a in (xd, B, C))
    loga = torch.from_numpy(loga)
    y_ref, states_ref, _ = ssd_chunk_ref(xd, loga, B, C, L)
    y, states = _chunk_split_emulation(xd, loga, B, C, L)
    torch.testing.assert_close(y, y_ref, **TOL)
    torch.testing.assert_close(states.reshape(states_ref.shape), states_ref, **TOL)
    y1, states1 = _chunk_split_emulation(xd, loga, B, C, L, split=False)
    assert not torch.allclose(y1, y_ref, **TOL) and not torch.allclose(states1.reshape(states_ref.shape),
                                                                        states_ref, **TOL)


# ---------------------------------------------------------------------------
# The cross-chunk recurrence, in blocks of at most BLOCK_CHUNKS chunks.
# ---------------------------------------------------------------------------

def _closed_form_whole(states, la_end, h0):
    """The recurrence's closed form over all nc chunks at once, with
    (BH, nc + 1, nc) decays: the form the blocks replace."""
    BH, nc, N, P = states.shape
    lx = torch.cat([torch.zeros((BH, 1)), torch.cumsum(la_end, dim=-1)], dim=1)
    diff = lx[:, :, None] - lx[:, None, 1:]
    before = torch.tril(torch.ones((nc + 1, nc), dtype=torch.bool), diagonal=-1)
    decay = torch.where(before, torch.exp(torch.clamp(diff, max=0.0)), 0.0)
    H = (decay @ states.reshape(BH, nc, N * P)).reshape(BH, nc + 1, N, P)
    return H + torch.exp(lx)[..., None, None] * h0[:, None]


@pytest.mark.parametrize("nc", [1, 64, 65, 257])
def test_blocked_recurrence_equals_sequential_loop(nc):
    rng = np.random.default_rng(nc)
    BH, N, P = 2, 4, 3
    states = torch.from_numpy(rng.standard_normal((BH, nc, N, P), dtype=np.float32))
    la_end = torch.from_numpy((-0.3 * rng.random((BH, nc))).astype(np.float32))
    h0 = torch.from_numpy(rng.standard_normal((BH, N, P), dtype=np.float32))
    got = _cross_chunk(states, la_end, h0)
    want = [h0]
    for c in range(nc):
        want.append(torch.exp(la_end[:, c])[:, None, None] * want[-1] + states[:, c])
    torch.testing.assert_close(got, torch.stack(want, 1), rtol=1e-5, atol=1e-5)
    whole = _closed_form_whole(states, la_end, h0)
    if nc <= BLOCK_CHUNKS:
        assert torch.equal(got, whole)  # one block: the whole closed form, bit for bit
    torch.testing.assert_close(got, whole, **TOL)


@pytest.mark.parametrize("S", [4097, 130 * 64])
def test_many_chunks_match_whole_closed_form_and_backward(S):
    """S = 4097 runs 4097 chunks of 1 (65 blocks), S = 8320 runs 65 chunks
    of 128: forward and ``ssd_chunked``'s backward equal the whole closed
    form's to 1e-4."""
    import repro_torch.kernels.ssd_scan.ops as ops

    args = _inputs(S, 1, S, 4, 4, with_h0=True)
    gy = np.random.default_rng(1).standard_normal((1, S, 4)).astype(np.float32)
    outs = []
    for cross in (ops._cross_chunk, _closed_form_whole):
        saved, ops._cross_chunk = ops._cross_chunk, cross
        try:
            ts = [torch.from_numpy(a).requires_grad_() for a in args]
            y, hT = ssd_chunked(*ts)
            grads = torch.autograd.grad((y * torch.from_numpy(gy)).sum() + (hT ** 2).sum(), ts)
        finally:
            ops._cross_chunk = saved
        outs.append((y.detach(), hT.detach(), grads))
    (y, hT, g), (y_w, hT_w, g_w) = outs
    torch.testing.assert_close(y, y_w, **TOL)
    torch.testing.assert_close(hT, hT_w, **TOL)
    for a, b in zip(g, g_w):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * float(b.abs().max()))


def test_odd_length_scan_matches_reference():
    """S = 4097 picks chunk 1 on both sides: the port's blocked recurrence
    against the reference's exact sequential scan (its ``impl="reference"``)."""
    args = _inputs(11, 1, 4097, 4, 4, with_h0=True)
    assert _pick_chunk(4097) == jax_pick_chunk(4097) == 1
    y_j, h_j = jax_ssd_scan(*map(_j, args), impl="reference")
    y, hT = ssd_scan(*map(_t, args))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(hT.numpy(), np.asarray(h_j), **TOL)
