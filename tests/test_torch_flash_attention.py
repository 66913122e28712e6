"""The port's attention op against the JAX reference, on the CPU.

The same inputs, made with numpy from a seed, go through the reference's
``mha`` (its Pallas kernel in interpret mode) and ``mha_ref``, and through the
port's ``mha`` on CPU tensors (its plain ``mha_ref``). float32, atol 2e-5:
the two sides sum the scores and the softmax in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention.ops import mha as jax_mha  # noqa: E402
from repro.kernels.flash_attention.ref import mha_ref as jax_mha_ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention, mha, mha_ref  # noqa: E402

CASES = [
    # B, Hq, Hkv, Sq, Sk, D, causal, window
    (2, 4, 2, 64, 64, 32, True, None),    # GQA 2:1, causal
    (1, 8, 2, 16, 128, 64, True, None),   # GQA 4:1, Sq < Sk
    (1, 2, 2, 64, 64, 32, True, 8),       # sliding window
    (1, 4, 4, 48, 48, 64, False, None),   # full (no mask), D = 64
    (1, 3, 1, 24, 48, 32, False, 16),     # MQA, window without causal, Sq < Sk
    (2, 4, 4, 1, 96, 32, True, None),     # one decode query
]


def _qkv(seed, B, Hq, Hkv, Sq, Sk, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hq, Sq, D), dtype=np.float32),
            rng.standard_normal((B, Hkv, Sk, D), dtype=np.float32),
            rng.standard_normal((B, Hkv, Sk, D), dtype=np.float32))


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,causal,window", CASES)
def test_mha_matches_reference(B, Hq, Hkv, Sq, Sk, D, causal, window):
    q, k, v = _qkv(0, B, Hq, Hkv, Sq, Sk, D)
    want = np.asarray(jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, window=window,
                              impl="pallas", interpret=True))
    want_ref = np.asarray(jax_mha_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, window=window))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    before = flash_attention.launches
    got = mha(tq, tk, tv, causal=causal, window=window).numpy()
    assert flash_attention.launches == before  # a CPU tensor takes the plain version
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(mha_ref(tq, tk, tv, causal=causal, window=window).numpy(), want_ref,
                               rtol=2e-5, atol=2e-5)


def test_mha_gradients_match_jax():
    q, k, v = _qkv(4, 1, 4, 2, 16, 16, 32)

    def loss(q_, k_, v_):
        return (jax_mha(q_, k_, v_, causal=True, impl="pallas", interpret=True) ** 2).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    (mha(tq, tk, tv, causal=True) ** 2).sum().backward()
    for g, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


def test_flash_attention_rejects_bad_input():
    q = torch.zeros((1, 3, 8, 32))
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros((1, 2, 8, 32)), torch.zeros((1, 2, 8, 32)))  # 3 % 2 heads
    with pytest.raises(ValueError):
        flash_attention(q, q, q, window=0)
    with pytest.raises(TypeError):
        flash_attention(q, q.double(), q)


def test_rows_without_a_key_are_zero_as_in_reference():
    """Causal with Sq > Sk: the first Sq − Sk query rows see no key. The
    reference's ``mha`` gives 0 there, and so does the port's CPU path, while
    the plain ``mha_ref`` (the reference's ``mha_ref`` alike) gives the mean
    of V; every other row agrees."""
    q, k, v = _qkv(5, 1, 2, 2, 8, 4, 32)
    want = np.asarray(jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                              impl="pallas", interpret=True))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = mha(tq, tk, tv, causal=True).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    assert (got[:, :, :4] == 0).all()
    plain = mha_ref(tq, tk, tv, causal=True).numpy()
    np.testing.assert_allclose(plain[:, :, :4], np.broadcast_to(v.mean(axis=2, keepdims=True), (1, 2, 4, 32)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(plain[:, :, 4:], got[:, :, 4:], rtol=1e-6, atol=1e-6)
