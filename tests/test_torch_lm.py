"""The port's LM inference path against the JAX reference, on the CPU.

Both sides compute with the same weights: the reference's ``LM.init`` tree,
taken out as numpy arrays, loads into the port through
``interop.params_from_reference``. Tokens are made with numpy from a seed.
The reference runs its Pallas kernels in interpret mode; the port runs on
``device="cpu"``, so its kernels take their plain versions. Forward logits
agree to rtol 1e-4 (float32; sums in other orders), decode replays the
forward to 2e-3 as the reference's own decode test holds it.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import ARCHS as JAX_ARCHS  # noqa: E402
from repro.models.registry import build_model as jax_build_model  # noqa: E402
from repro.serve.engine import DecodeEngine as JaxDecodeEngine  # noqa: E402
from repro_torch.configs.base import ShapeCfg  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.interop import params_from_reference, params_to_reference  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_chunk  # noqa: E402
from repro_torch.models import build_model, concrete_inputs  # noqa: E402
from repro_torch.serve import DecodeEngine  # noqa: E402

FORWARD_ARCHS = ["zamba2-1.2b", "mamba2-2.7b", "granite-3-8b", "gemma3-27b"]
S = 32


def _pair(arch, seed=0):
    """(port config, port model, reference model, reference params) with equal weights."""
    cfg = ARCHS[arch].reduced()
    jmodel = jax_build_model(JAX_ARCHS[arch].reduced())
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_reference(cfg, jax.tree.map(np.asarray, jparams)))
    return cfg, model, jmodel, jparams


@pytest.fixture(scope="module")
def zamba2():
    return _pair("zamba2-1.2b")


def test_reduced_configs_equal_reference():
    for name, cfg in ARCHS.items():
        assert repr(cfg.reduced()) == repr(JAX_ARCHS[name].reduced())
        assert repr(cfg) == repr(JAX_ARCHS[name])


@pytest.mark.parametrize("arch", FORWARD_ARCHS)
def test_forward_logits_match_reference(arch):
    cfg, model, jmodel, jparams = _pair(arch)
    if cfg.window:
        assert S > cfg.window  # the local layers' window really cuts
    batch = concrete_inputs(cfg, ShapeCfg("t", S, 2, "prefill"), seed=1, device="cpu")
    want = np.asarray(jmodel.apply(jparams, {"tokens": jnp.asarray(batch["tokens"].numpy(), jnp.int32)})["logits"])
    counts = (flash_attention.launches, ssd_chunk.launches)
    with torch.no_grad():
        got = model.apply(batch)["logits"].numpy()
    assert (flash_attention.launches, ssd_chunk.launches) == counts  # plain versions on the CPU
    assert got.shape == (2, S, cfg.vocab_size) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_params_round_trip(zamba2):
    cfg, model, _, jparams = zamba2
    tree = params_to_reference(cfg, model.state_dict())
    assert jax.tree.structure(tree) == jax.tree.structure(jax.tree.map(np.asarray, jparams))
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_bf16_params_keep_their_type():
    cfg = replace(ARCHS["zamba2-1.2b"].reduced(), dtype="bfloat16")
    jparams = jax_build_model(replace(JAX_ARCHS["zamba2-1.2b"].reduced(), dtype="bfloat16")).init(jax.random.PRNGKey(0))
    sd = params_from_reference(cfg, jax.tree.map(np.asarray, jparams))
    assert {t.dtype for t in sd.values()} == {torch.bfloat16}
    model = build_model(cfg, device="cpu")
    model.load_state_dict(sd)
    np.testing.assert_array_equal(model.embed.float().numpy(), np.asarray(jparams["embed"], np.float32))


def test_decode_teacher_forcing_matches_forward(zamba2):
    cfg, model, _, _ = zamba2
    tokens = concrete_inputs(cfg, ShapeCfg("t", 24, 2, "prefill"), seed=2, device="cpu")["tokens"]
    with torch.no_grad():
        full = model.apply({"tokens": tokens})["logits"]
        cache = model.init_cache(2, 24)
        got = []
        for t in range(24):
            logits, cache = model.decode_step(cache, tokens[:, t:t + 1])
            got.append(logits[:, 0])
    np.testing.assert_allclose(torch.stack(got, 1).numpy(), full.numpy(), rtol=2e-3, atol=2e-3)


def test_gemma3_ring_buffer_decode_matches_forward():
    cfg, model, _, _ = _pair("gemma3-27b")
    cache = model.init_cache(1, S)
    assert cache["periods"][0][0]["k"].shape[2] == cfg.window < S  # local layers: window-sized ring
    assert cache["periods"][0][-1]["k"].shape[2] == S
    tokens = concrete_inputs(cfg, ShapeCfg("t", S, 1, "prefill"), seed=3, device="cpu")["tokens"]
    with torch.no_grad():
        full = model.apply({"tokens": tokens})["logits"]
        got = []
        for t in range(S):
            logits, cache = model.decode_step(cache, tokens[:, t:t + 1])
            got.append(logits[:, 0])
    np.testing.assert_allclose(torch.stack(got, 1).numpy(), full.numpy(), rtol=2e-3, atol=2e-3)


def test_decode_engine_greedy_tokens_match_reference(zamba2):
    cfg, model, jmodel, jparams = zamba2
    prompts = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    want = JaxDecodeEngine(jmodel, jparams, max_len=24).generate(prompts, 10).tokens
    res = DecodeEngine(model, max_len=24).generate(prompts, 10, keep_logits=True)
    np.testing.assert_array_equal(res.tokens, want)
    assert res.prompt_len == 8 and res.steps == 18 and res.logits.shape == (2, 17, cfg.vocab_size)
    with pytest.raises(ValueError):
        DecodeEngine(model, max_len=16).generate(prompts, 10)


def test_sampling_is_seeded(zamba2):
    cfg, model, _, _ = zamba2
    eng = DecodeEngine(model, max_len=16)
    prompts = np.full((2, 4), 11, np.int32)
    a, b = (eng.generate(prompts, 6, temperature=1.0, seed=s).tokens for s in (5, 5))
    np.testing.assert_array_equal(a, b)
    assert ((a >= 0) & (a < cfg.vocab_size)).all()


def test_concrete_inputs_come_from_the_numpy_seed():
    cfg = ARCHS["granite-3-8b"].reduced()
    tokens = concrete_inputs(cfg, ShapeCfg("t", 16, 3, "prefill"), seed=9, device="cpu")["tokens"]
    np.testing.assert_array_equal(tokens.numpy(), np.random.default_rng(9).integers(0, cfg.vocab_size, (3, 16)))
