"""The port's vlm (qwen2-vl) and audio (whisper) families against the JAX
reference, on the CPU.

Both sides compute with the same weights (the reference's ``LM.init`` tree
loaded through ``interop.params_from_reference``) on the same inputs: the
port's ``concrete_inputs`` draws tokens, ``frames`` and ``patch_embeds``
with numpy from a seed, and the same arrays go to the reference. The
reference runs its Pallas attention in interpret mode (forward, decode) and
differentiates its plain chunked functions; the port runs on
``device="cpu"``, its kernels' plain versions. Tolerances as in
``test_torch_moe.py``: logits rtol 1e-4, decode 2e-3, gradients 1e-4 of each
tensor's largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import ARCHS as JAX_ARCHS  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro.serve.engine import DecodeEngine as JaxDecodeEngine  # noqa: E402
from repro_torch.configs.base import ShapeCfg  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.interop import params_from_reference, params_to_reference  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.models import build_model, concrete_inputs  # noqa: E402
from repro_torch.serve import DecodeEngine  # noqa: E402

ARCHS_HERE = ["qwen2-vl-2b", "whisper-tiny"]
S = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(arch, attn_impl="pallas"):
    cfg = ARCHS[arch].reduced()
    jmodel = JaxLM(JAX_ARCHS[arch].reduced(), attn_impl=attn_impl, ssd_impl="chunked")
    jparams = _np(jmodel.init(jax.random.PRNGKey(0)))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_reference(cfg, jparams))
    return cfg, model, jmodel, jparams


def _jbatch(batch):
    return {k: jnp.asarray(v.numpy()) for k, v in batch.items()}


def grid_positions(B, S_, side):
    """Qwen2-VL's M-RoPE positions for a side × side patch grid at the start
    of the sequence, then text: a patch at (row, col) takes (0, row, col),
    text token i after the grid takes side + i in all three streams."""
    p = np.arange(S_)
    n = side * side
    t = np.where(p < n, 0, p - n + side)
    h = np.where(p < n, p // side, t)
    w = np.where(p < n, p % side, t)
    return np.broadcast_to(np.stack([t, h, w], -1), (B, S_, 3)).astype(np.int64)


def test_concrete_inputs_match_reference_specs():
    for arch in ARCHS_HERE:
        cfg = ARCHS[arch].reduced()
        batch = concrete_inputs(cfg, ShapeCfg("t", S, 2, "prefill"), seed=1, device="cpu")
        np.testing.assert_array_equal(batch["tokens"].numpy(),
                                      np.random.default_rng(1).integers(0, cfg.vocab_size, (2, S)))
        if cfg.family == "audio":
            assert set(batch) == {"tokens", "frames"} and batch["frames"].shape == (2, 16, cfg.d_model)
        else:
            assert set(batch) == {"tokens", "patch_embeds", "positions"}
            assert batch["patch_embeds"].shape == (2, S, cfg.d_model) and batch["positions"].shape == (2, S, 3)
            np.testing.assert_array_equal(batch["positions"][..., 2].numpy(), np.tile(np.arange(S), (2, 1)))
        assert set(concrete_inputs(cfg, ShapeCfg("d", S, 2, "decode"), device="cpu")) == {"tokens"}


@pytest.mark.parametrize("arch,positions", [("qwen2-vl-2b", "arange"), ("qwen2-vl-2b", "grid"),
                                            ("whisper-tiny", "arange")])
def test_forward_matches_reference(arch, positions):
    cfg, model, jmodel, jparams = _pair(arch)
    batch = concrete_inputs(cfg, ShapeCfg("t", S, 2, "prefill"), seed=1, device="cpu")
    if positions == "grid":
        batch["patch_embeds"] = batch["patch_embeds"][:, :16]  # a 4 × 4 grid, then text
        batch["positions"] = torch.from_numpy(grid_positions(2, S, 4))
    want = np.asarray(jmodel.apply(jax.tree.map(jnp.asarray, jparams), _jbatch(batch))["logits"])
    before = flash_attention.launches
    with torch.no_grad():
        out = model.apply(batch)
    assert flash_attention.launches == before  # plain versions on the CPU
    assert set(out) == {"logits"}
    np.testing.assert_allclose(out["logits"].numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_patch_embeds_and_positions_change_the_output():
    """The vlm inputs reach the model: other patch embeddings change the
    first positions' logits, other M-RoPE streams change the rest."""
    cfg, model, _, _ = _pair("qwen2-vl-2b")
    batch = concrete_inputs(cfg, ShapeCfg("t", S, 1, "prefill"), seed=1, device="cpu")
    with torch.no_grad():
        base = model.apply(batch)["logits"]
        text = model.apply({"tokens": batch["tokens"]})["logits"]
        grid = model.apply({**batch, "positions": torch.from_numpy(grid_positions(1, S, 4))})["logits"]
    assert not torch.allclose(base, text) and not torch.allclose(base[:, 1:], grid[:, 1:])


def test_vlm_decode_matches_reference_on_text():
    """Decode replays a text-only batch (no patch embeddings), as the
    reference's decode test does, against the reference's ``decode_step``
    and the port's forward."""
    cfg, model, jmodel, jparams = _pair("qwen2-vl-2b")
    tokens = concrete_inputs(cfg, ShapeCfg("t", 24, 2, "prefill"), seed=2, device="cpu")["tokens"]
    jp = jax.tree.map(jnp.asarray, jparams)
    jstep = jax.jit(jmodel.decode_step)
    jcache, cache = jmodel.init_cache(jp, 2, 24), model.init_cache(2, 24)
    got, want = [], []
    with torch.no_grad():
        for t in range(24):
            lj, jcache = jstep(jp, jcache, jnp.asarray(tokens[:, t:t + 1].numpy()))
            lg, cache = model.decode_step(cache, tokens[:, t:t + 1])
            want.append(np.asarray(lj[:, 0]))
            got.append(lg[:, 0].numpy())
        full = model.apply({"tokens": tokens})["logits"].numpy()
    got = np.stack(got, 1)
    np.testing.assert_allclose(got, np.stack(want, 1), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got, full, rtol=2e-3, atol=2e-3)


def test_whisper_decode_with_enc_out_matches_reference():
    """The encoder's output, the same on both sides to 1e-4, feeds the
    decode caches; decode replays the forward and the reference's decode."""
    cfg, model, jmodel, jparams = _pair("whisper-tiny")
    batch = concrete_inputs(cfg, ShapeCfg("t", 24, 2, "prefill"), seed=2, device="cpu")
    jp = jax.tree.map(jnp.asarray, jparams)
    j_enc = jmodel.encode(jp, jnp.asarray(batch["frames"].numpy()))
    with torch.no_grad():
        enc = model.encode(batch["frames"])
    np.testing.assert_allclose(enc.numpy(), np.asarray(j_enc), rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError):
        model.init_cache(2, 24)
    jstep = jax.jit(jmodel.decode_step)
    jcache, cache = jmodel.init_cache(jp, 2, 24, enc_out=j_enc), model.init_cache(2, 24, enc_out=enc)
    tokens = batch["tokens"]
    got, want = [], []
    with torch.no_grad():
        for t in range(24):
            lj, jcache = jstep(jp, jcache, jnp.asarray(tokens[:, t:t + 1].numpy()))
            lg, cache = model.decode_step(cache, tokens[:, t:t + 1])
            want.append(np.asarray(lj[:, 0]))
            got.append(lg[:, 0].numpy())
        full = model.apply(batch)["logits"].numpy()
    assert cache["enc_out"] is enc or torch.equal(cache["enc_out"], enc)
    got = np.stack(got, 1)
    np.testing.assert_allclose(got, np.stack(want, 1), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got, full, rtol=2e-3, atol=2e-3)


def test_whisper_decode_engine_greedy_tokens_match_reference():
    cfg, model, jmodel, jparams = _pair("whisper-tiny")
    frames = concrete_inputs(cfg, ShapeCfg("t", 24, 2, "prefill"), seed=3, device="cpu")["frames"]
    jp = jax.tree.map(jnp.asarray, jparams)
    prompts = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    want = JaxDecodeEngine(jmodel, jp, max_len=24).generate(
        prompts, 10, enc_out=jmodel.encode(jp, jnp.asarray(frames.numpy()))).tokens
    with torch.no_grad():
        enc = model.encode(frames)
    np.testing.assert_array_equal(DecodeEngine(model, max_len=24).generate(prompts, 10, enc_out=enc).tokens, want)


@pytest.mark.parametrize("arch", ARCHS_HERE)
def test_loss_and_gradients_match_reference(arch):
    cfg, model, jmodel, jparams = _pair(arch, attn_impl="chunked")
    batch = concrete_inputs(cfg, ShapeCfg("t", S, 2, "train"), seed=5, device="cpu")
    (want_loss, _), want_g = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, _jbatch(batch)), has_aux=True))(jax.tree.map(jnp.asarray, jparams))
    params = {k: v.requires_grad_() for k, v in params_from_reference(cfg, jparams).items()}
    with model.bound(params):
        loss, metrics = model.loss(batch)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    loss = loss.detach()
    assert set(metrics) == {"ce"}
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
    for k, w in params_from_reference(cfg, _np(want_g)).items():
        w = w.numpy()
        np.testing.assert_allclose(grads[k].numpy(), w, rtol=0, atol=1e-4 * max(np.abs(w).max(), 1e-30), err_msg=k)


def test_whisper_remat_gives_the_same_gradients():
    """``remat`` checkpoints each decoder layer: the same loss and gradients,
    bit for bit on the CPU."""
    cfg, model, _, jparams = _pair("whisper-tiny")
    batch = concrete_inputs(cfg, ShapeCfg("t", S, 2, "train"), seed=6, device="cpu")
    out = []
    for remat in (False, True):
        model.remat = remat
        params = {k: v.requires_grad_() for k, v in params_from_reference(cfg, jparams).items()}
        with model.bound(params):
            loss, _ = model.loss(batch)
            out.append((loss, torch.autograd.grad(loss, list(params.values()))))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


@pytest.mark.parametrize("arch", ARCHS_HERE)
def test_params_round_trip(arch):
    cfg, model, _, jparams = _pair(arch)
    tree = params_to_reference(cfg, model.state_dict())
    assert jax.tree.structure(tree) == jax.tree.structure(jparams)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a, b)
