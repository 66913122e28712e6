"""The port's MoE family against the JAX reference, on the CPU.

Both sides compute with the same weights: the reference's ``LM.init`` tree
(or ``moe_init`` dict), taken out as numpy arrays, loads into the port
through ``interop.params_from_reference``. Inputs are made with numpy from
a seed. The reference runs its Pallas attention in interpret mode for the
forward and decode, and differentiates its plain chunked functions, as its
training launcher builds it; the port runs on ``device="cpu"``, where its
kernels take their plain versions.

Tolerances: logits rtol 1e-4 (float32, sums in other orders), the aux loss
to 1e-5, ``expert_load`` exactly (integer counts of the same choices);
decode against the reference's ``decode_step`` to 2e-3, as the reference's
own decode test holds decode against its forward; loss and gradients to
1e-4 of each tensor's largest entry.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import ARCHS as JAX_ARCHS  # noqa: E402
from repro.data.pipeline import make_stream as jax_make_stream  # noqa: E402
from repro.fabric.ocs import OCSFabric as JaxOCSFabric  # noqa: E402
from repro.models.blocks import moe_apply as jax_moe_apply  # noqa: E402
from repro.models.blocks import moe_ffn as jax_moe_ffn  # noqa: E402
from repro.models.blocks import moe_init as jax_moe_init  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro.parallel.steps import make_train_step as jax_make_train_step  # noqa: E402
from repro.serve.engine import DecodeEngine as JaxDecodeEngine  # noqa: E402
from repro.train.loop import LoopConfig as JaxLoopConfig  # noqa: E402
from repro.train.loop import Trainer as JaxTrainer  # noqa: E402
from repro.train.optimizer import AdamW as JaxAdamW  # noqa: E402
from repro.train.optimizer import cosine_schedule as jax_cosine  # noqa: E402
from repro_torch.configs.base import ShapeCfg  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.data import make_stream  # noqa: E402
from repro_torch.fabric import OCSFabric  # noqa: E402
from repro_torch.interop import (  # noqa: E402
    opt_state_from_reference,
    opt_state_to_reference,
    params_from_reference,
    params_to_reference,
)
from repro_torch.models import build_model, concrete_inputs  # noqa: E402
from repro_torch.models.blocks import MoE, expert_capacity, moe_ffn, top_k_stable  # noqa: E402
from repro_torch.parallel.steps import make_train_step  # noqa: E402
from repro_torch.serve import DecodeEngine  # noqa: E402
from repro_torch.train.loop import LoopConfig, Trainer, _demand_from_stats  # noqa: E402
from repro_torch.train.optimizer import AdamW, cosine_schedule  # noqa: E402

MOE_ARCHS = ["qwen3-moe-30b-a3b", "deepseek-moe-16b"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread does not oversubscribe the cores
    the parallel test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _configs(arch, full_capacity=False):
    """(port config, reference config), reduced; ``full_capacity`` sets
    capacity_factor = E/K, so no token is dropped at any group size."""
    cfg, jcfg = ARCHS[arch].reduced(), JAX_ARCHS[arch].reduced()
    if full_capacity:
        cf = cfg.moe.num_experts / cfg.moe.top_k
        cfg = replace(cfg, moe=replace(cfg.moe, capacity_factor=cf))
        jcfg = replace(jcfg, moe=replace(jcfg.moe, capacity_factor=cf))
    return cfg, jcfg


def _pair(arch, full_capacity=False, attn_impl="pallas"):
    """(port config, port model, reference model, reference params as numpy)
    with equal weights."""
    cfg, jcfg = _configs(arch, full_capacity)
    jmodel = JaxLM(jcfg, attn_impl=attn_impl, ssd_impl="chunked")
    jparams = _np(jmodel.init(jax.random.PRNGKey(0)))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_reference(cfg, jparams))
    return cfg, model, jmodel, jparams


def _moe_block(cfg, p):
    """The port's ``MoE`` module holding the reference's ``moe_init`` dict."""
    block = MoE(cfg, torch.Generator().manual_seed(0))
    block.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in p.items()})
    return block


# ---------------------------------------------------------------------------
# The forward: S = 32 ≥ 4·E dispatches per batch row, S = 16 in one group.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [32, 16])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_matches_reference(arch, S):
    cfg, model, jmodel, jparams = _pair(arch)
    assert (S >= 4 * cfg.moe.num_experts) == (S == 32)
    batch = concrete_inputs(cfg, ShapeCfg("t", S, 2, "prefill"), seed=1, device="cpu")
    want = jmodel.apply(jax.tree.map(jnp.asarray, jparams), {"tokens": jnp.asarray(batch["tokens"].numpy())})
    with torch.no_grad():
        got = model.apply(batch)
    w = np.asarray(want["logits"])
    np.testing.assert_allclose(got["logits"].numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max())
    assert float(got["aux_loss"]) == pytest.approx(float(want["aux_loss"]), abs=1e-5)
    np.testing.assert_array_equal(got["expert_load"].numpy(), np.asarray(want["expert_load"]))
    assert float(got["expert_load"].sum()) == 2 * S * cfg.moe.top_k * cfg.num_layers


# ---------------------------------------------------------------------------
# The block alone.
# ---------------------------------------------------------------------------

def test_top_k_ties_take_the_lower_index_first():
    probs = np.random.default_rng(0).integers(0, 3, (64, 16)).astype(np.float32)  # many ties
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs), 5)
    got_v, got_i = top_k_stable(torch.from_numpy(probs), 5)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("router", ["ties", "one expert"])
def test_moe_ffn_matches_reference(router):
    """Tie-rich router logits (small integers: x and the router in {−1, 0, 1})
    must route to the reference's experts; a router forced onto one expert
    overflows its capacity and must drop the same tokens."""
    cfg, _ = _configs("qwen3-moe-30b-a3b")
    m = cfg.moe
    T, D = 24, cfg.d_model
    rng = np.random.default_rng(3)
    p = _np(jax_moe_init(jax.random.PRNGKey(1), JAX_ARCHS["qwen3-moe-30b-a3b"].reduced()))
    if router == "ties":
        x = rng.integers(-1, 2, (T, D)).astype(np.float32)
        p["router"] = rng.integers(-1, 2, (D, m.num_experts)).astype(np.float32)
    else:
        x = rng.standard_normal((T, D), dtype=np.float32)
        p["router"] = np.zeros((D, m.num_experts), np.float32)
        p["router"][0, 3] = 1.0
        x[:, 0] = np.abs(x[:, 0]) + 5.0  # logit 3 is x[:, 0] ≥ 5, the others 0
    y_j, stats_j = jax_moe_ffn(jax.tree.map(jnp.asarray, p), jnp.asarray(x), JAX_ARCHS["qwen3-moe-30b-a3b"].reduced().moe)
    y, stats = moe_ffn(_moe_block(cfg, p), torch.from_numpy(x)[None], m)
    np.testing.assert_allclose(y[0].numpy(), np.asarray(y_j), rtol=1e-5, atol=1e-5 * np.abs(np.asarray(y_j)).max())
    np.testing.assert_array_equal(stats["expert_load"].numpy(), np.asarray(stats_j["expert_load"]))
    assert float(stats["aux_loss"]) == pytest.approx(float(stats_j["aux_loss"]), rel=1e-6)
    if router == "one expert":
        # Every token's first choice is expert 3 and, the other logits tied
        # at 0, its second expert 0: both queues take the first C tokens.
        C = expert_capacity(T, m)
        load = stats["expert_load"].numpy()
        assert load[3] == load[0] == T > C and load.sum() == 2 * T
        served = (np.abs(y[0].numpy()) > 0).any(-1)
        assert served[:C].all() and not served[C:].any()


@pytest.mark.parametrize("S", [32, 16])
@pytest.mark.parametrize("shared", [0, 1])
def test_moe_block_matches_reference(shared, S):
    """``MoE.forward`` against ``moe_apply``: the norm, the per-row (S = 32)
    or global (S = 16) grouping, and the shared experts when present."""
    base = JAX_ARCHS["deepseek-moe-16b"].reduced()
    jcfg = replace(base, moe=replace(base.moe, num_shared=shared))
    cfg = replace(ARCHS["deepseek-moe-16b"].reduced(), moe=replace(ARCHS["deepseek-moe-16b"].reduced().moe,
                                                                     num_shared=shared))
    p = _np(jax_moe_init(jax.random.PRNGKey(2), jcfg))
    assert ("ws_gate" in p) == bool(shared)
    x = np.random.default_rng(S).standard_normal((2, S, cfg.d_model), dtype=np.float32)
    y_j, stats_j = jax_moe_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x), cfg=jcfg)
    y, stats = _moe_block(cfg, p)(torch.from_numpy(x))
    w = np.asarray(y_j)
    np.testing.assert_allclose(y.detach().numpy(), w, rtol=1e-5, atol=1e-5 * np.abs(w).max())
    np.testing.assert_array_equal(stats["expert_load"].numpy(), np.asarray(stats_j["expert_load"]))
    assert float(stats["aux_loss"]) == pytest.approx(float(stats_j["aux_loss"]), rel=1e-6)


# ---------------------------------------------------------------------------
# Decode, at capacity_factor = E/K (the reference's decode test sets it).
# ---------------------------------------------------------------------------

def test_decode_matches_reference_decode_and_forward():
    cfg, model, jmodel, jparams = _pair("qwen3-moe-30b-a3b", full_capacity=True)
    S = 24
    tokens = concrete_inputs(cfg, ShapeCfg("t", S, 2, "prefill"), seed=2, device="cpu")["tokens"]
    jp = jax.tree.map(jnp.asarray, jparams)
    jstep = jax.jit(jmodel.decode_step)
    jcache = jmodel.init_cache(jp, 2, S)
    cache = model.init_cache(2, S)
    want, got = [], []
    with torch.no_grad():
        for t in range(S):
            lj, jcache = jstep(jp, jcache, jnp.asarray(tokens[:, t:t + 1].numpy()))
            lg, cache = model.decode_step(cache, tokens[:, t:t + 1])
            want.append(np.asarray(lj[:, 0]))
            got.append(lg[:, 0].numpy())
        full = model.apply({"tokens": tokens})["logits"].numpy()
    got, want = np.stack(got, 1), np.stack(want, 1)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got, full, rtol=2e-3, atol=2e-3)


def test_decode_engine_greedy_tokens_match_reference():
    cfg, model, jmodel, jparams = _pair("qwen3-moe-30b-a3b", full_capacity=True)
    prompts = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    want = JaxDecodeEngine(jmodel, jax.tree.map(jnp.asarray, jparams), max_len=24).generate(prompts, 10).tokens
    np.testing.assert_array_equal(DecodeEngine(model, max_len=24).generate(prompts, 10).tokens, want)


# ---------------------------------------------------------------------------
# Training.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_loss_and_gradients_match_reference(arch):
    cfg, model, jmodel, jparams = _pair(arch, attn_impl="chunked")
    tokens = jax_make_stream(cfg.vocab_size, 48, 2).next_batch(0)["tokens"]
    (want_loss, want_m), want_g = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, {"tokens": tokens}), has_aux=True))(jax.tree.map(jnp.asarray, jparams))
    params = {k: v.requires_grad_() for k, v in params_from_reference(cfg, jparams).items()}
    with model.bound(params):
        loss, metrics = model.loss({"tokens": torch.from_numpy(np.array(tokens))})
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    loss, metrics = loss.detach(), {k: v.detach() for k, v in metrics.items()}
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
    assert float(metrics["ce"]) == pytest.approx(float(want_m["ce"]), rel=1e-5)
    assert float(loss - metrics["ce"]) == pytest.approx(float(want_loss - want_m["ce"]), abs=1e-5)  # the aux loss
    np.testing.assert_array_equal(metrics["expert_load"].numpy(), np.asarray(want_m["expert_load"]))
    want = params_from_reference(cfg, _np(want_g))
    assert set(grads) == set(want)
    for k, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(grads[k].numpy(), w, rtol=0, atol=1e-4 * max(np.abs(w).max(), 1e-30), err_msg=k)


def test_remat_gives_the_same_gradients_and_stats():
    """``remat`` checkpoints each period: the same loss, gradients and
    ``expert_load``, bit for bit on the CPU."""
    cfg, model, _, jparams = _pair("deepseek-moe-16b")
    batch = {"tokens": torch.from_numpy(np.array(jax_make_stream(cfg.vocab_size, 48, 2).next_batch(0)["tokens"]))}
    out = []
    for remat in (False, True):
        model.remat = remat
        params = {k: v.requires_grad_() for k, v in params_from_reference(cfg, jparams).items()}
        with model.bound(params):
            loss, metrics = model.loss(batch)
            out.append((loss, metrics["expert_load"], torch.autograd.grad(loss, list(params.values()))))
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])
    assert all(torch.equal(a, b) for a, b in zip(out[0][2], out[1][2]))


def test_tick_reads_a_tensor_load_once():
    """The tick takes ``expert_load`` as the train step leaves it, a tensor
    (on the card in a real run), and builds the reference's matrix."""
    load = np.random.default_rng(0).integers(0, 50, 16).astype(np.float32)
    D = _demand_from_stats(8, {"expert_load": torch.from_numpy(load)}, 0)
    np.testing.assert_array_equal(D, _demand_from_stats(8, {"expert_load": load}, 0))
    assert D.shape == (8, 8) and np.all(np.diag(D) == 0)


def test_trainer_tick_logs_reference_ccts_on_the_same_loads():
    """The reference's ``test_ocs_controller_logs_cct_moe`` setup (reduced
    qwen3-moe, B = 4 × S = 32, 8 steps, the tick every 4 on 4 switches, 8
    racks), run by both trainers from the same weights on the same tokens:
    every step's ``expert_load`` is equal, and so is every tick's log."""
    cfg, model, jmodel, jparams = _pair("qwen3-moe-30b-a3b", attn_impl="chunked")
    loads = {"ref": [], "port": []}

    def recorded(step, side):
        def run(*args):
            out = step(*args)
            loads[side].append(np.asarray(out[2]["expert_load"]))
            return out
        return run

    jopt = JaxAdamW(schedule=jax_cosine(3e-3, 8), weight_decay=0.0)
    jcfg = JaxLoopConfig(total_steps=8, log_every=4, ocs_every=4, ocs_num_racks=8)
    jtr = JaxTrainer(jmodel, jopt, jax_make_stream(cfg.vocab_size, seq_len=32, global_batch=4),
                     recorded(jax.jit(jax_make_train_step(jmodel, jopt)), "ref"), jcfg,
                     fabric=JaxOCSFabric(num_switches=4, reconfig_delay_s=20e-6))
    want = jtr.run(jax.random.PRNGKey(0))

    opt = AdamW(schedule=cosine_schedule(3e-3, 8), weight_decay=0.0)
    model.init = lambda seed: params_from_reference(cfg, jparams)  # the reference's initial weights
    tr = Trainer(model, opt, make_stream(cfg.vocab_size, 32, 4, device="cpu"),
                 recorded(make_train_step(model, opt), "port"),
                 LoopConfig(total_steps=8, log_every=4, ocs_every=4, ocs_num_racks=8),
                 fabric=OCSFabric(num_switches=4, reconfig_delay_s=20e-6), device="cpu")
    got = tr.run(0)
    assert len(loads["port"]) == len(loads["ref"]) == 8
    for a, b in zip(loads["port"], loads["ref"]):
        np.testing.assert_array_equal(a, b)
        assert a.sum() == 4 * 32 * cfg.moe.top_k * cfg.num_layers
    assert len(got.cct_log) == len(want.cct_log) == 2
    for g, w in zip(got.cct_log, want.cct_log):
        assert g == w
        assert g["cct_s"] > 0 and g["makespan"] >= g["lb"] - 1e-9


# ---------------------------------------------------------------------------
# interop.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_params_round_trip(arch):
    cfg, model, _, jparams = _pair(arch)
    tree = params_to_reference(cfg, model.state_dict())
    assert jax.tree.structure(tree) == jax.tree.structure(jparams)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a, b)
    assert set(params_from_reference(cfg, tree)) == set(model.state_dict())
    state = {"mu": jparams, "nu": jax.tree.map(lambda a: a * 2, jparams), "step": np.int32(3)}
    back = opt_state_to_reference(cfg, opt_state_from_reference(cfg, state))
    assert back["step"] == 3
    for name in ("mu", "nu"):
        for a, b in zip(jax.tree.leaves(back[name]), jax.tree.leaves(state[name])):
            np.testing.assert_array_equal(a, b)
