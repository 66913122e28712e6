"""State carried across from the reference's numpy arrays.

``params_from_reference`` turns the reference's ``LM.init`` parameter tree
into the port's ``state_dict`` (and ``params_to_reference`` back), so both
models compute with the same weights; ``opt_state_from_reference`` and
``opt_state_to_reference`` do the same for the AdamW state (``mu``, ``nu``,
``step``), so both sides can start a step from one ``(params, opt_state)``.

``from_reference`` turns the arrays of a reference ``JaxDecomposition``,
``DeviceSchedule`` or ``E2EResult`` (taken out with ``np.asarray``) into the
port's tensor twins, so one stage of the port can start from the
reference's output of the stage before it. It imports nothing of the
reference: the caller passes plain arrays, each with a leading batch
dimension, keyed by field name. An ``E2EResult`` is passed flat, its nested
fields keyed as ``"schedule.<field>"`` and ``"dec.<field>"``.
"""

from __future__ import annotations

import numpy as np
import torch

from .configs.base import ModelConfig
from .core.schedule_ir import DeviceSchedule
from .core.torchopt.decompose_torch import TorchDecomposition
from .core.torchopt.e2e import E2EResult
from .models.lm import PORTED_FAMILIES, hybrid_layout, layer_pattern

_SCHEDULE = {"perms", "alphas", "switch", "delta"}
_DECOMPOSITION = {"perms", "alphas", "k", "converged"}
_E2E = {"makespan", "lpt_makespan", "eq_exhausted", "lb"}


def _t(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a), device=device).to(dtype)  # own copy


def _nested(arrays: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix)}


def from_reference(arrays: dict[str, np.ndarray], device) -> DeviceSchedule | TorchDecomposition | E2EResult:
    """The port's twin of a reference result given as numpy arrays.

    The kind is read from the keys: ``perms, alphas, switch, delta`` make a
    ``DeviceSchedule``; ``perms, alphas, k, converged`` a
    ``TorchDecomposition`` (its ``rounds`` is 0: the reference does not
    export it); ``makespan, lpt_makespan, eq_exhausted, lb`` plus nested
    ``schedule.*`` and ``dec.*`` keys an ``E2EResult``.
    """
    keys = set(arrays)
    if _E2E <= keys:
        return E2EResult(
            schedule=from_reference(_nested(arrays, "schedule."), device),
            dec=from_reference(_nested(arrays, "dec."), device),
            makespan=_t(arrays["makespan"], torch.float32, device),
            lpt_makespan=_t(arrays["lpt_makespan"], torch.float32, device),
            eq_exhausted=_t(arrays["eq_exhausted"], torch.bool, device),
            lb=_t(arrays["lb"], torch.float32, device),
        )
    if _SCHEDULE <= keys:
        return DeviceSchedule(
            perms=_t(arrays["perms"], torch.int64, device),
            alphas=_t(arrays["alphas"], torch.float32, device),
            switch=_t(arrays["switch"], torch.int64, device),
            delta=_t(arrays["delta"], torch.float32, device),
        )
    if _DECOMPOSITION <= keys:
        k = _t(arrays["k"], torch.int64, device)
        return TorchDecomposition(
            perms=_t(arrays["perms"], torch.int64, device),
            alphas=_t(arrays["alphas"], torch.float32, device),
            k=k,
            converged=_t(arrays["converged"], torch.bool, device),
            rounds=torch.zeros_like(k),
        )
    raise ValueError(f"cannot tell which reference result has keys {sorted(keys)}")


# ---------------------------------------------------------------------------
# LM parameters.
# ---------------------------------------------------------------------------

_TOP = ("embed", "final_norm", "lm_head", "enc_norm")


def _sublayers(cfg: ModelConfig) -> tuple[tuple[str, str], ...]:
    """A dense/moe/vlm layer's (port key part, reference key) pairs: the port's
    dense and vlm layer is the attention block itself, its moe layer a
    ``ModuleDict`` of ``attn`` and ``moe``; the reference nests both."""
    return (("attn.", "attn"), ("moe.", "moe")) if cfg.family == "moe" else (("", "attn"),)


def _blocks(cfg: ModelConfig):
    """Per block of the model: (the port's key prefix, the path to its dict in
    the reference tree, its index on the stacked ``lax.scan`` axis or None)."""
    if cfg.family not in PORTED_FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    if cfg.family in ("dense", "moe", "vlm"):
        period, n_periods, rem = layer_pattern(cfg)
        for part, key in _sublayers(cfg):
            for i in range(n_periods):
                for j in range(len(period)):
                    yield f"periods.{i}.{j}.{part}", ("periods", j, key), i
            for i in range(len(rem)):
                yield f"remainder.{i}.{part}", ("remainder", i, key), None
    elif cfg.family == "ssm":
        for i in range(cfg.num_layers):
            yield f"layers.{i}.", ("layers",), i
    elif cfg.family == "hybrid":
        n_groups, rem_n = hybrid_layout(cfg)
        for g in range(n_groups):
            for i in range(cfg.attn_every):
                yield f"groups.{g}.{i}.", ("groups", i), g
        yield "shared_attn.", ("shared_attn",), None
        for i in range(rem_n):
            yield f"remainder.{i}.", ("remainder", i), None
    else:
        for i in range(cfg.encoder_layers):
            yield f"enc_layers.{i}.", ("enc_layers",), i
        for key in ("self", "cross"):
            for i in range(cfg.num_layers):
                yield f"dec_layers.{i}.{key}.", ("dec_layers", key), i


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: reinterpret the bits
        return torch.from_numpy(np.array(a).view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))  # own copy


def params_from_reference(cfg: ModelConfig, tree: dict) -> dict[str, torch.Tensor]:
    """The port's ``state_dict`` from the reference's ``LM.init(key)`` tree.

    ``tree`` is that pytree with its leaves as numpy arrays (bfloat16 leaves
    may come as ``ml_dtypes.bfloat16``); the stacked leading axes of
    ``periods``, ``layers`` and ``groups`` are split into one entry per
    layer, and every dtype is kept. Load the result with
    ``model.load_state_dict``.
    """
    out = {k: _tensor(tree[k]) for k in _TOP if k in tree}
    for prefix, path, idx in _blocks(cfg):
        node = tree
        for key in path:
            node = node[key]
        for name, a in node.items():
            out[prefix + name] = _tensor(a if idx is None else np.asarray(a)[idx])
    return out


def params_to_reference(cfg: ModelConfig, state_dict: dict[str, torch.Tensor]) -> dict:
    """The inverse of ``params_from_reference``: the reference's tree layout,
    with float32 numpy leaves (numpy has no bfloat16)."""
    def arr(t):
        return t.detach().float().cpu().numpy()

    def leaves(prefix):
        return {k[len(prefix):]: arr(v) for k, v in state_dict.items() if k.startswith(prefix)}

    def stack(prefixes):
        per = [leaves(p) for p in prefixes]
        return {name: np.stack([d[name] for d in per]) for name in per[0]}

    tree = {k: arr(state_dict[k]) for k in _TOP if k in state_dict}
    if cfg.family in ("dense", "moe", "vlm"):
        period, n_periods, rem = layer_pattern(cfg)
        parts = _sublayers(cfg)
        tree["periods"] = [{key: stack([f"periods.{i}.{j}.{part}" for i in range(n_periods)]) for part, key in parts}
                           for j in range(len(period))]
        if rem:
            tree["remainder"] = [{key: leaves(f"remainder.{i}.{part}") for part, key in parts}
                                 for i in range(len(rem))]
    elif cfg.family == "ssm":
        tree["layers"] = stack([f"layers.{i}." for i in range(cfg.num_layers)])
    elif cfg.family == "hybrid":
        n_groups, rem_n = hybrid_layout(cfg)
        tree["groups"] = [stack([f"groups.{g}.{i}." for g in range(n_groups)]) for i in range(cfg.attn_every)]
        tree["shared_attn"] = leaves("shared_attn.")
        if rem_n:
            tree["remainder"] = [leaves(f"remainder.{i}.") for i in range(rem_n)]
    elif cfg.family == "audio":
        tree["enc_layers"] = stack([f"enc_layers.{i}." for i in range(cfg.encoder_layers)])
        tree["dec_layers"] = {key: stack([f"dec_layers.{i}.{key}." for i in range(cfg.num_layers)])
                              for key in ("self", "cross")}
    else:
        raise ValueError(f"unknown family {cfg.family!r}")
    return tree


def opt_state_from_reference(cfg: ModelConfig, state: dict) -> dict:
    """The port's AdamW state from the reference's ``AdamW.init``/``update``
    state (numpy leaves): ``mu``/``nu`` keyed like the parameters, ``step``
    a 0-d int32 tensor on the host."""
    return {"mu": params_from_reference(cfg, state["mu"]), "nu": params_from_reference(cfg, state["nu"]),
            "step": torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32)}


def opt_state_to_reference(cfg: ModelConfig, state: dict) -> dict:
    """The inverse of ``opt_state_from_reference``, with float32 numpy leaves
    and an int32 ``step``."""
    return {"mu": params_to_reference(cfg, state["mu"]), "nu": params_to_reference(cfg, state["nu"]),
            "step": np.asarray(int(state["step"]), dtype=np.int32)}
