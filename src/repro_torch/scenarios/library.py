"""Built-in traffic families and named scenarios, a copy of
``repro.scenarios.library`` (the same fifteen scenarios; equal traces for
the same seed).

Families wrap the generators in ``repro_torch.traffic`` into the per-period
``(spec, t, rng) -> D`` shape of the scenario registry; the registered
scenarios cover the paper's three evaluation workloads (§V-A), their noise
variants (Fig. 8), the synthetic sparsity/degree sweeps that Figs. 10/11
previously hand-rolled, and collective/HLO-derived byte traffic.

Any scalar family knob can also be supplied as ``<knob>_schedule`` — a
sequence cycled over periods — which is how time-varying sweeps (e.g. the
sparsity scenario's per-period ``m``) are expressed declaratively.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np

from ..traffic.hlo_traffic import demand_from_collectives
from ..traffic.workloads import benchmark_workload, gpt3b_workload, moe_workload
from .registry import register_family, register_scenario
from .spec import TrafficSpec


def _knob(params: Mapping[str, Any], key: str, t: int, default):
    """Resolve a family knob for period ``t``.

    An explicit scalar (``key`` present in params) wins — so overriding a
    sweep scenario with e.g. ``make_trace("sparsity_sweep", m=4)`` pins the
    knob even though the registered spec carries ``m_schedule``. Otherwise
    ``<key>_schedule`` cycles over periods, then the family default applies.
    """
    if key in params:
        return params[key]
    schedule = params.get(f"{key}_schedule")
    if schedule is not None:
        return schedule[t % len(schedule)]
    return default


def _gpt_dims(n: int) -> tuple[int, int, int]:
    """Factor n GPUs into (tp, pp, dp) with tp·pp·dp = n, tp/pp ≤ 4 preferred.

    n=32 recovers the workload's DeepSpeed default (4, 4, 2); n=8 gives
    (4, 2, 1) for the tiny smoke variants.
    """

    def largest_divisor_leq(x: int, cap: int) -> int:
        for d in range(min(cap, x), 0, -1):
            if x % d == 0:
                return d
        return 1

    tp = largest_divisor_leq(n, 4)
    pp = largest_divisor_leq(n // tp, 4)
    dp = n // (tp * pp)
    return tp, pp, dp


@register_family("gpt")
def _gpt_family(spec: TrafficSpec, t: int, rng: np.random.Generator):
    """GPT-3B 3D-parallel training traffic, re-sampled per controller period."""
    p = spec.params
    tp, pp, dp = p.get("dims") or _gpt_dims(spec.n)
    if tp * pp * dp != spec.n:
        raise ValueError(f"dims {tp}x{pp}x{dp} != n={spec.n}")
    noise = _knob(p, "noise", t, 0.003)
    kw = {k: p[k] for k in (
        "tp_bytes", "pp_bytes", "dp_bytes", "emb_bytes", "bg_flows", "bg_bytes"
    ) if k in p}
    D = gpt3b_workload(noise=noise, rng=rng, tp=tp, pp=pp, dp=dp, **kw)
    return D, {"noise": noise, "dims": (tp, pp, dp)}


@register_family("moe")
def _moe_family(spec: TrafficSpec, t: int, rng: np.random.Generator):
    """Qwen-MoE expert routing, re-sampled per period (router drift)."""
    p = spec.params
    top_k = int(_knob(p, "top_k", t, 6))
    skew = float(_knob(p, "skew", t, 0.25))
    noise = float(_knob(p, "noise", t, 0.0))
    tokens = int(p.get("tokens_per_gpu", 8192))
    D = moe_workload(
        n=spec.n, top_k=top_k, tokens_per_gpu=tokens, skew=skew,
        noise=noise, rng=rng,
    )
    return D, {"top_k": top_k, "skew": skew, "noise": noise}


@register_family("benchmark")
def _benchmark_family(spec: TrafficSpec, t: int, rng: np.random.Generator):
    """Standard m-permutation benchmark; ``num_big`` tracks m/4 by default."""
    p = spec.params
    m = int(_knob(p, "m", t, 16))
    num_big = int(_knob(p, "num_big", t, max(1, m // 4)))
    big_frac = float(p.get("big_frac", 0.7))
    noise = float(_knob(p, "noise", t, 0.003))
    D = benchmark_workload(
        n=spec.n, m=m, num_big=num_big, big_frac=big_frac, noise=noise, rng=rng
    )
    return D, {"m": m, "num_big": num_big, "noise": noise}


@register_family("permutations")
def _permutations_family(spec: TrafficSpec, t: int, rng: np.random.Generator):
    """Sum of k random permutations with weights in [floor, 1+floor) (Fig. 11)."""
    p = spec.params
    k = int(_knob(p, "k", t, 16))
    floor = float(p.get("weight_floor", 0.05))
    n = spec.n
    D = np.zeros((n, n), dtype=np.float64)
    for _ in range(k):
        D[np.arange(n), rng.permutation(n)] += rng.random() + floor
    return D, {"k": k}


@register_family("moe_phases")
def _moe_phases_family(spec: TrafficSpec, t: int, rng: np.random.Generator):
    """Phase-cycling MoE expert routing: the support-cache workload.

    A router alternates between ``phases`` fixed expert-assignment
    patterns; period ``t`` replays pattern ``t % phases`` with small
    multiplicative weight noise (support preserved exactly). Each phase is
    a sum of ``fanout`` *disjoint* expert-shift permutations (rotations of
    one random permutation), so consecutive periods share no support — the
    adjacency warm start always misses — while every recurrence of a phase
    is an exact support match for the support-pattern cache, host and
    device alike.
    """
    p = spec.params
    phases = int(p.get("phases", 2))
    fanout = int(_knob(p, "fanout", t, 4))
    noise = float(_knob(p, "noise", t, 0.01))
    phase = t % phases
    n = spec.n
    prng = np.random.default_rng(1000 * spec.seed + int(p.get("phase_seed", 0)) + phase)
    sigma = prng.permutation(n)
    rows = np.arange(n)
    D = np.zeros((n, n), dtype=np.float64)
    for j in prng.choice(n, size=min(fanout, n), replace=False):
        D[rows, np.roll(sigma, int(j))] += prng.random() + 0.2
    if noise > 0:
        D *= 1.0 + noise * rng.standard_normal((n, n))
        np.maximum(D, 0.0, out=D)
    return D, {"phase": phase, "phases": phases, "fanout": fanout}


@register_family("mixed")
def _mixed_family(spec: TrafficSpec, t: int, rng: np.random.Generator):
    """Multi-tenant serving mix: period ``t`` draws one tenant class.

    Cycles through ``classes`` (family names) period by period — the
    heterogeneous open-loop traffic a shared scheduling control plane
    sees. Per-class knobs pass through ``params`` unchanged.
    """
    from .registry import get_family

    p = spec.params
    classes = tuple(p.get("classes", ("moe_phases", "permutations", "uniform")))
    cls = classes[t % len(classes)]
    out = get_family(cls)(spec.replace(family=cls), t, rng)
    D, meta = out if isinstance(out, tuple) else (out, {})
    meta = dict(meta)
    meta["tenant_class"] = cls
    return D, meta


_DEFAULT_WIRE_BYTES = {
    "all-reduce": 4.0e9,       # DP/FSDP gradient sync per chip per step
    "all-to-all": 1.0e9,       # MoE expert dispatch
    "collective-permute": 0.5e9,  # pipeline activations
}


@register_family("uniform")
def _uniform_family(spec: TrafficSpec, t: int, rng: np.random.Generator):
    """Uniform all-to-all demand — the traffic rotors are built for.

    Every off-diagonal pair carries ``load`` units (optionally jittered by
    multiplicative ``noise``); the demand-oblivious round-robin sequence is
    near-optimal here, which is exactly the regime where scheduled fabrics
    stop paying for their matching solves.
    """
    p = spec.params
    load = float(_knob(p, "load", t, 1.0))
    noise = float(_knob(p, "noise", t, 0.0))
    n = spec.n
    D = np.full((n, n), load, dtype=np.float64)
    np.fill_diagonal(D, 0.0)
    if noise > 0:
        D *= 1.0 + noise * rng.standard_normal((n, n))
        np.maximum(D, 0.0, out=D)
        np.fill_diagonal(D, 0.0)
    return D, {"load": load, "noise": noise}


@register_family("collectives")
def _collectives_family(spec: TrafficSpec, t: int, rng: np.random.Generator):
    """HLO-collective-derived rack traffic in *bytes*, bursty per period.

    Per-op-class wire bytes fluctuate lognormally period to period
    (``burstiness`` = σ of the log factor), modeling step-time variation;
    the mapping onto the rack fabric is ``demand_from_collectives``.
    """
    p = spec.params
    wire = dict(p.get("wire_bytes", _DEFAULT_WIRE_BYTES))
    sigma = float(p.get("burstiness", 0.2))
    scales = {
        op: float(rng.lognormal(mean=0.0, sigma=sigma)) if sigma > 0 else 1.0
        for op in wire
    }
    wire = {op: b * scales[op] for op, b in wire.items()}
    chips_per_rack = int(p.get("chips_per_rack", 8))
    D = demand_from_collectives(
        wire,
        n_chips=spec.n * chips_per_rack,
        chips_per_rack=chips_per_rack,
        model_axis=int(p.get("model_axis", 16)),
    )
    return D, {"scales": scales}


# ---------------------------------------------------------------------------
# Named scenarios. s/δ defaults are the mid-grid evaluation point; benchmark
# sweeps override them per datapoint, run_scenario uses them as-is.
# ---------------------------------------------------------------------------

register_scenario(
    "gpt",
    TrafficSpec(family="gpt", n=32, s=4, delta=0.01, periods=8),
    description="GPT-3B 3D-parallel training traffic (32 racks, Fig. 6a)",
)
register_scenario(
    "gpt_noisy",
    TrafficSpec(family="gpt", n=32, s=4, delta=0.01, periods=8,
                params={"noise": 0.01}),
    description="GPT workload at 1% measurement noise (Fig. 8)",
)
register_scenario(
    "moe",
    TrafficSpec(family="moe", n=64, s=4, delta=0.01, periods=8),
    description="Qwen-MoE expert-routing traffic (64 GPUs, Fig. 6b)",
)
register_scenario(
    "moe_noisy",
    TrafficSpec(family="moe", n=64, s=4, delta=0.01, periods=8,
                params={"noise": 0.01}),
    description="MoE workload at 1% noise (Fig. 8)",
)
register_scenario(
    "benchmark",
    TrafficSpec(family="benchmark", n=100, s=4, delta=0.01, periods=8),
    description="Standard 100×100 16-permutation benchmark (Fig. 9)",
)
register_scenario(
    "sparsity_sweep",
    TrafficSpec(family="benchmark", n=100, s=4, delta=0.04, periods=6,
                params={"m_schedule": (4, 8, 12, 16, 24, 32)}),
    description="Per-period sparsity sweep: m flows/port cycling Fig. 10's grid",
)
register_scenario(
    "permutations",
    TrafficSpec(family="permutations", n=100, s=4, delta=0.01, periods=8),
    description="Sum of k=16 random permutations, fixed k (Fig. 11 trials)",
)
register_scenario(
    "degree_sweep",
    TrafficSpec(family="permutations", n=100, s=4, delta=0.01, periods=8,
                params={"k_schedule": (2, 4, 8, 12, 16, 20, 24, 32)}),
    description="Sum-of-k-permutations degree statistics (Fig. 11 / Appendix)",
)
register_scenario(
    "uniform",
    TrafficSpec(family="uniform", n=32, s=4, delta=0.01, periods=8),
    description="Uniform all-to-all traffic — the rotor/VLB home turf",
)
# Large-n scaling tier: the regime the fused auction kernel exists for.
# Short traces (few periods) keep wall-clock sane — per-period cost is what
# these scenarios measure, not trace length.
register_scenario(
    "benchmark_large",
    TrafficSpec(family="benchmark", n=256, s=4, delta=0.01, periods=4,
                params={"m": 32}),
    description="256-port m=32 benchmark — large-n matcher scaling tier",
)
register_scenario(
    "permutations_large",
    TrafficSpec(family="permutations", n=512, s=4, delta=0.01, periods=3,
                params={"k": 16}),
    description="512-port sum-of-16-permutations — large-n scaling tier",
)
register_scenario(
    "pod_1024",
    TrafficSpec(family="permutations", n=1024, s=4, delta=0.01, periods=2,
                params={"k": 8}),
    description="1024-port pod-scale smoke (k=8 perms, 2 periods)",
)
register_scenario(
    "moe_phases",
    TrafficSpec(family="moe_phases", n=64, s=4, delta=0.01, periods=8,
                params={"phases": 2}),
    description="Phase-cycling MoE routing — the support-cache workload "
                "(2 alternating sparse phases, 8 periods)",
)
register_scenario(
    "serve_mixed",
    TrafficSpec(family="mixed", n=16, s=4, delta=0.01, periods=8),
    description="Multi-tenant serving mix: moe_phases/permutations/uniform "
                "classes interleaved — the control-plane load profile",
)
register_scenario(
    "collective_ring",
    TrafficSpec(family="collectives", n=32, s=4, delta=20e-6, periods=8,
                units="bytes"),
    description="HLO-collective byte traffic over 32 racks, bursty per step",
)
