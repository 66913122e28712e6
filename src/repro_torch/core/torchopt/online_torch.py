"""Online (cross-period) SPECTRA on the device: a batched stateful step and
its rolling loop over a trace (PyTorch port).

Counterpart of ``repro.core.jaxopt.online_jax``, policy for policy. Every
function takes a leading batch dimension: B independent controllers, each
with its own carried state. The state (``OnlineDeviceState``) holds, per
lane, the permutation left installed on each switch, the previous period's
decomposition (the warm-start seed), the matcher's dual-price carry, the
tightest fresh Σα / max-line-sum ratio seen (the warm-quality reference) and
a support-pattern cache of C entries (C = 0 disables it).

One period (``online_step``):

1. **Warm start.** Re-REFINE the previous period's permutation set on the
   new demand; if that fails, the cache entry whose support equals this
   period's. A warm set is taken when it covers the demand, has at most
   degree(D) rounds and its Σα / max-line-sum stays within ``warm_slack``
   of the reference. The reference skips the fresh DECOMPOSE with
   ``lax.cond``; here ``use_warm`` is read on the host once a period and the
   fresh DECOMPOSE runs only on the lanes that need it (gathered and
   scattered by index), with the dual prices carried when ``warm_prices``.
2. **Two candidates** from the same decomposition: plain LPT + EQUALIZE
   (the stateless one) and reuse-then-LPT + EQUALIZE with a −δ offset on
   every switch that holds a carried configuration. Both go through one
   batched LPT loop and one batched EQUALIZE call (2B lanes).
3. **Best of** the two under the reuse credit, so the chosen makespan is at
   most the same decomposition's stateless one.
4. **State update**: each switch keeps the last configuration it serves;
   the quality reference ratchets down on fresh periods only; the cache
   takes this period's support (in place, or at a round-robin cursor).

``spectra_online_scan`` rolls the step over (B, T, n, n) traces as a Python
loop over T with the state as a carry of device tensors.

Sums that gate a discrete decision (Σα, line sums) are taken in float64 and
rounded once to float32, so the CPU and the card take the same decisions.
Ties take the first index (``argmax``/``argmin`` on integer masks) and
orders are stable sorts, as in the reference. The warm REFINE and the LPT
placement are sequential loops; their trip counts (the largest live round
count) are read on the host, one read each, instead of running all n.
"""

from __future__ import annotations

import warnings
from contextlib import contextmanager
from typing import Iterator, NamedTuple

import torch

from ...kernels.backend import resolve_device
from ..schedule_ir import DeviceSchedule
from .decompose_torch import TorchDecomposition, _add_at, _take, decompose, decompose_prices, lpt_place
from .e2e import slot_table
from .equalize_torch import device_loads, equalize_ir
from .lower_bounds_torch import lower_bound


class OnlineDeviceState(NamedTuple):
    """Cross-period carry of B online controllers (see module doc)."""

    installed: torch.Tensor       # (B, s, n) int64; a -1 row = unconfigured switch
    prev_perms: torch.Tensor      # (B, n, n) int64; previous decomposition, live rounds first
    prev_k: torch.Tensor          # (B,) int64; live previous rounds
    prices: torch.Tensor          # (B, n) float32; matcher dual-price carry
    fresh_ratio: torch.Tensor     # (B,) float32; tightest fresh Σα / max-line-sum (inf: none yet)
    cache_supports: torch.Tensor  # (B, C, n, n) bool; memoized support patterns
    cache_perms: torch.Tensor     # (B, C, n, n) int64; each pattern's permutation set
    cache_k: torch.Tensor         # (B, C) int64; live rounds per entry (0 = empty)
    cache_ratio: torch.Tensor     # (B, C) float32; quality reference at insert
    cache_ptr: torch.Tensor       # (B,) int64; round-robin eviction cursor


class OnlineStepResult(NamedTuple):
    """One period's outcome, per lane."""

    schedule: DeviceSchedule          # chosen slot table (credit-aware)
    reused: torch.Tensor              # (B, R) bool: slots served δ-free
    makespan: torch.Tensor            # (B,) float32: credit-aware makespan
    stateless_makespan: torch.Tensor  # (B,) float32: same decomposition, no credit
    reuse_count: torch.Tensor         # (B,) int64: switches with a carried config
    warm: torch.Tensor                # (B,) bool: warm-start decomposition used
    lb: torch.Tensor                  # (B,) float32: §IV (stateless) lower bound
    k: torch.Tensor                   # (B,) int64: decomposition rounds
    converged: torch.Tensor           # (B,) bool: matcher convergence
    eq_exhausted: torch.Tensor        # (B,) bool: EQUALIZE ran out of slots
    cache_hit: torch.Tensor           # (B,) bool: the warm set came from the cache
    rounds: torch.Tensor              # (B,) int64: bidding rounds (0 on warm periods)


def online_initial_state(
    n: int, s: int, cache_size: int = 0, *, batch: int = 1, device=None
) -> OnlineDeviceState:
    """Fresh state for ``batch`` controllers: nothing installed anywhere.
    ``device=None`` means CUDA (raises without a GPU)."""
    dev = resolve_device(device)
    B, C = batch, cache_size
    identity = torch.arange(n, device=dev)
    return OnlineDeviceState(
        installed=torch.full((B, s, n), -1, dtype=torch.int64, device=dev),
        prev_perms=identity.expand(B, n, n).clone(),
        prev_k=torch.zeros((B,), dtype=torch.int64, device=dev),
        prices=torch.zeros((B, n), dtype=torch.float32, device=dev),
        fresh_ratio=torch.full((B,), torch.inf, dtype=torch.float32, device=dev),
        cache_supports=torch.zeros((B, C, n, n), dtype=torch.bool, device=dev),
        cache_perms=identity.expand(B, C, n, n).clone(),
        cache_k=torch.zeros((B, C), dtype=torch.int64, device=dev),
        cache_ratio=torch.full((B, C), torch.inf, dtype=torch.float32, device=dev),
        cache_ptr=torch.zeros((B,), dtype=torch.int64, device=dev),
    )


def _sum32(x: torch.Tensor, dim) -> torch.Tensor:
    """Sum in float64, rounded once to float32: the same on every device."""
    return x.sum(dim=dim, dtype=torch.float64).float()


def _pick(cond: torch.Tensor, a, b):
    """Per lane: ``a`` where ``cond`` (B,) is set, else ``b`` (tuples of tensors)."""
    return type(a)(*(torch.where(cond.view(-1, *([1] * (x.dim() - 1))), x, y) for x, y in zip(a, b)))


def _warm_refine(D: torch.Tensor, perms: torch.Tensor, k: torch.Tensor, steps: int):
    """Greedy REFINE of ``D`` along a given permutation set, weights from 0,
    over each lane's first ``k`` rounds (``steps`` ≥ max k). Returns
    ``(alphas, residual)``: the residual is the demand the set cannot serve."""
    B, n, _ = D.shape
    R = D.clone()
    alphas = torch.zeros((B, n), dtype=torch.float32, device=D.device)
    for r in range(steps):
        perm = perms[:, r]
        d = torch.where(r < k, torch.clamp_min(_take(R, perm).amax(dim=1), 0.0), 0.0)
        alphas[:, r] = d
        R = torch.clamp_min(_add_at(R, perm, -d), 0.0)
    return alphas, R


def _try_warm(D, perms, k, ref_ratio, steps, deg, line_sum_safe, warm_slack):
    """Re-REFINE ``D`` along a candidate set; returns the packed decomposition
    and whether it passes coverage and the quality gate."""
    B, n, _ = D.shape
    alphas, residual = _warm_refine(D, perms, k, steps)
    covered = residual.amax(dim=(1, 2)) <= 1e-5 * torch.clamp_min(D.amax(dim=(1, 2)), 1e-30)
    live = alphas > 0
    order = torch.argsort((~live).to(torch.int8), dim=1, stable=True)
    dec = TorchDecomposition(
        perms=torch.gather(perms, 1, order[..., None].expand(B, n, n)),
        alphas=torch.gather(torch.where(live, alphas, 0.0), 1, order),
        k=live.sum(dim=1),
        converged=torch.ones((B,), dtype=torch.bool, device=D.device),
        rounds=torch.zeros((B,), dtype=torch.int64, device=D.device),
    )
    warm_ratio = _sum32(alphas, 1) / line_sum_safe
    quality_ok = (dec.k <= deg) & (warm_ratio <= ref_ratio * (1.0 + warm_slack))
    return dec, covered & quality_ok


def _credit(perms, switch, installed, s: int):
    """Per-switch reuse marks on slot tables: ``(reused (B, R), has (B, s))``.
    At most one live slot per switch, the first by slot index, whose
    permutation equals that switch's installed configuration."""
    R = switch.shape[1]
    hs = torch.arange(s, device=switch.device)
    same = (perms[:, None, :, :] == installed[:, :, None, :]).all(dim=-1)  # (B, s, R)
    m = (
        (switch >= 0)[:, None, :] & (switch[:, None, :] == hs[None, :, None])
        & (installed[:, :, 0] >= 0)[:, :, None] & same
    )
    has = m.any(dim=2)
    first = torch.argmax(m.to(torch.int8), dim=2)
    slots = torch.arange(R, device=switch.device)
    reused = ((slots[None, None, :] == first[:, :, None]) & has[:, :, None]).any(dim=1)
    return reused, has


def _reuse_claims(dec: TorchDecomposition, installed, s: int):
    """Step 1 of reuse-then-LPT: each switch in turn claims the first live
    round whose permutation equals its installed one. Returns ``(assignment,
    taken, loads)``."""
    B, n = dec.alphas.shape
    dev = dec.alphas.device
    rounds = torch.arange(n, device=dev)
    valid = (rounds[None, :] < dec.k[:, None]) & (dec.alphas > 0)
    same = (dec.perms[:, None, :, :] == installed[:, :, None, :]).all(dim=-1)  # (B, s, n)
    inst_valid = installed[:, :, 0] >= 0
    taken = torch.zeros((B, n), dtype=torch.bool, device=dev)
    assignment = torch.full((B, n), -1, dtype=torch.int64, device=dev)
    loads = torch.zeros((B, s), dtype=torch.float32, device=dev)
    for h in range(s):
        m = valid & ~taken & inst_valid[:, h, None] & same[:, h]
        hit = m.any(dim=1)
        r = torch.argmax(m.to(torch.int8), dim=1)
        sel = hit[:, None] & (rounds[None, :] == r[:, None])
        taken |= sel
        assignment = torch.where(sel, h, assignment)
        loads[:, h] += torch.where(hit, torch.gather(dec.alphas, 1, r[:, None])[:, 0], 0.0)
    return assignment, taken, loads


def _last_served(ds: DeviceSchedule, reused, installed, s: int) -> torch.Tensor:
    """New installed state: the last non-reused live slot each switch serves
    (slot order, reused slot first, EQUALIZE splits last); a switch serving
    only its carried configuration, or nothing, keeps its previous state."""
    B, R, n = ds.perms.shape
    hs = torch.arange(s, device=ds.switch.device)
    nr = (ds.switch >= 0)[:, None, :] & (ds.switch[:, None, :] == hs[None, :, None]) & ~reused[:, None, :]
    idx = torch.arange(R, device=ds.switch.device)
    last = torch.where(nr, idx, -1).amax(dim=2).clamp_min(0)  # (B, s)
    rows = torch.gather(ds.perms, 1, last[..., None].expand(B, s, n))
    return torch.where(nr.any(dim=2)[..., None], rows, installed)


def online_step(
    state: OnlineDeviceState,
    D: torch.Tensor,
    s: int,
    delta,
    *,
    do_equalize: bool = True,
    merge_aware: bool = False,
    extra_slots: int = 64,
    matcher: str = "auction",
    repair_rounds: int = 0,
    warm_start: bool = True,
    warm_prices: bool = False,
    warm_slack: float = 0.05,
) -> tuple[OnlineStepResult, OnlineDeviceState]:
    """One stateful period for each lane of ``D`` (B, n, n) on the state's
    device; ``delta`` is a scalar or (B,). The chosen makespan is at most
    the same decomposition's stateless makespan, by construction."""
    dev = state.prev_k.device
    D = torch.as_tensor(D, dtype=torch.float32, device=dev)
    B, n, _ = D.shape
    delta = torch.as_tensor(delta, dtype=torch.float32, device=dev).expand(B).contiguous()
    lanes = torch.arange(B, device=dev)
    line_sum = torch.maximum(_sum32(D, 1).amax(dim=1), _sum32(D, 2).amax(dim=1))
    line_sum_safe = torch.clamp_min(line_sum, 1e-30)
    S = D > 0
    deg = torch.maximum(S.sum(dim=1).amax(dim=1), S.sum(dim=2).amax(dim=1))
    C = state.cache_supports.shape[1]
    same_support = (state.cache_supports == S[:, None]).all(dim=(2, 3)) if C else None  # (B, C)

    # ---- 1. decomposition: warm (previous set, then the cache) or fresh ----
    prices = state.prices
    if warm_start:
        # One host read: the trip counts of the two warm REFINE loops.
        k_adj, k_cache = torch.stack([state.prev_k.amax(), state.cache_k.amax() if C else state.prev_k.amax()]).tolist()
        warm_dec, adj_ok = _try_warm(D, state.prev_perms, state.prev_k, state.fresh_ratio, k_adj,
                                     deg, line_sum_safe, warm_slack)
        use_adj = adj_ok & (state.prev_k > 0)
        if C:
            match = same_support & (state.cache_k > 0)
            hit = match.any(dim=1)
            slot = torch.argmax(match.to(torch.int8), dim=1)
            cache_dec, cache_ok = _try_warm(
                D, state.cache_perms[lanes, slot], torch.where(hit, state.cache_k[lanes, slot], 0),
                state.cache_ratio[lanes, slot], k_cache, deg, line_sum_safe, warm_slack,
            )
            use_cache = ~use_adj & hit & cache_ok
            warm_dec = _pick(use_adj, warm_dec, cache_dec)
        else:
            use_cache = torch.zeros((B,), dtype=torch.bool, device=dev)
        use_warm = use_adj | use_cache
        fresh = (~use_warm).nonzero()[:, 0]  # the period's host read of use_warm
        dec = warm_dec
    else:
        use_warm = use_cache = torch.zeros((B,), dtype=torch.bool, device=dev)
        fresh, dec = lanes, None
    if fresh.numel():
        if warm_prices:
            fdec, fprices = decompose_prices(D[fresh], prices[fresh], matcher=matcher, repair_rounds=repair_rounds)
            prices = prices.clone()
            prices[fresh] = fprices
        else:
            fdec = decompose(D[fresh], matcher=matcher, repair_rounds=repair_rounds)
        if dec is None:
            dec = fdec
        else:
            dec = TorchDecomposition(*(x.clone() for x in dec))
            for x, y in zip(dec, fdec):
                x[fresh] = y

    # ---- 2+3. two candidates over the same decomposition, batched as 2B lanes
    # A: plain LPT + EQUALIZE (stateless); B: reuse-then-LPT + credited EQUALIZE.
    valid = (torch.arange(n, device=dev)[None, :] < dec.k[:, None]) & (dec.alphas > 0)
    assign_b, taken, loads_b = _reuse_claims(dec, state.installed, s)
    steps = int(valid.sum(dim=1).amax())
    delta2 = torch.cat([delta, delta])
    both, _ = lpt_place(
        torch.cat([dec.alphas, dec.alphas]), torch.cat([valid, valid & ~taken]),
        torch.cat([torch.zeros_like(loads_b), loads_b]), delta2,
        torch.cat([torch.full_like(assign_b, -1), assign_b]), steps,
    )
    ds2 = slot_table(TorchDecomposition(*(torch.cat([x, x]) for x in dec)), both, delta2, extra_slots)
    installed2 = torch.cat([state.installed, state.installed])
    _, has_pre = _credit(ds2.perms, ds2.switch, installed2, s)
    exhausted2 = torch.zeros((2 * B,), dtype=torch.bool, device=dev)
    if do_equalize:
        offset = -ds2.delta[:, None] * has_pre.float()
        offset[:B] = 0.0
        ds2, exhausted2 = equalize_ir(ds2, s, merge_aware=merge_aware, load_offset=offset)

    # ---- 4. best-of under the reuse credit --------------------------------
    loads2 = device_loads(ds2.alphas, ds2.switch, ds2.delta, s)
    reused2, has2 = _credit(ds2.perms, ds2.switch, installed2, s)
    mk2 = (loads2 - ds2.delta[:, None] * has2).amax(dim=1)
    mk_a, mk_b = mk2[:B], mk2[B:]
    use_b = mk_b <= mk_a
    ds = _pick(use_b, DeviceSchedule(*(x[B:] for x in ds2)), DeviceSchedule(*(x[:B] for x in ds2)))
    reused = torch.where(use_b[:, None], reused2[B:], reused2[:B])
    reuse_count = torch.where(use_b[:, None], has2[B:], has2[:B]).sum(dim=1)

    # ---- 5. state update ---------------------------------------------------
    new_fresh_ratio = torch.where(
        use_warm | (line_sum <= 0), state.fresh_ratio,
        torch.minimum(state.fresh_ratio, _sum32(dec.alphas, 1) / line_sum_safe),
    )
    cache = tuple(state[5:])
    if C:
        ins_hit = same_support.any(dim=1)
        ins_slot = torch.where(ins_hit, torch.argmax(same_support.to(torch.int8), dim=1), state.cache_ptr % C)
        supports, cperms, ck, cratio = (x.clone() for x in state[5:9])
        supports[lanes, ins_slot] = S
        cperms[lanes, ins_slot] = dec.perms
        ck[lanes, ins_slot] = dec.k
        cratio[lanes, ins_slot] = new_fresh_ratio
        cache = (supports, cperms, ck, cratio, torch.where(ins_hit, state.cache_ptr, state.cache_ptr + 1))
    new_state = OnlineDeviceState(
        _last_served(ds, reused, state.installed, s), dec.perms, dec.k, prices, new_fresh_ratio, *cache
    )
    result = OnlineStepResult(
        schedule=ds,
        reused=reused,
        makespan=torch.minimum(mk_a, mk_b),
        stateless_makespan=loads2[:B].amax(dim=1),
        reuse_count=reuse_count,
        warm=use_warm,
        lb=lower_bound(D, s, delta),
        k=dec.k,
        converged=dec.converged,
        eq_exhausted=torch.where(use_b, exhausted2[B:], exhausted2[:B]),
        cache_hit=use_cache,
        rounds=dec.rounds,
    )
    return result, new_state


@contextmanager
def count_host_reads(device) -> Iterator[list]:
    """Count the host reads (synchronizing CUDA operations: ``.item()``,
    ``.tolist()``, ``nonzero``, device-to-host copies) made inside the block,
    through ``torch.cuda.set_sync_debug_mode("warn")``. Yields a one-element
    list filled at exit; on the CPU nothing synchronizes and it holds None."""
    out: list = [None]
    if torch.device(device).type != "cuda":
        yield out
        return
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield out
    finally:
        torch.cuda.set_sync_debug_mode(before)
    out[0] = sum("synchroniz" in str(w.message) for w in caught)


def spectra_online_scan(
    Ds,
    s: int,
    deltas,
    *,
    device=None,
    do_equalize: bool = True,
    merge_aware: bool = False,
    extra_slots: int = 64,
    matcher: str = "auction",
    repair_rounds: int = 0,
    warm_start: bool = True,
    warm_prices: bool = False,
    warm_slack: float = 0.05,
    cache_size: int = 0,
    host_reads: list | None = None,
) -> tuple[OnlineStepResult, OnlineDeviceState]:
    """Roll ``online_step`` over (B, T, n, n) traces (a (T, n, n) trace is
    one lane) from a fresh state, the state staying on the device between
    periods. ``deltas`` is a scalar, (T,) or (B, T). Returns the per-period
    results stacked on dim 1 ((B, T, ...)) and the final state. With a list
    as ``host_reads``, each period's count of host reads is appended (None
    on the CPU)."""
    dev = resolve_device(device)
    Ds = torch.as_tensor(Ds, dtype=torch.float32, device=dev)
    if Ds.dim() == 3:
        Ds = Ds[None]
    B, T, n, _ = Ds.shape
    deltas = torch.as_tensor(deltas, dtype=torch.float32, device=dev)
    deltas = (deltas[None] if deltas.dim() == 1 else deltas).expand(B, T)
    state = online_initial_state(n, s, cache_size, batch=B, device=dev)
    kw = dict(do_equalize=do_equalize, merge_aware=merge_aware, extra_slots=extra_slots, matcher=matcher,
              repair_rounds=repair_rounds, warm_start=warm_start, warm_prices=warm_prices,
              warm_slack=warm_slack)
    steps = []
    for t in range(T):
        if host_reads is None:
            res, state = online_step(state, Ds[:, t], s, deltas[:, t], **kw)
        else:
            with count_host_reads(dev) as reads:
                res, state = online_step(state, Ds[:, t], s, deltas[:, t], **kw)
            host_reads.append(reads[0])
        steps.append(res)
    stacked = OnlineStepResult(
        DeviceSchedule(*(torch.stack(x, dim=1) for x in zip(*(r.schedule for r in steps)))),
        *(torch.stack(x, dim=1) for x in list(zip(*steps))[1:]),
    )
    return stacked, state
