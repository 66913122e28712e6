"""Compiled-HLO collective bytes → rack-level OCS demand matrices, a copy of
``repro.traffic.hlo_traffic`` (the scenario library's ``collectives`` family
builds its byte traces with it).

Bridges the dry-run artifacts to the paper's scheduler: each cell's
per-step collective traffic (parsed from its compiled HLO) is mapped onto
the Fig.-1 rack topology, and SPECTRA schedules the result — giving the
optical-fabric CCT for every (arch × shape) cell next to its roofline
terms.

Mapping (per collective class, per training step):
  all-reduce / all-gather / reduce-scatter  → ring traffic over the mesh's
    data/pod axes (TP collectives stay inside a rack: with 8 chips per
    rack, the model axis is rack-local by construction for axis groups
    ≤ chips_per_rack; larger groups spill a proportional share).
  all-to-all   → uniform rack-to-rack (EP dispatch).
  collective-permute → neighbor ring (pipeline-style).
"""

from __future__ import annotations

import numpy as np

from .collectives import Placement, TrafficModel


def demand_from_collectives(
    wire_bytes: dict[str, float],
    *,
    n_chips: int = 256,
    chips_per_rack: int = 8,
    model_axis: int = 16,
) -> np.ndarray:
    """Rack demand (bytes) for one step, from per-op-class wire bytes/chip."""
    pl = Placement(n_chips, chips_per_rack)
    tm = TrafficModel(pl)
    n_racks = pl.num_racks
    racks = list(range(n_racks))
    # Fraction of a model-axis group that leaves the rack: groups of
    # ``model_axis`` chips laid out contiguously span model_axis/cpr racks.
    spill = max(0.0, 1.0 - chips_per_rack / model_axis)

    def ring(total_bytes: float):
        if total_bytes <= 0 or n_racks < 2:
            return
        per_edge = total_bytes / n_racks
        for i in racks:
            tm.demand_bytes[i, (i + 1) % n_racks] += per_edge

    def uniform(total_bytes: float):
        if total_bytes <= 0 or n_racks < 2:
            return
        per_pair = total_bytes / (n_racks * (n_racks - 1))
        for a in racks:
            for b in racks:
                if a != b:
                    tm.demand_bytes[a, b] += per_pair

    # wire_bytes are per chip; scale to global and split rack-local share.
    for op, per_chip in wire_bytes.items():
        total = per_chip * n_chips
        if op in ("all-reduce", "all-gather", "reduce-scatter"):
            # DP/FSDP share crosses racks (ring); TP share mostly intra-rack.
            ring(total * 0.5 + total * 0.5 * spill)
        elif op in ("all-to-all", "ragged-all-to-all"):
            uniform(total)
        elif op == "collective-permute":
            ring(total)
    return tm.demand_bytes


def schedule_cell_demand(
    artifact: dict,
    *,
    num_switches: int = 4,
    reconfig_delay_s: float = 20e-6,
    chips_per_rack: int = 8,
):
    """Dry-run artifact → (SpectraResult, CCT seconds, demand matrix)."""
    from ..fabric.ocs import OCSFabric

    wire = artifact["roofline"]["collectives"]["wire_bytes"]
    n_chips = artifact["n_chips"]
    D = demand_from_collectives(
        wire, n_chips=n_chips, chips_per_rack=chips_per_rack
    )
    fabric = OCSFabric(num_switches=num_switches,
                       reconfig_delay_s=reconfig_delay_s)
    res, cct = fabric.schedule_bytes(D)
    return res, cct, D
