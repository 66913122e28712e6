"""The dry run's tables, from the port's artifacts (the twin of
``benchmarks/gen_experiments.py`` and ``benchmarks/roofline_table.py``).

Reads ``build/repro_torch/dryrun/<arch>__<shape>__<mesh>.json`` (written by
``repro_torch.launch.dryrun``) and prints the markdown of §Dry-run (one
table a mesh: kind, parameters, trace seconds, resident bytes a chip,
collectives by kind) and §Roofline (the single-pod mesh's three terms a
chip against the peaks the artifacts were counted with), then writes
``build/repro_torch/roofline_table.csv``: each cell's terms beside the
optical fabric's CCT on the cell's collective demand, scheduled by host
``spectra`` against ``baseline_less`` (as the reference does) and by
``spectra_torch`` on the device. Parameters are counted from
``param_specs`` (``analysis.roofline.count_params``). Dry-run figures are
counts on a fake mesh, not timings. A scheduling failure raises.

Usage::

    python -m repro_torch.bench.experiments [--device cpu]

Exits 1 when there is no single-pod artifact. Runs the device solver on
CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import functools
import json
from pathlib import Path

import numpy as np

from ..launch.dryrun import OUT_DIR as DRYRUN
from .common import OUT_DIR

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
MESHES = (("pod1", "16×16 single-pod (256 chips)"), ("pod2", "2×16×16 multi-pod (512 chips)"))


def fmt_bytes(b: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}PB"


def load(mesh: str, dryrun_dir: Path = DRYRUN) -> dict:
    """{(arch, shape): artifact} of one mesh, in table order."""
    arts = {}
    for p in sorted(Path(dryrun_dir).glob(f"*__{mesh}.json")):
        a = json.loads(p.read_text())
        arts[(a["arch"], a["shape"])] = a
    return dict(sorted(arts.items(), key=lambda kv: (kv[0][0], SHAPE_ORDER.index(kv[0][1]))))


@functools.lru_cache(maxsize=None)
def true_params(arch: str) -> int:
    """The registered config's parameter count, from its ``meta`` specs."""
    from ..analysis.roofline import count_params
    from ..configs.registry import get_arch
    from ..models.registry import param_specs

    return count_params(param_specs(get_arch(arch)))[0]


def dryrun_section(dryrun_dir: Path = DRYRUN) -> str:
    lines = ["### §Dry-run tables", ""]
    for mesh, label in MESHES:
        lines += [f"### {label}", "",
                  "| arch | shape | kind | params | trace_s | bytes/device | collective ops |",
                  "|---|---|---|---|---|---|---|"]
        for (arch, shape), a in load(mesh, dryrun_dir).items():
            ops = a["roofline"]["collectives"]["ops"]
            ops_s = " ".join(f"{k}:{v}" for k, v in sorted(ops.items()))
            lines.append(f"| {arch} | {shape} | {a['kind']} | {true_params(arch) / 1e9:.2f}B | {a['trace_s']} | "
                         f"{fmt_bytes(a['bytes_per_device_est'])} | {ops_s} |")
        lines.append("")
    return "\n".join(lines)


def hw_label(arts: dict) -> str:
    """The peaks every artifact was counted against (they must agree)."""
    hws = {json.dumps(a["hw"], sort_keys=True) for a in arts.values()}
    if len(hws) != 1:
        raise ValueError(f"the artifacts were counted against {len(hws)} different peaks: {sorted(hws)}")
    hw = next(iter(arts.values()))["hw"]
    return (f"{hw['name']}: {hw['peak_flops_bf16'] / 1e12:g} TF/s bf16, {hw['hbm_bw'] / 1e9:g} GB/s HBM, "
            f"{hw['link_bw'] / 1e9:g} GB/s NVLink")


def roofline_section(dryrun_dir: Path = DRYRUN) -> str:
    arts = load("pod1", dryrun_dir)
    lines = [f"### §Roofline table (single-pod 16×16, per chip; {hw_label(arts)})", "",
             "| arch | shape | compute_s | memory_s | collective_s | dominant | MODEL_FLOPS | useful | fraction |",
             "|---|---|---|---|---|---|---|---|---|"]
    for (arch, shape), a in arts.items():
        r = a["roofline"]
        lines.append(f"| {arch} | {shape} | {r['compute_s']:.3e} | {r['memory_s']:.3e} | {r['collective_s']:.3e} "
                     f"| **{r['dominant']}** | {r['model_flops']:.2e} | {r['useful_ratio']:.2f} | "
                     f"{r['roofline_fraction']:.3f} |")
    lines.append("")
    return "\n".join(lines)


def roofline_table(dryrun_dir: Path = DRYRUN, out_dir: Path = OUT_DIR, device=None) -> list[dict]:
    """One row a single-pod cell: its terms and the fabric's CCT on its
    collective demand (host ``spectra`` and its ratio to ``baseline_less``;
    ``spectra_torch`` on ``device``), written to ``roofline_table.csv``."""
    from ..api import Problem, SolveOptions, solve
    from ..fabric.ocs import OCSFabric
    from ..traffic.hlo_traffic import schedule_cell_demand

    table = []
    for (arch, shape), art in load("pod1", dryrun_dir).items():
        r = art["roofline"]
        res, cct, D = schedule_cell_demand(art)
        # The registry path validates the BASELINE schedule (Eq. 3 coverage).
        bl = solve(Problem(D / max(D.max(), 1e-30), 4, res.schedule.delta), solver="baseline_less").makespan
        dev, dev_cct = OCSFabric(num_switches=4, reconfig_delay_s=20e-6).schedule_bytes(
            D, scheduler="spectra_torch", options=SolveOptions(extra={"device": device}))
        table.append({
            "cell": f"{arch}×{shape}",
            "dominant": r["dominant"],
            "compute_s": r["compute_s"],
            "memory_s": r["memory_s"],
            "collective_s": r["collective_s"],
            "fraction": r["roofline_fraction"],
            "useful": r["useful_ratio"],
            "ocs_cct": f"{cct * 1e3:.2f}ms(x{bl / max(res.makespan, 1e-12):.2f})",
            "ocs_cct_device": f"{dev_cct * 1e3:.2f}ms(x{dev.makespan / max(res.makespan, 1e-12):.4f})",
        })
    path = Path(out_dir) / "roofline_table.csv"
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        f.write("cell,dominant,compute_s,memory_s,collective_s,fraction,useful,ocs_cct,ocs_cct_device\n")
        for t in table:
            f.write(f"{t['cell']},{t['dominant']},{t['compute_s']:.4e},{t['memory_s']:.4e},"
                    f"{t['collective_s']:.4e},{t['fraction']:.3f},{t['useful']:.3f},{t['ocs_cct']},"
                    f"{t['ocs_cct_device']}\n")
    return table


def summary_row(table: list[dict]) -> dict:
    """The ``name,us_per_call,derived`` row of the roofline table, as ``benchmarks/run.py`` prints it."""
    dominants: dict = {}
    for t in table:
        dominants[t["dominant"]] = dominants.get(t["dominant"], 0) + 1
    return {"name": "roofline_table", "us_per_call": "0",
            "derived": (f"cells={len(table)};median_frac={float(np.median([t['fraction'] for t in table])):.3f};"
                        f"dominant={dominants}")}


def report(dryrun_dir: Path, out_dir: Path, device) -> list[dict]:
    """Print both tables, the roofline CSV and its summary row for the
    artifacts under ``dryrun_dir``; returns the CSV's rows."""
    print(dryrun_section(dryrun_dir))
    print()
    print(roofline_section(dryrun_dir))
    table = roofline_table(dryrun_dir, out_dir, device)
    print((Path(out_dir) / "roofline_table.csv").read_text(), end="")
    row = summary_row(table)
    print(f"{row['name']},{row['us_per_call']},{row['derived']}")
    return table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    from ..kernels.backend import resolve_device

    dev = resolve_device(args.device)
    if not load("pod1", DRYRUN):
        print(f"no single-pod dry-run artifacts under {DRYRUN} (run repro_torch.launch.dryrun first)")
        return 1
    report(DRYRUN, OUT_DIR, dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
