"""What the port's benchmarks share: where they write, the CSV writer, the
scenario matrices, the solve options and the artifact envelope (the port's
copy of the parts of ``benchmarks/common.py`` and ``benchmarks/artifact.py``
that its entry points use).

Every artifact goes under ``build/repro_torch/``.
"""

from __future__ import annotations

import csv
import json
import subprocess
from datetime import datetime, timezone
from pathlib import Path
from typing import Any

import numpy as np

OUT_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SCHEMA = "repro-bench/v1"


def write_csv(path: Path, rows: list[dict]) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if not rows:
        return
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)


def scenario_matrices(scenario: str, seeds: int) -> list[np.ndarray]:
    """The matrices of one trace of ``seeds`` periods of a registered
    scenario (period ``t`` is seeded ``seed + t``)."""
    from ..scenarios import make_trace

    return list(make_trace(scenario, periods=seeds).demands)


def fast_options(device=None, **extra):
    """``SolveOptions`` without validation or the bound, on ``device``
    (``None``: CUDA)."""
    from ..api import SolveOptions

    return SolveOptions(validate=False, compute_lb=False, extra={"device": device, **extra})


def git_sha() -> str | None:
    """Current commit SHA, or None outside a git checkout."""
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=Path(__file__).resolve().parent,
                             capture_output=True, text=True, timeout=10)
    except OSError:
        return None
    sha = out.stdout.strip()
    return sha if out.returncode == 0 and sha else None


def write_artifact(name: str, metrics: dict[str, Any], *, workload: str | None = None,
                   path: Path | None = None) -> Path:
    """Write ``BENCH_<name>.json`` (or ``path``) in the envelope of
    ``benchmarks/artifact.py``: schema, name, git SHA, timestamp, workload
    and the benchmark's own ``metrics``."""
    path = Path(path) if path is not None else OUT_DIR / f"BENCH_{name}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    doc = {"schema": SCHEMA, "name": name, "git_sha": git_sha(),
           "timestamp": datetime.now(timezone.utc).isoformat(timespec="seconds"),
           "workload": workload, "metrics": metrics}
    path.write_text(json.dumps(doc, indent=2))
    return path
