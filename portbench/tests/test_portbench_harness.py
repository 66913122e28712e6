"""The harness on the CPU at tiny sizes, through its test-only entry
(``harness.execute(..., device="cpu", overrides=...)``): every cell's set-up
and requests, the guard against JAX, the contract's character rules, a cell
added by data files alone, and ``correct`` coming out false under the
control and under each fault the cells can have."""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness
from portbench.control import as_report
from portbench.faults import FAULTS
from portbench.reference.lowprec import control_switches

CHECKOUT = Path(__file__).resolve().parents[2]
BENCH = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
TINY = {"moe64.batch16": {"n": 8}, "perm512.single": {"n": 12}}
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2**31 + 17


def _run(cell, tmp_path, seconds=1.0, trace=False, **kw):
    return harness.execute(cell, SEED, seconds, trace, device="cpu", overrides=TINY[cell],
                           out_dir=tmp_path, log=lambda m: None, **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(cell, tmp_path):
    run, res = _run(cell, tmp_path)
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] == len(run.records) > 0 and res["failed"] == 0
    reported = [m["name"] for m in BENCH["end_to_end"] if cell in m.get("workloads", [cell])]
    assert set(res["metrics"]) == set(reported)
    assert list(res)[-1] == "checks"
    assert res["checks"]["cover_gap"]["value"] < res["checks"]["cover_gap"]["limit"]


def test_traced_run_reports_program_metrics(tmp_path):
    _, res = _run("moe64.batch16", tmp_path, trace=True)
    assert res["correct"] is True
    # The CPU has no device timeline: the trace's metrics are left out, not 0.
    assert set(res["metrics"]) == {"collect_ms.batch", "bidding_rounds.batch"}


def test_no_jax_or_reference_package_loaded():
    code = (
        "import sys; sys.path[:0] = [sys.argv[1] + '/src', sys.argv[1]]\n"
        "from portbench import harness\n"
        "r = harness.run_cell('moe64.batch16', 3, 0.5, False, device='cpu', overrides={'n': 8}, log=lambda m: None)\n"
        "import portbench.control, portbench.faults, portbench.devtrace\n"
        "top = {m.split('.', 1)[0] for m in sys.modules}\n"
        "print(sorted(top & {'jax', 'jaxlib', 'flax', 'repro'}), r['correct'])\n"
    )
    out = subprocess.run([sys.executable, "-c", code, str(CHECKOUT)], capture_output=True, text=True,
                         timeout=300, cwd=CHECKOUT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_reference_imports_nothing_of_the_program():
    for path in (CHECKOUT / "portbench" / "reference").glob("*.py"):
        src = path.read_text()
        assert not re.search(r"^\s*(from|import)\s+(repro|repro_torch|jax)\b", src, re.M), path


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_benchmark_json_names_and_units():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    for name in names:
        assert NAME.match(name), name
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", m["workloads"]))
    for w in BENCH["workloads"]:
        assert (CHECKOUT / "portbench" / "workloads" / f"{w['name']}.json").exists()
        assert (CHECKOUT / "portbench" / "traffic" / f"{w['traffic']}.json").exists()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (CHECKOUT / "portbench" / "metrics" / f"{m['name']}.py").exists()
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_cell_added_by_data_files_alone(tmp_path):
    """A configuration, traffic mix, cell and metric dropped into a copy are
    found by name, with no file of the harness edited."""
    root = tmp_path / "copy"
    shutil.copytree(CHECKOUT / "portbench", root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    pb = root / "portbench"
    cfg = json.loads((pb / "configs" / "moe64_s4.json").read_text())
    cfg.update(name="phases8_s2", n=8, s=2, family="permutations", params={"k": 3})
    (pb / "configs" / "phases8_s2.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "batch3.json").write_text(json.dumps({"batch": 3, "pool": 9, "pool_seed": 4}))
    limits = json.loads((pb / "workloads" / "moe64.batch16.json").read_text())["limits"]
    (pb / "workloads" / "phases8.batch3.json").write_text(
        json.dumps({"config": "phases8_s2", "traffic": "batch3", "sample": 4, "limits": limits}))
    (pb / "metrics" / "configs_per_schedule.py").write_text(
        "def read(run):\n    v = run.valid\n    return sum(len(a) for x in v for _, a in x.switches) / len(v)\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "phases8_s2", "source": "test", "file": "portbench/configs/phases8_s2.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "phases8.batch3", "config": "phases8_s2", "traffic": "batch3",
                               "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "configs_per_schedule", "unit": "configs", "better": "lower",
                                "bound": 0.01, "source": "host_clock", "workloads": ["phases8.batch3"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    _, res = harness.execute("phases8.batch3", SEED, 0.5, False, device="cpu", root=pb, out_dir=tmp_path,
                             log=lambda m: None)
    assert res["correct"] is True
    assert set(res["metrics"]) == {"setup_s", "makespan_over_lb", "configs_per_schedule"}
    assert res["metrics"]["configs_per_schedule"]["value"] >= 1


# ------------------------------------------------------- control and faults
@pytest.mark.parametrize("cell", CELLS)
def test_control_in_the_programs_place_is_not_correct(cell, tmp_path, monkeypatch):
    monkeypatch.setattr(harness.Program, "solve", lambda self, Ds, s, delta:
                        [as_report(control_switches(D, s, delta)) for D in Ds])
    _, res = _run(cell, tmp_path)
    assert res["correct"] is False
    assert res["checks"]["cover_gap"]["value"] > res["checks"]["cover_gap"]["limit"]


# Each fault a cell can have, and the number that has to catch it there.
FAULT_CASES = [
    ("moe64.batch16", "answer_altered", "cover_gap"),
    ("moe64.batch16", "refine_unchanged", "missing"),
    ("moe64.batch16", "half_batch", "cover_gap"),
    ("moe64.batch16", "early_stop", "makespan_excess"),
    ("moe64.batch16", "no_equalize", "schedule_excess"),
    ("moe64.batch16", "one_switch", "schedule_excess"),
    ("perm512.single", "answer_altered", "cover_gap"),
    ("perm512.single", "refine_unchanged", "missing"),
    ("perm512.single", "no_equalize", "schedule_excess"),
    ("perm512.single", "one_switch", "schedule_excess"),
]


@pytest.mark.parametrize("cell,fault,number", FAULT_CASES)
def test_fault_is_not_correct(cell, fault, number, tmp_path):
    with FAULTS[fault]():
        _, res = _run(cell, tmp_path)
    assert res["correct"] is False
    assert res["checks"][number]["value"] > res["checks"][number]["limit"], res["checks"]


def test_command_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "moe64.batch16", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=CHECKOUT,
                         timeout=300)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.requires_cuda
def test_command_on_the_card(cuda_card):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "moe64.batch16", "--seed", "5",
                          "--seconds", "2", "--trace", "0"], capture_output=True, text=True, cwd=CHECKOUT,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
