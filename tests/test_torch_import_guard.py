"""The PyTorch port stands alone: importing it loads neither JAX nor the
reference package, and its entry points refuse to run without a GPU unless
the caller asks for the CPU."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"

_PROBE = r"""
import importlib, json, pkgutil, sys
import numpy as np
import torch
import repro_torch

names = ["repro_torch"]
for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(mod.name)
    names.append(mod.name)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
raised = None
server_raised = None
model_raised = None
train_raised = None
trainer_raised = None
entry_raised = None
if not torch.cuda.is_available():
    from repro_torch.api import solve_many
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    try:
        solve_many(np.ones((1, 4, 4)), 2, 0.01, solver="spectra_torch")
    except RuntimeError as e:
        raised = str(e)
    else:
        raised = False
    from repro_torch.serve import ScheduleServer
    try:
        ScheduleServer(2, 0.01)
    except RuntimeError as e:
        server_raised = str(e)
    else:
        server_raised = False
    try:
        build_model(get_arch("zamba2-1.2b").reduced())
    except RuntimeError as e:
        model_raised = str(e)
    else:
        model_raised = False
    from repro_torch.launch.train import main as train_main, make_trainer
    from repro_torch.train.loop import Trainer
    sys.argv = ["train", "--arch", "zamba2-1.2b", "--steps", "1", "--batch", "1", "--seq", "8"]
    try:
        train_main()
    except RuntimeError as e:
        train_raised = str(e)
    else:
        train_raised = False
    from repro_torch.launch.train_gpt_ocs import make_gpt_trainer
    from repro_torch.bench.matching import main as bench_main
    from repro_torch.core.torchopt.auction import auction_maximize
    entry_raised = {}
    for name, call in (("gpt_twin", lambda: make_gpt_trainer(tiny=True)),
                       ("bench_matching", lambda: bench_main(["--fast"])),
                       ("auction_shim", lambda: auction_maximize(np.eye(4)))):
        try:
            call()
        except RuntimeError as e:
            entry_raised[name] = str(e)
        else:
            entry_raised[name] = False
    cpu = make_trainer(get_arch("zamba2-1.2b").reduced(), steps=1, batch=1, seq=8, lr=1e-3, device="cpu")
    try:
        Trainer(cpu.model, cpu.optimizer, cpu.stream, cpu.train_step, cpu.cfg)
    except RuntimeError as e:
        trainer_raised = str(e)
    else:
        trainer_raised = False
print(json.dumps({"modules": names, "leaked": leaked, "raised": raised, "server_raised": server_raised,
                  "model_raised": model_raised, "train_raised": train_raised,
                  "trainer_raised": trainer_raised, "entry_raised": entry_raised,
                  "cuda": torch.cuda.is_available()}))
"""


def _probe() -> dict:
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], capture_output=True, text=True,
        env=env, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def probe():
    return _probe()


def test_import_loads_no_jax_and_no_reference(probe):
    assert probe["leaked"] == []
    # Every module of the slice was imported by the walk.
    for name in (
        "repro_torch.api.torch_backend", "repro_torch.core.torchopt.e2e",
        "repro_torch.kernels.auction_bid.ops", "repro_torch.kernels.auction_fused.ops",
        "repro_torch.interop", "repro_torch.traffic.workloads",
        "repro_torch.configs.registry", "repro_torch.models.lm", "repro_torch.models.blocks",
        "repro_torch.kernels.flash_attention.ops", "repro_torch.kernels.ssd_scan.ops",
        "repro_torch.serve.engine", "repro_torch.launch.serve",
        "repro_torch.kernels.demand_accum.ops", "repro_torch.launch.train", "repro_torch.train.loop",
        "repro_torch.train.checkpoint", "repro_torch.train.fault_tolerance", "repro_torch.train.optimizer",
        "repro_torch.data.pipeline", "repro_torch.parallel.steps", "repro_torch.fabric.ocs",
        "repro_torch.core.spectra", "repro_torch.core.matching", "repro_torch.api.pipeline",
        "repro_torch.core.baselines", "repro_torch.core.improved", "repro_torch.core.schedule_ir",
        "repro_torch.obs.trace", "repro_torch.fabric.timeline", "repro_torch.fabric.simulator",
        "repro_torch.api.registry", "repro_torch.api.batch",
        "repro_torch.online", "repro_torch.online.state", "repro_torch.online.controller",
        "repro_torch.online.solvers", "repro_torch.core.torchopt.online_torch",
        "repro_torch.scenarios", "repro_torch.scenarios.spec", "repro_torch.scenarios.registry",
        "repro_torch.scenarios.library", "repro_torch.scenarios.runner", "repro_torch.traffic.hlo_traffic",
        "repro_torch.obs.metrics", "repro_torch.obs.timeline_table", "repro_torch.obs.html",
        "repro_torch.obs.dashboard", "repro_torch.flowsim", "repro_torch.flowsim.flows",
        "repro_torch.flowsim.buffers", "repro_torch.flowsim.indirection", "repro_torch.flowsim.report",
        "repro_torch.flowsim.events", "repro_torch.serve.admission", "repro_torch.serve.cache",
        "repro_torch.serve.metrics", "repro_torch.serve.server", "repro_torch.serve.sessions",
        "repro_torch.serve.loadgen",
        "repro_torch.parallel.sharding", "repro_torch.launch.mesh", "repro_torch.launch.dryrun",
        "repro_torch.launch.perf", "repro_torch.launch.train_gpt_ocs", "repro_torch.analysis.collectives",
        "repro_torch.analysis.roofline", "repro_torch.train.grad_compress", "repro_torch.core.torchopt.auction",
        "repro_torch.bench.matching",
    ):
        assert name in probe["modules"]


def test_default_device_raises_without_cuda(probe):
    if probe["cuda"]:
        pytest.skip("a CUDA device is present; the default device is usable")
    assert probe["raised"], "solve_many with no device ran on the CPU"
    assert "device='cpu'" in probe["raised"]
    assert probe["server_raised"], "ScheduleServer with no device fell back to the CPU or to sync"
    assert "device='cpu'" in probe["server_raised"]
    assert probe["model_raised"], "build_model with no device ran on the CPU"
    assert "device='cpu'" in probe["model_raised"]
    assert probe["train_raised"], "the training launcher with no --device ran on the CPU"
    assert "device='cpu'" in probe["train_raised"]
    assert probe["trainer_raised"], "Trainer with no device ran on the CPU"
    assert "device='cpu'" in probe["trainer_raised"]
    for name, msg in probe["entry_raised"].items():  # the gpt-100m twin, bench/matching, the auction shim
        assert msg and "device='cpu'" in msg, f"{name} with no device ran on the CPU"
