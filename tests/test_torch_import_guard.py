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
model_raised = None
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
    try:
        build_model(get_arch("zamba2-1.2b").reduced())
    except RuntimeError as e:
        model_raised = str(e)
    else:
        model_raised = False
print(json.dumps({"modules": names, "leaked": leaked, "raised": raised,
                  "model_raised": model_raised, "cuda": torch.cuda.is_available()}))
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
    ):
        assert name in probe["modules"]


def test_default_device_raises_without_cuda(probe):
    if probe["cuda"]:
        pytest.skip("a CUDA device is present; the default device is usable")
    assert probe["raised"], "solve_many with no device ran on the CPU"
    assert "device='cpu'" in probe["raised"]
    assert probe["model_raised"], "build_model with no device ran on the CPU"
    assert "device='cpu'" in probe["model_raised"]
