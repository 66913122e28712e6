"""Device resolution and the CUDA kernel library.

Counterpart of ``repro.kernels.backend``, with a different rule: there is no
``use_kernel`` switch and no environment override. Every public entry point
resolves its device with :func:`resolve_device` (``None`` means CUDA, and a
missing GPU raises); each kernel wrapper then launches its CUDA kernel for a
CUDA tensor and uses its plain PyTorch version for a CPU tensor.

The kernels live in ``repro_torch/csrc/*.cu`` (with shared headers
``*.cuh``) and are built at first use with ``nvcc`` by hand into one shared
library with a plain C interface, loaded with ``ctypes``. The library is
cached under ``build/repro_torch/`` at the repository root, named by a hash
of the sources', the headers' and the flags' contents, so an edited source,
header or flag rebuilds and an unchanged tree loads at once.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

__all__ = ["resolve_device", "load_library", "launch", "current_stream", "library_path"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong

# C entry points: name -> argtypes. Every pointer and the stream are
# c_void_p (a plain c_int would truncate them to 32 bits).
_SIGNATURES = {
    # W, prices, v1, v2, j1, B, n, m, stream
    "auction_bid_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    # W, eps, prices0 (or null), r2c, c2r, prices, rounds, bids, B, n, P, max_iters, reverse, stream
    "auction_rounds_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # W, prices0, eps, r2c, c2r, prices, rounds, bids, B, n, P, max_iters, cluster, stream
    "auction_fused_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # q, k, v, o, BH, group, Sq, Sk, D, scale, causal, window, dtype, stream
    "flash_attention_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P],
    # xd, loga, B, C, y, states, gates, BH, S, L, N, P, dtype, stream
    "ssd_chunk_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # src, dst, w, out, T, n, idx64, stream
    "demand_accum_launch": [_P, _P, _P, _P, _L, _I, _I, _P],
}


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` → CUDA. A CUDA device without a GPU raises; the CPU is used
    only when the caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _sources() -> list[Path]:
    """The translation units: one object each."""
    return sorted(CSRC_DIR.glob("*.cu"))


def _inputs() -> list[Path]:
    """Everything a build reads from ``csrc``: sources and headers."""
    return sorted([*CSRC_DIR.glob("*.cu"), *CSRC_DIR.glob("*.cuh")])


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")
    return found


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    digest = hashlib.sha256("\0".join(NVCC_FLAGS).encode())
    for src in _inputs():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"librepro_torch_{digest.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile every ``csrc/*.cu`` into one shared library (if not cached).

    One ``nvcc -c`` per source, all started together, then one link.
    """
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs, procs = [], []
        for src in _sources():
            obj = Path(tmpdir) / f"{src.stem}.o"
            cmd = [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        failed = []
        for cmd, proc in procs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = Path(tmpdir) / out.name
        cmd = [_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library, with argtypes set."""
    lib = ctypes.CDLL(str(build_library()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def launch(name: str, *args) -> None:
    """Call one C launcher; raise on the ``cudaGetLastError()`` it returns."""
    err = getattr(load_library(), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def current_stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
