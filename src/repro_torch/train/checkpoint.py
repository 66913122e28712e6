"""Atomic, async, CRC-verified checkpoints (``repro.train.checkpoint``).

Layout (one directory per step):
    <dir>/step_000000042/
        manifest.json     # step, extra (data-iterator state, ...), and per
                          # leaf its path, file, shape, dtype and crc32
        arr_<n>.npy       # one file per leaf
        _COMMITTED        # written last: marks the checkpoint complete

A checkpoint is written into ``.tmp_step_<n>`` and renamed on commit, so a
reader never sees half of one. A tree is nested dicts (and lists) of
tensors; a leaf's path joins its keys with ``/``, dict keys in sorted order,
so the paths are the port's state names (``params/embed``,
``opt/mu/groups.0.1.w_xz``, ``opt/step``). numpy has no bfloat16: such a
leaf is stored as its uint16 bits, with ``bfloat16`` as its manifest dtype,
and restored bit for bit.

Sharded state (DTensors) is saved by gathering full tensors (every rank
takes part in the gather; rank 0 writes, and the others wait for the
commit), and restored onto any mesh: each leaf is loaded full and placed
by ``shardings`` (the reference's elastic restore: ``device_put`` with the
new shardings), so a (4, 2) checkpoint resumes on a (3, 2) mesh.
"""

from __future__ import annotations

import json
import shutil
import threading
import zlib
from pathlib import Path
from typing import Any

import numpy as np
import torch


def _flatten(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [leaf for i, v in enumerate(tree) for leaf in _flatten(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def _unflatten(like: Any, leaves: dict[str, Any], prefix: str = "") -> Any:
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves, f"{prefix}{k}/") for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves, f"{prefix}{i}/") for i, v in enumerate(like))
    return leaves[prefix[:-1]]


def _is_dtensor(t) -> bool:
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _distributed() -> bool:
    return torch.distributed.is_available() and torch.distributed.is_initialized()


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """(array to store, dtype name); bfloat16 goes as its uint16 bits; a
    DTensor is gathered to its full tensor first."""
    if _is_dtensor(leaf):
        leaf = leaf.full_tensor()
    t = torch.as_tensor(leaf).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def save_checkpoint(directory: str | Path, step: int, tree: Any, *, extra: dict | None = None, keep: int = 3,
                    async_: bool = False) -> Path | threading.Thread:
    """Write checkpoint; returns the final path (or the writer thread if async).

    The device → host copy happens before this returns, in both modes, so
    the caller may go on changing its tensors. With a process group up,
    every rank calls this: rank 0 writes, and in the synchronous mode the
    others return after its commit.
    """
    directory = Path(directory)
    host = [(path, *_to_host(leaf)) for path, leaf in _flatten(tree)]
    if _distributed() and torch.distributed.get_rank() != 0:
        if not async_:
            torch.distributed.barrier()
        return directory / f"step_{step:09d}"

    def _write() -> Path:
        tmp = directory / f".tmp_step_{step:09d}"
        final = directory / f"step_{step:09d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "extra": extra or {}, "leaves": []}
        for i, (path, arr, dtype) in enumerate(host):
            fname = f"arr_{i}.npy"
            np.save(tmp / fname, arr)
            manifest["leaves"].append(
                {"path": path, "file": fname, "shape": list(arr.shape), "dtype": dtype, "crc32": _crc(arr)})
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        (tmp / "_COMMITTED").write_text("ok")
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        _gc(directory, keep)
        return final

    if async_:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    final = _write()
    if _distributed():
        torch.distributed.barrier()
    return final


def _gc(directory: Path, keep: int) -> None:
    ckpts = sorted(d for d in directory.glob("step_*") if d.is_dir())
    for d in ckpts[:-keep]:
        shutil.rmtree(d, ignore_errors=True)


def latest_step(directory: str | Path) -> int | None:
    directory = Path(directory)
    steps = [int(d.name.split("_")[1]) for d in directory.glob("step_*") if (d / "_COMMITTED").exists()]
    return max(steps) if steps else None


def restore_checkpoint(directory: str | Path, like: Any, *, step: int | None = None,
                       verify: bool = True, shardings: Any = None) -> tuple[Any, dict]:
    """Load into the structure of ``like``: each leaf takes the dtype and
    device of ``like``'s leaf at its path. Returns (tree, extra).

    ``shardings``, a tree like ``like`` of ``parallel.sharding.NamedSharding``
    (None leaves stay plain), places each loaded leaf as a DTensor on its
    mesh: the elastic restore onto a mesh other than the saved one.

    Raises FileNotFoundError if no committed checkpoint exists, ValueError
    on a structure or shape mismatch, IOError on a CRC mismatch.
    """
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {directory}")
    final = directory / f"step_{step:09d}"
    manifest = json.loads((final / "manifest.json").read_text())
    flat_like = _flatten(like)
    if len(flat_like) != len(manifest["leaves"]):
        raise ValueError(f"checkpoint has {len(manifest['leaves'])} leaves, expected {len(flat_like)}")
    leaves = {}
    for (path, leaf_like), rec in zip(flat_like, manifest["leaves"]):
        if path != rec["path"]:
            raise ValueError(f"leaf mismatch: {rec['path']} vs {path}")
        arr = np.load(final / rec["file"])
        if verify and _crc(arr) != rec["crc32"]:
            raise IOError(f"crc mismatch in {rec['file']} (corrupt ckpt)")
        like_t = torch.as_tensor(leaf_like)
        if tuple(arr.shape) != tuple(like_t.shape):
            raise ValueError(f"shape mismatch at {rec['path']}: {arr.shape} vs {tuple(like_t.shape)}")
        leaves[path] = _from_host(arr, rec["dtype"]).to(device=like_t.device, dtype=like_t.dtype)
    if shardings is not None:
        from ..parallel.sharding import NamedSharding, distribute

        for path, sh in _flatten(shardings):
            if isinstance(sh, NamedSharding):
                leaves[path] = distribute(leaves[path], sh)
    return _unflatten(like, leaves), manifest["extra"]
