"""Counting host reads: the synchronizing CUDA operations (``.item()``,
``.tolist()``, ``nonzero``, copies between host and device) at which the
host waits for the card.

``count_host_reads`` turns on ``torch.cuda.set_sync_debug_mode("warn")``,
under which PyTorch warns at each such operation, and counts the warnings.
Blocks nest: the outermost open block sets the mode and catches the
warnings, and each block counts those caught while it was open, so an outer
block sees every read of the blocks inside it; other warnings are passed on
when the outermost block closes. The mode and the warning filters belong to
the process, so the state of the open blocks is kept here, once a process,
and a block also counts what other threads read while it is open. The mode
warns only where PyTorch checks for it, so a count is a lower bound.
"""

from __future__ import annotations

import threading
import warnings
from contextlib import contextmanager
from typing import Iterator

import torch

__all__ = ["count_host_reads"]

_LOCK = threading.Lock()
_depth = 0          # blocks open in the process
_outer = None       # (mode before, catch_warnings context, caught list) while one is open
_SHOWN: dict = {}   # the registry of the warnings passed on, so each shows as often as uncaught


def _is_read(w: warnings.WarningMessage) -> bool:
    return "synchroniz" in str(w.message)


def _open() -> list:
    global _depth, _outer
    with _LOCK:
        if _depth == 0:
            before = torch.cuda.get_sync_debug_mode()
            catcher = warnings.catch_warnings(record=True)
            caught = catcher.__enter__()
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            _outer = (before, catcher, caught)
        _depth += 1
        return _outer[2]


def _close() -> None:
    global _depth, _outer
    with _LOCK:
        _depth -= 1
        if _depth:
            return
        before, catcher, caught = _outer
        _outer = None
        try:
            torch.cuda.set_sync_debug_mode(before)
        finally:
            catcher.__exit__(None, None, None)
    for w in caught:  # every other warning goes on as if never caught
        if not _is_read(w):
            warnings.warn_explicit(w.message, w.category, w.filename, w.lineno, registry=_SHOWN, source=w.source)


@contextmanager
def count_host_reads(device) -> Iterator[list]:
    """Count the host reads made inside the block. Yields a one-element list
    filled at exit; on a device other than CUDA nothing synchronizes and it
    holds None."""
    out: list = [None]
    if torch.device(device).type != "cuda":
        yield out
        return
    caught = _open()
    start = len(caught)
    try:
        yield out
    finally:
        out[0] = sum(map(_is_read, caught[start:]))
        _close()
