"""One rank's collectives, FLOPs and bytes from a traced step
(the counterpart of ``repro.analysis.hlo``; the port has no HLO).

``CollectiveStats`` keeps the reference's op names, ``as_dict`` and ring
factors for the wire bytes a chip sends:

    all-reduce          2·(g−1)/g · operand
    all-gather          (g−1)/g · result
    reduce-scatter      (g−1)/g · operand
    all-to-all          (g−1)/g · operand
    collective-permute  1 · operand

``LocalCounter`` feeds it. It is a dispatch mode that lets DTensor ops
through to DTensor (which runs them on each rank's local tensors) and
counts the local ops it sees: a functional collective by its op, the group
size of its process group and its local tensor's bytes; any other op by its
FLOPs (``torch.utils.flop_counter``'s formulas: the matrix products and
attention) and its bytes (each tensor input read once, each output written
once; views and metadata move none). The ops DTensor's sharding
propagation runs on whole-tensor stand-ins to learn output shapes are not
the rank's work and are not counted.

A kernel of the port is counted at the kernel's own cost: while a counter
is active it is ``kernels.backend.cost_hook``, through which the wrappers
(``flash_attention``, ``ssd_chunk``) run a call; it adds
``analysis.roofline.kernel_cost`` once and counts none of the ops of the
plain version that a CPU or fake tensor runs in its place.
Everything else stays eager and unfused: each op's inputs and outputs, as
PyTorch runs them.
"""

from __future__ import annotations

import sys
from collections import defaultdict
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..kernels import backend

_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "permute_tensor": "collective-permute", "broadcast": "collective-permute",
}


@dataclass
class CollectiveStats:
    ops: dict = field(default_factory=lambda: defaultdict(int))
    operand_bytes: dict = field(default_factory=lambda: defaultdict(int))
    wire_bytes: dict = field(default_factory=lambda: defaultdict(float))

    @property
    def total_operand_bytes(self) -> int:
        return sum(self.operand_bytes.values())

    @property
    def total_wire_bytes(self) -> float:
        return sum(self.wire_bytes.values())

    def add(self, op: str, group: int, nbytes: int) -> None:
        """One collective: ``nbytes`` is the operand's bytes on this rank
        (the result's for an all-gather), ``group`` the group size."""
        g = max(int(group), 1)
        if op == "all-reduce":
            wire = 2.0 * (g - 1) / g * nbytes
        elif op in ("all-gather", "reduce-scatter", "all-to-all", "ragged-all-to-all"):
            wire = (g - 1) / g * nbytes
        elif op == "collective-permute":
            wire = float(nbytes)
        else:
            raise ValueError(f"unknown collective {op!r}")
        self.ops[op] += 1
        self.operand_bytes[op] += int(nbytes)
        self.wire_bytes[op] += wire

    def as_dict(self) -> dict:
        return {
            "ops": dict(self.ops),
            "operand_bytes": dict(self.operand_bytes),
            "wire_bytes": {k: float(v) for k, v in self.wire_bytes.items()},
            "total_operand_bytes": self.total_operand_bytes,
            "total_wire_bytes": self.total_wire_bytes,
        }


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0


def _group_size(args, default: int) -> int:
    """The size of the process group a functional collective names."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    for a in reversed(args):
        if isinstance(a, str):
            try:
                return _resolve_process_group(a).size()
            except (ValueError, RuntimeError, KeyError):
                break
    return default


def _in_sharding_propagation() -> bool:
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith("_sharding_prop.py"):
            return True
        f = f.f_back
    return False


# Ops that move no bytes of their own: aliases, uninitialised allocations, host scalars.
_FREE = {"detach", "alias", "lift_fresh", "empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
         "scalar_tensor", "_local_scalar_dense", "sym_size", "sym_stride", "sym_numel", "sym_storage_offset", "dim"}


class LocalCounter(TorchDispatchMode):
    """Counts one rank's local work under a traced step; see the module doc.

    ``flops`` and ``bytes`` are Python ints (exact at any size),
    ``collectives`` a ``CollectiveStats``; ``flops_by_op`` splits the FLOPs
    by op (``bmm``, ``mm``, a kernel's name, ...).
    """

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_fns = flop_registry
        self.flops = 0
        self.bytes = 0
        self.flops_by_op = defaultdict(int)
        self.collectives = CollectiveStats()
        self._in_kernel = 0
        self._outer_hook = None

    def __enter__(self):
        self._outer_hook, backend.cost_hook = backend.cost_hook, self._kernel_call
        return super().__enter__()

    def __exit__(self, *exc):
        backend.cost_hook = self._outer_hook
        return super().__exit__(*exc)

    def _kernel_call(self, name: str, shape: dict, run):
        """One call of kernel ``name`` (``roofline.kernel_cost``'s names and
        shape keys): its FLOPs and bytes once, and none of the ops ``run``
        dispatches."""
        from .roofline import kernel_cost

        flops, nbytes = kernel_cost(name, **shape)
        self.flops += flops
        self.flops_by_op[name] += flops
        self.bytes += nbytes
        self._in_kernel += 1
        try:
            return run()
        finally:
            self._in_kernel -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs it on the local tensors, which come back here
        out = func(*args, **kwargs)
        if self._in_kernel or _in_sharding_propagation():
            return out
        packet = func._overloadpacket
        name = packet.__name__
        ns = func.namespace
        if ns == "_c10d_functional":
            op = _COLLECTIVES.get(name)
            if op is not None:
                nbytes = _nbytes(out) if op == "all-gather" else _nbytes(args[0])
                self.collectives.add(op, _group_size(args, 1), nbytes)
            return out
        fn = self._flop_fns.get(packet)
        if fn is not None:
            flops = int(fn(*args, **kwargs, out_val=out))
            self.flops += flops
            self.flops_by_op[name] += flops
        if func.is_view or name in _FREE or ns == "prim":
            return out
        flat_in = list(args) + list(kwargs.values())
        self.bytes += sum(_nbytes(a) for a in flat_in) + _nbytes(out)
        return out

    def record(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes, "wire": self.collectives.total_wire_bytes,
                "flops_by_op": dict(self.flops_by_op), "collectives": self.collectives.as_dict()}

