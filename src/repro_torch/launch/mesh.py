"""Device meshes (``repro.launch.mesh``).

Functions, never module-level constants: importing this module touches no
process-group state. The caller starts the process group (``nccl`` on the
card, ``gloo`` on the CPU, ``fake`` for the dry run); the mesh's device type
follows its backend: ``nccl`` → cuda, ``gloo`` and ``fake`` → cpu.
"""

from __future__ import annotations


def mesh_device_type() -> str:
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("no process group: call torch.distributed.init_process_group first")
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape: tuple[int, ...], names: tuple[str, ...]):
    """A ``DeviceMesh`` of ``shape`` over ranks 0..prod(shape) − 1, dims named ``names``."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(mesh_device_type(), torch.arange(int(torch.tensor(shape).prod())).reshape(shape),
                      mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False):
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data", "model")."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_mesh((16, 16), ("data", "model"))


def make_debug_mesh(devices: int | None = None, model: int = 2):
    """A small data × model mesh (CPU multi-process tests, the card's 1 × 1)."""
    import torch.distributed as dist

    n = devices or dist.get_world_size()
    return make_mesh((n // model, model), ("data", "model"))
