"""Production and host meshes (port of ``repro.launch.mesh``).

A mesh is a ``torch.distributed`` ``DeviceMesh`` with named dims:

  * single pod: ``(data=16, model=16)`` — 256 ranks;
  * multi-pod:  ``(pod=2, data=16, model=16)`` — 512 ranks.  The ``pod``
    dim composes with ``data`` for batch / gradient parallelism; model
    parallelism never crosses it.

The production meshes exist in the port only over a fake process group
(``launch.dryrun``): the caller starts a world of 256 or 512 ranks first.
``make_host_mesh`` is the mesh a serving engine runs on: over the
default process group, which it starts at world size 1 from an in-memory
store when none exists (NCCL on the card, gloo on the CPU), so no
address or network is needed.

Functions, not module constants: importing this module never starts a
process group.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import resolve_device


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu") -> DeviceMesh:
    """The (16,16) or (2,16,16) mesh over the current default process
    group, whose world size must be 256 or 512."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def ensure_process_group(device) -> None:
    """Start a world-size-1 default process group on an in-memory store
    (NCCL for a CUDA device, gloo otherwise) unless one exists."""
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)


def make_host_mesh(model: int = 1, *, device=None) -> DeviceMesh:
    """Mesh ``(world // model, model)`` over the default process group
    (started at world size 1 when there is none).

    ``model=1`` puts every rank on ``data`` without consulting
    divisibility.  Any other ``model`` must divide the world size
    exactly: a remainder would build a mesh over fewer ranks than the
    group holds, which fails far away with an opaque error.
    """
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    ensure_process_group(dev)
    n = dist.get_world_size()
    if model != 1 and (model < 1 or n % model != 0):
        raise ValueError(
            f"make_host_mesh: model={model} must be >= 1 and divide "
            f"the process group's world size={n} exactly (got remainder "
            f"{n % model if model >= 1 else model}); pick a model-axis "
            f"size from the divisors of {n}")
    return init_device_mesh(dev.type, (n // model, model),
                            mesh_dim_names=("data", "model"))


def batch_axes(mesh) -> tuple:
    """Mesh axes that shard the batch dimension."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def axis_sizes(mesh) -> dict:
    """``{dim name: size}`` of a mesh (the reference's ``mesh.shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))
