"""Process groups and named meshes, as ``repro/launch/mesh.py``.

The JAX package builds a ``jax.sharding.Mesh`` over the devices one
process sees.  The port runs one process a rank: ``init_distributed``
joins the default process group, and the mesh builders lay the ranks
out as a ``torch.distributed.device_mesh.DeviceMesh`` with named dims
(``("data", "model")`` and so on), whose per-dim process groups the
manual SPMD paths reduce over (``distributed.sharding.ShardingCtx``).

``init_distributed`` picks the backend itself and prints it: NCCL when
each rank has a card of its own, gloo when the ranks are on the CPU or
share a card (NCCL refuses two ranks on one GPU; gloo takes CUDA tensors
and stages them through the host, so its times say nothing of NCCL's).
Ranks meet through a file (``init_method="file://..."``), never a TCP
port, so runs that start at once never collide on a port.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist


def init_distributed(rank: int, world_size: int, init_file: str,
                     device=None) -> Tuple[str, torch.device]:
    """Join the default process group as ``rank`` of ``world_size``,
    meeting through ``init_file`` (a path no earlier run left behind).

    ``device`` is ``"cuda"`` (the default) or ``"cpu"``.  Returns the
    backend and this rank's device: NCCL and ``cuda:<rank>`` when the
    machine has a card for every rank, gloo and ``cuda:0`` when the
    ranks share fewer cards (each on card ``rank % count``), gloo and
    the CPU on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA requested but torch.cuda.is_available() is False; "
                "pass device='cpu' to run on the CPU")
        n = torch.cuda.device_count()
        dev = torch.device("cuda", rank % n)
        torch.cuda.set_device(dev)
        backend = "nccl" if n >= world_size else "gloo"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world_size)
    if rank == 0:
        print(f"[mesh] backend {backend}, world size {world_size}, "
              f"device {dev.type}", flush=True)
    return backend, dev


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]):
    """A ``DeviceMesh`` of ``shape`` with dims named ``axes`` over the
    initialised default process group (ranks row-major, the last axis
    fastest).  Raises when the world size is not ``prod(shape)``."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed first")
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in length")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"a mesh of shape {tuple(shape)} needs "
                         f"{math.prod(shape)} ranks; the world has {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """The (16, 16) ``("data", "model")`` mesh, or (2, 16, 16) with a
    ``"pod"`` axis first; raises naming the world size it needs."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_host_mesh(model: Optional[int] = None):
    """A ``("data", "model")`` mesh over every rank of the process
    group, ``model`` ranks (default 1) a model group."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed first")
    model = model or 1
    world = dist.get_world_size()
    if world % model:
        raise ValueError(f"model axis {model} does not divide the world "
                         f"size {world}")
    return make_mesh((world // model, model), ("data", "model"))


def mesh_chip_count(mesh) -> int:
    return int(math.prod(tuple(mesh.shape)))
