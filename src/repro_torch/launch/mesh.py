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

``AbstractMesh`` is a mesh with no process group: axis names, sizes and
the coordinate of the one rank it describes.  The cells
(``launch.steps.build_cell``) and the dry run lay a rank's shards out on
it at the production meshes' 256 or 512 ranks; ``make_rules``,
``mesh_sizes`` and ``ShardingCtx.size`` / ``axis_index`` read it as a
``DeviceMesh``, and asking it for a process group raises: a cell built on
it builds, it does not run.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

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


def production_layout(multi_pod: bool = False
                      ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(shape, axes) of the production mesh: (16, 16) ``("data",
    "model")``, or (2, 16, 16) with a ``"pod"`` axis first."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False):
    """The (16, 16) ``("data", "model")`` mesh, or (2, 16, 16) with a
    ``"pod"`` axis first; raises naming the world size it needs."""
    return make_mesh(*production_layout(multi_pod))


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh of ``shape`` with dims named ``mesh_dim_names`` and no
    process group, seen from the rank at ``coords`` (one index a dim;
    default the first rank)."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]
    coords: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        coords = self.coords or (0,) * len(self.shape)
        if len(self.shape) != len(self.mesh_dim_names) \
                or len(coords) != len(self.shape) \
                or any(not 0 <= c < n for c, n in zip(coords, self.shape)):
            raise ValueError(f"mesh {self.shape} {self.mesh_dim_names} has "
                             f"no rank at {coords}")
        object.__setattr__(self, "coords", tuple(coords))

    def get_local_rank(self, name: str) -> int:
        return self.coords[self.mesh_dim_names.index(name)]

    def _no_group(self, *_):
        raise RuntimeError("an AbstractMesh has no process groups: a cell "
                           "built on it builds, it does not run")

    get_group = _no_group
    mesh = property(_no_group)


def abstract_production_mesh(multi_pod: bool = False,
                             coords: Optional[Sequence[int]] = None
                             ) -> AbstractMesh:
    """The production mesh (``production_layout``) as an
    ``AbstractMesh`` seen from the rank at ``coords``."""
    shape, axes = production_layout(multi_pod)
    return AbstractMesh(shape, axes,
                        None if coords is None else tuple(coords))


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
