"""Logical-axis sharding rules and the manual-SPMD context, as
``repro/distributed/sharding.py``.

Every parameter and activation of the JAX package is annotated with
*logical* axis names; a rules table maps logical names to mesh axes.
``DEFAULT_RULES``, ``make_rules``, ``logical_to_spec`` and
``tree_logical_to_spec`` are the reference's, with one change of form:
a spec is a plain tuple with one entry per dim, each ``None``, one mesh
axis name, or a tuple of axis names (jax's ``PartitionSpec`` holds the
same entries).

Departures:

  * The port has no GSPMD.  ``constrain`` and ``ShardingCtx.__call__``
    return their input unchanged; the paths that run across ranks
    (data-parallel rankgraph2 training, the row-sharded recsys lookup,
    the LM family under a mesh, tensor parallelism over ``model``) are
    written as manual SPMD against ``ShardingCtx.axis_size``,
    ``axis_index`` and ``group``, each rank holding its shards and the
    collectives of ``distributed.collectives`` placed where the
    reference's constraints would make GSPMD put them.
  * ``tree_shardings`` has no counterpart: it builds jax
    ``NamedSharding`` objects, and a torch tensor carries no sharding.
    A rank holds its own shard of a parameter instead: ``param_spec``
    lays it out by the parameter's logical spec under the rules, a dim
    that its axes' size does not divide whole
    (``repro/launch/steps.py::_safe``: gemma-2b's one KV head,
    rankgraph2's 4 heads at ``model`` 8).  The LM family under a mesh
    gathers its FSDP dims (``embed``) where it uses a leaf and uses its
    tensor-parallel dims (``heads``, ``kv_heads``, ``mlp``, ``vocab``,
    ``expert_mlp``) where they lie; rankgraph2 splits its encoders'
    hidden layer (``mlp``) and its aggregators (``heads``).
  * A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` (see
    ``launch.mesh``).  ``make_rules`` and ``axis_size`` read only its
    ``mesh_dim_names`` and ``shape``; ``make_rules`` also takes a plain
    sequence of axis names.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

# A logical spec is a tuple of logical axis names (or None for unsharded
# dims), e.g. ("batch", "seq", "embed").
LogicalSpec = Sequence[Optional[str]]
# A spec: per dim None, one mesh axis, or a tuple of mesh axes.
Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]

# Default rules for the production meshes.  ``pod`` is folded into the
# data-parallel dimension when present (see make_rules).
DEFAULT_RULES: dict[str, Union[None, str, tuple[str, ...]]] = {
    # data-parallel axes
    "batch": ("pod", "data"),
    "nodes": ("pod", "data"),
    "edges": ("pod", "data"),
    # sequence / context axes (unsharded by default; SP variants remap)
    "seq": None,
    "kv_seq": None,
    # model-parallel axes
    "embed": None,
    "mlp": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "vocab": "model",
    "expert": "model",
    "expert_mlp": None,
    "table_rows": "model",       # embedding-table row sharding (recsys)
    "table_dim": None,
    "candidates": ("pod", "data"),  # retrieval candidate sharding
    "channels": "model",          # GNN feature channels
    "irreps": None,
    "codes": None,                # RQ codebooks are small -> replicated
    "code_dim": None,
    "stack": None,                # scan-over-layers leading axis
}


def mesh_axis_names(mesh: Any) -> Tuple[str, ...]:
    """The axis names of a ``DeviceMesh`` (``mesh_dim_names``) or of a
    plain sequence of names."""
    names = getattr(mesh, "mesh_dim_names", mesh)
    return tuple(names or ())


def mesh_sizes(mesh: Any) -> Dict[str, int]:
    """Axis name -> size of a ``DeviceMesh``."""
    return dict(zip(mesh_axis_names(mesh), tuple(mesh.shape)))


def make_rules(mesh: Any, overrides: Optional[Mapping[str, Any]] = None
               ) -> dict[str, Any]:
    """Build a rules table valid for ``mesh`` (drops absent mesh axes)."""
    axes = set(mesh_axis_names(mesh))
    rules: dict[str, Any] = {}
    for name, target in {**DEFAULT_RULES, **(overrides or {})}.items():
        if target is None:
            rules[name] = None
        elif isinstance(target, str):
            rules[name] = target if target in axes else None
        else:  # tuple of axes -> keep the ones this mesh has
            kept = tuple(a for a in target if a in axes)
            rules[name] = kept if kept else None
    return rules


def logical_to_spec(logical: Optional[LogicalSpec],
                    rules: Mapping[str, Any]) -> Spec:
    """Map a tuple of logical names to a spec under ``rules``."""
    if logical is None:
        return ()
    out = []
    used: set[str] = set()
    for name in logical:
        if name is None:
            out.append(None)
            continue
        target = rules.get(name, None)
        if target is None:
            out.append(None)
        elif isinstance(target, str):
            if target in used:   # a mesh axis may appear only once
                out.append(None)
            else:
                used.add(target)
                out.append(target)
        else:
            fresh = tuple(a for a in target if a not in used)
            if fresh:
                used.update(fresh)
                out.append(fresh if len(fresh) > 1 else fresh[0])
            else:
                out.append(None)
    return tuple(out)


def param_spec(logical: LogicalSpec, rules: Mapping[str, Any],
               shape: Sequence[int], sizes: Mapping[str, int]) -> Spec:
    """The spec by which a rank holds its shard of a parameter of
    ``shape``: ``logical_to_spec`` under ``rules``, then each dim that the
    product of its axes' ``sizes`` does not divide whole, as ``_safe``
    keeps it."""
    spec = logical_to_spec(tuple(logical), rules)
    out = []
    for dim, s in zip(shape, spec):
        axes = (s,) if isinstance(s, str) else tuple(s or ())
        n = 1
        for a in axes:
            n *= sizes[a]
        out.append(s if axes and dim % n == 0 else None)
    return tuple(out)


def split_axes(spec: Spec) -> list:
    """(dim, axes) for each dim a spec splits."""
    return [(dim, (s,) if isinstance(s, str) else tuple(s))
            for dim, s in enumerate(spec) if s is not None]


def shard_of(x: Any, spec: Spec, ctx: "ShardingCtx") -> Any:
    """This rank's block of ``x`` (held whole) under ``spec``: each split
    dim cut into equal blocks, taken at the rank's coordinate along its
    axes."""
    for dim, axes in split_axes(spec):
        x = x.chunk(ctx.size(axes), dim=dim)[ctx.axis_index(axes)]
    return x.contiguous()


def spec_groups(spec: Spec, ctx: "ShardingCtx") -> Tuple[Any, ...]:
    """For each dim of ``spec`` the process group it is split over, None
    where whole (axes of size 1 split nothing): a leaf's entry of the
    optimizers' ``shards``."""
    out: list = [None] * len(spec)
    for dim, axes in split_axes(spec):
        if ctx.size(axes) > 1:
            out[dim] = ctx.group(axes)
    return tuple(out)


def _is_logical_leaf(x: Any) -> bool:
    return x is None or (isinstance(x, tuple) and all(
        e is None or isinstance(e, str) for e in x))


def tree_logical_to_spec(tree: Any, rules: Mapping[str, Any]) -> Any:
    """Convert a tree (dicts, lists, tuples) of logical specs into specs;
    a leaf is ``None`` or a tuple of names and ``None``s."""
    if _is_logical_leaf(tree):
        return logical_to_spec(tree, rules)
    if isinstance(tree, Mapping):
        return {k: tree_logical_to_spec(v, rules) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_logical_to_spec(v, rules) for v in tree)
    raise TypeError(f"not a tree of logical specs: {tree!r}")


def constrain(x: Any, logical: LogicalSpec,
              rules: Optional[Mapping[str, Any]]) -> Any:
    """The reference's ``with_sharding_constraint`` by logical names.
    The port has no GSPMD: ``x`` comes back unchanged, and the manual
    SPMD paths place their collectives themselves."""
    return x


@dataclasses.dataclass
class ShardingCtx:
    """Carried through the model functions; ``rules=None`` or
    ``mesh=None`` means one process.  ``mesh`` (a ``DeviceMesh`` over an
    initialised process group) enables the manual SPMD paths, which ask
    it for sizes, this rank's coordinates and process groups."""
    rules: Optional[Mapping[str, Any]] = None
    mesh: Any = None
    _groups: Dict[Tuple[str, ...], Any] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    def __call__(self, x: Any, *logical: Optional[str]) -> Any:
        return constrain(x, logical, self.rules)

    def mesh_axes(self, logical: str) -> Tuple[str, ...]:
        """The mesh axes a logical name maps to (empty if unmapped or no
        mesh)."""
        if self.mesh is None or self.rules is None:
            return ()
        target = self.rules.get(logical)
        if target is None:
            return ()
        return (target,) if isinstance(target, str) else tuple(target)

    def axis_size(self, logical: str) -> int:
        """Product of mesh-axis sizes a logical name maps to (1 if
        unmapped or no mesh)."""
        if self.mesh is None or self.rules is None:
            return 1
        sizes = mesh_sizes(self.mesh)
        out = 1
        for a in self.mesh_axes(logical):
            out *= sizes.get(a, 1)
        return out

    def size(self, name: Union[str, Sequence[str]]) -> int:
        """Product of the sizes of a mesh axis, or of a tuple of them."""
        sizes = mesh_sizes(self.mesh)
        out = 1
        for a in self._names(name):
            out *= sizes[a]
        return out

    def _names(self, name: Union[str, Sequence[str]]) -> Tuple[str, ...]:
        if self.mesh is None:
            raise ValueError("no mesh: one process has no axes")
        names = (name,) if isinstance(name, str) else tuple(name)
        missing = [a for a in names if a not in mesh_axis_names(self.mesh)]
        if missing:
            raise ValueError(f"mesh axes {missing} not in "
                             f"{mesh_axis_names(self.mesh)}")
        return names

    def axis_index(self, name: Union[str, Sequence[str]]) -> int:
        """This rank's coordinate along a mesh axis, or along a tuple of
        axes (row-major over them, first axis slowest, as
        ``jax.lax.axis_index`` of a tuple)."""
        idx = 0
        sizes = mesh_sizes(self.mesh) if self.mesh is not None else {}
        for a in self._names(name):
            idx = idx * sizes[a] + int(self.mesh.get_local_rank(a))
        return idx

    def group(self, name: Union[str, Sequence[str]]):
        """The process group of this rank along a mesh axis, or along a
        tuple of axes.  A tuple with more than one axis of size above 1
        makes its groups on the first call, which every rank must make
        (``torch.distributed.new_subgroups_by_enumeration``)."""
        names = self._names(name)
        sizes = mesh_sizes(self.mesh)
        big = tuple(a for a in names if sizes[a] > 1)
        if len(big) <= 1:
            return self.mesh.get_group(big[0] if big else names[0])
        if big not in self._groups:
            import torch.distributed as dist
            axes = mesh_axis_names(self.mesh)
            ranks = self.mesh.mesh
            keep = [axes.index(a) for a in big]
            rest = [i for i in range(len(axes)) if i not in keep]
            n = 1
            for a in big:
                n *= sizes[a]
            lists = ranks.permute(*rest, *keep).reshape(-1, n).tolist()
            self._groups[big], _ = dist.new_subgroups_by_enumeration(lists)
        return self._groups[big]


NULL_CTX = ShardingCtx(rules=None)
