"""RecSys architecture family: dlrm-rm2, wide-deep, sasrec, bst, as
``repro/models/recsys/models.py``, on one process or row-sharded
across ranks.

Parameters are the JAX package's trees: nested dicts and lists of
tensors, MLP layers as ``{"w": (d_out, d_in), "b": (d_out,)}`` in
``nn.Linear`` layout, the attention matrices ``wq``/``wk``/``wv``
``(d, H*hd)`` and ``wo`` ``(H*hd, d)`` in the JAX layout (``x @ w``).
``flatten_params`` names every leaf with a dotted path (``tables``,
``bot.0.w``, ``blocks.1.wq``) for the optimizer.

Every lookup gathers rows in the stored type first and casts them to
the compute type after: the JAX package casts the whole table first
(``params["tables"].astype(compute)``), which gives the same values
(the cast is elementwise) but at ``dlrm-rm2``'s width would add a bf16
copy of 66.56 GB of tables.  Multi-hot bags (``dlrm_forward`` with
(B, F, L) ids) go through the EmbeddingBag op, whose kernels round each
row to the compute type as they load it.

Every init and forward, the recsys steps and ``run_recsys`` take a
``ShardingCtx`` (``ctx=None``: one process).  Under a mesh with a
``"model"`` axis of ``nm > 1`` ranks, a vocabulary ``V`` that ``nm``
divides and ``rules["table_rows"] == "model"`` (the reference's
dispatch, ``row_shards``), each rank of the model axis holds rows
``[mi*V/nm, (mi+1)*V/nm)`` of every leaf that ``row_sharded_leaves``
names (dlrm ``tables``; wide-deep ``tables`` and ``wide``; sasrec
``items``; bst ``items`` and ``other``), and the lookup is
``_lookup_sharded``: each rank gathers the rows it owns (zeros for the
rest), the batch is padded to the data axes and split over them as the
reference does, the model group sums, and the data group gathers the
blocks back, so every rank holds the whole batch's rows, bitwise the
local gather (``x + 0 == x``).  Its backward (``_RowShardLookup``) gives
each rank's shard the gradient of the rows it owns, from the whole
batch.  dlrm's multi-hot bags over row shards go through
``_bag_sharded`` (``_RowShardBag``) on the EmbeddingBag kernels: f32
partial bags of a rank's rows, summed over the model group and rounded
once to the compute type; the backward kernel writes a rank's shard.

Departures: a rank's tensor holds only its rows, so every lookup and
every ``remainder`` takes the whole row count from ``cfg.default_vocab``
(the reference reads ``.shape``, which under GSPMD is the global shape);
the one-process bag lookup still reads it from the table, as the
reference does.  The reference's bag lookup runs on the whole table
under GSPMD, rounding each bag once; the port sums f32 partial bags over
the model group before that one rounding, so a bag may differ from the
one-process sum by the order of its f32 additions.  The reference's
``REPRO_BASELINE`` switch to the local gather is not read.  The model
runs replicated over the data ranks around the lookup (the port has no
GSPMD), so the gradient coming into the lookup is the same on every rank.

Tensor parallelism over ``model`` (manual SPMD with the pair of
``distributed.collectives``): ``param_layout`` lays every leaf out by the
reference's logical specs (``param_specs``: an MLP's first layer
``(embed, mlp)``, later ones ``(mlp, mlp)``, the last ``(mlp,
final_name)``; a block's ``wq``/``wk``/``wv`` ``(embed, heads)``, ``wo``
``(heads, embed)``, ``ff1`` ``(embed, mlp)``, ``ff2`` ``(mlp, embed)``)
after ``logical_to_spec``'s once-per-axis rule and ``_safe``, reversed
for the port's ``(d_out, d_in)`` linear weights; ``shard_dense`` cuts a
rank's blocks, which ``init_params(ctx=)`` and
``convert.recsys_params_from_jax(ctx=)`` hold.  Under the default rules
a first layer splits by columns and the later ones by rows
(``_linear_tp``); bst's heads split over the model ranks (a rank's heads
whole, ``wo`` by rows); where the axis splits within a head (sasrec's
one head at ``model`` 2) ``wq``/``wk``/``wv`` are gathered and the
attention runs whole.  Departure: a row-split layer's bias, split by the
reference's spec (``(mlp,)``) but added to a whole output, is gathered
(``gather_split``).  A whole leaf's gradient is whole on every rank, a
split one's the rank's block.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import RecsysConfig
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import (ShardingCtx, mesh_sizes,
                                              param_spec, shard_of,
                                              spec_groups)
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.embedding_bag.ops import (
    embedding_bag, embedding_bag_partials, embedding_bag_table_grad)
from repro_torch.nn import core as nn

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
Params = Dict[str, Any]


def flatten_params(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Every tensor of a parameter tree under its dotted path."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(flatten_params(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def _init_ctx(generator: Optional[torch.Generator], device):
    """(generator, device): the generator must live on the device the
    parameters are drawn on; by default one seeded 0 there."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, parameters on "
                         f"{dev}: draw them where they live")
    return generator, dev


# ---------------------------------------------------------------------------
# shared sparse-embedding substrate
# ---------------------------------------------------------------------------

def _tables_init(generator: torch.Generator, shape, dtype: torch.dtype,
                 device, rows: Optional[slice] = None) -> torch.Tensor:
    """An embedding table (V, D) or stack of them (F, V, D), N(0, 1) *
    0.01, drawn in place one field at a time (no temporary the size of
    the tables).  ``rows``: keep only these rows of each table (dim 0 of
    a table, dim 1 of a stack), each table drawn whole first, so that the
    generator advances as in the whole init and the rows equal the whole
    table's."""
    if rows is None:
        out = torch.empty(shape, dtype=dtype, device=device)
        for part in (out if out.dim() == 3 else [out]):
            part.normal_(0.0, 1.0, generator=generator).mul_(0.01)
        return out
    stack = len(shape) == 3
    F_, V, D = shape if stack else (1, *shape)
    out = torch.empty((F_, rows.stop - rows.start, D), dtype=dtype,
                      device=device)
    for f in range(F_):
        whole = torch.empty((V, D), dtype=dtype, device=device)
        whole.normal_(0.0, 1.0, generator=generator).mul_(0.01)
        out[f] = whole[rows]
        del whole
    return out if stack else out[0]


def row_shards(ctx: Optional[ShardingCtx], vocab: int) -> int:
    """The number of row shards a table of ``vocab`` rows has under
    ``ctx``: the ``"model"`` axis's size where the reference dispatches
    to ``_lookup_sharded`` (a model axis of more than one rank that
    divides ``vocab``, ``rules["table_rows"] == "model"``), else 1."""
    if ctx is None or ctx.mesh is None:
        return 1
    nm = mesh_sizes(ctx.mesh).get("model", 1)
    if nm > 1 and vocab % nm == 0 and \
            (ctx.rules or {}).get("table_rows") == "model":
        return nm
    return 1


def shard_rows(ctx: Optional[ShardingCtx], vocab: int) -> Optional[slice]:
    """This rank's rows of a table of ``vocab`` rows under ``ctx``, or
    ``None`` where the table stays whole."""
    nm = row_shards(ctx, vocab)
    if nm == 1:
        return None
    mi, v_loc = ctx.axis_index("model"), vocab // nm
    return slice(mi * v_loc, (mi + 1) * v_loc)


# Each kind's leaves whose rows the ``table_rows`` rule shards (the
# reference's specs with ``"table_rows"``): a stack (F, V, D) by dim 1,
# a table (V, D) by dim 0.  ``pos``, the blocks and the MLPs stay whole.
ROW_SHARDED = {"dlrm": ("tables",), "wide_deep": ("tables", "wide"),
               "sasrec": ("items",), "bst": ("items", "other")}


def row_sharded_leaves(cfg: RecsysConfig,
                       ctx: Optional[ShardingCtx]) -> Tuple[str, ...]:
    """The leaves of ``cfg.kind`` that ``ctx`` row-shards, each rank
    holding its ``shard_rows``; empty where the tables stay whole."""
    if row_shards(ctx, cfg.default_vocab) == 1:
        return ()
    return ROW_SHARDED[cfg.kind]


def _lookup_local(tables: torch.Tensor, ids: torch.Tensor,
                  compute: torch.dtype) -> torch.Tensor:
    """Per-field gather: tables (F, V, D), ids (B, F) -> (B, F, D) in
    ``compute``; ids are taken mod V (floor semantics, as JAX's ``%``)."""
    n_fields, V, D = tables.shape
    offs = torch.arange(n_fields, device=ids.device)[None, :] * V
    flat = offs + torch.remainder(ids, V)
    return tables.reshape(-1, D)[flat].to(compute)


def _data_block(ids: torch.Tensor, sctx: ShardingCtx
                ) -> Tuple[torch.Tensor, Tuple[str, ...], int]:
    """(this data rank's block of ``ids``, the data axes, their size):
    the batch padded with zero ids to a multiple of the data ranks and
    cut into equal blocks, as the reference's ``_lookup_sharded``."""
    sizes = mesh_sizes(sctx.mesh)
    dp_axes = tuple(a for a in ("pod", "data") if a in sizes)
    dp = math.prod(sizes[a] for a in dp_axes)
    pad = (-ids.shape[0]) % max(dp, 1)
    if pad:  # e.g. a single request's short id list vs 16 DP shards
        ids = torch.cat([ids, ids.new_zeros((pad,) + ids.shape[1:])])
    b = ids.shape[0] // dp
    di = sctx.axis_index(dp_axes) if dp > 1 else 0
    return ids[di * b:(di + 1) * b], dp_axes, dp


def _gather_data(x: torch.Tensor, dp_axes: Tuple[str, ...], dp: int,
                 sctx: ShardingCtx) -> torch.Tensor:
    """The data ranks' equal blocks ``x`` concatenated in their order."""
    if dp == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(dp)]
    dist.all_gather(parts, x.contiguous(), group=sctx.group(dp_axes))
    return torch.cat(parts)


def _shard_meta(tables: torch.Tensor, sctx: ShardingCtx
                ) -> Tuple[int, int, int]:
    """(this rank's model index, its rows a field, the whole rows)."""
    v_loc = tables.shape[1]
    return sctx.axis_index("model"), v_loc, v_loc * sctx.size("model")


def _own_rows(tables: torch.Tensor, ids: torch.Tensor, sctx: ShardingCtx
              ) -> torch.Tensor:
    """ids (b, F), the same on every rank of the model group -> (b, F, D):
    each rank gathers the rows it owns (zeros for the others' ids) and
    the model group sums them, so every rank of it holds the rows of
    ``ids`` bitwise (``x + 0 == x``)."""
    F_, _, D = tables.shape
    mi, v_loc, V = _shard_meta(tables, sctx)
    rel = torch.remainder(ids, V) - mi * v_loc                 # (b, F)
    ok = (rel >= 0) & (rel < v_loc)
    safe = torch.clamp(rel, 0, v_loc - 1)
    flat = torch.arange(F_, device=ids.device)[None, :] * v_loc + safe
    rows = tables.reshape(F_ * v_loc, D)[flat]
    rows = rows * ok[..., None].to(rows.dtype)
    dist.all_reduce(rows, group=sctx.group("model"))
    return rows


class _RowShardLookup(torch.autograd.Function):
    """Forward: the whole batch's rows from row-sharded tables (see
    ``_lookup_sharded``).  Backward: this rank's shard gets the gradient
    of the rows it owns, summed over the whole batch from the incoming
    gradient (the same on every rank), as the local gather's gradient
    restricted to the shard; no communication."""

    @staticmethod
    def forward(ctx_, tables, ids, sctx, compute):
        blk, dp_axes, dp = _data_block(ids, sctx)
        rows = _gather_data(_own_rows(tables, blk, sctx), dp_axes, dp, sctx)
        ctx_.save_for_backward(ids)
        ctx_.meta = (tables.shape, tables.dtype, *_shard_meta(tables, sctx))
        return rows[:ids.shape[0]].to(compute)

    @staticmethod
    def backward(ctx_, g):
        (ids,) = ctx_.saved_tensors
        (F_, v_loc, D), dtype, mi, _, V = ctx_.meta
        rel = torch.remainder(ids, V) - mi * v_loc
        ok = (rel >= 0) & (rel < v_loc)
        flat = (torch.arange(F_, device=ids.device)[None, :] * v_loc
                + rel)[ok]
        d_tab = torch.zeros((F_ * v_loc, D), dtype=dtype, device=g.device)
        d_tab.index_add_(0, flat, g.to(dtype)[ok])
        return d_tab.reshape(F_, v_loc, D), None, None, None


def _lookup_sharded(tables: torch.Tensor, ids: torch.Tensor,
                    ctx: ShardingCtx,
                    compute: Optional[torch.dtype] = None) -> torch.Tensor:
    """Distributed lookup over row-sharded tables: ``tables`` (F, V/nm,
    D) holds this rank's rows ``[mi*V/nm, (mi+1)*V/nm)`` of every
    field's table, ids (B, F) are the whole batch's (the same on every
    rank).  The batch is padded to a multiple of the data ranks and each
    data rank takes its block; each model rank gathers the rows it owns
    (zeros for ids outside its range), the model group sums them, and
    the data group gathers the blocks, so every rank returns the whole
    (B, F, D) in ``compute`` (default: the table's type).  The reference
    moves O(B*F*D) activation bytes where a gather from a row-sharded
    table would replicate O(F*V*D) table bytes."""
    return _RowShardLookup.apply(tables, ids, ctx, compute or tables.dtype)


def _check_rows(tables: torch.Tensor, V: int, nm: int) -> None:
    if tables.shape[1] * nm != V:
        raise ValueError(f"a table of {V} rows over {nm} row shards: "
                         f"expected {V // nm} rows here, got "
                         f"{tables.shape[1]}")


def _lookup_simple(tables: torch.Tensor, ids: torch.Tensor,
                   compute: torch.dtype, ctx: Optional[ShardingCtx] = None,
                   vocab: Optional[int] = None) -> torch.Tensor:
    """Embedding lookup with the reference's dispatch: ``_lookup_sharded``
    where ``row_shards(ctx, vocab) > 1`` (``tables`` then holds this
    rank's rows), the local gather otherwise (``tables`` whole).
    ``vocab``: the table's whole row count, by default
    ``tables.shape[1]``."""
    V = tables.shape[1] if vocab is None else vocab
    nm = row_shards(ctx, V)
    _check_rows(tables, V, nm)
    if nm > 1:
        return _lookup_sharded(tables, ids, ctx, compute)
    return _lookup_local(tables, ids, compute)


def take_rows(table: torch.Tensor, ids: torch.Tensor,
              compute: Optional[torch.dtype] = None,
              ctx: Optional[ShardingCtx] = None,
              vocab: Optional[int] = None) -> torch.Tensor:
    """(V, D) table row gather with the distributed dispatch, ids any
    shape, in ``compute`` (default: the table's type).  Callers sanitize
    negative ids (padding)."""
    shape = ids.shape
    out = _lookup_simple(table[None], ids.reshape(-1, 1),
                         compute or table.dtype, ctx, vocab)
    return out.reshape(*shape, table.shape[-1])


@torch.no_grad()
def take_rows_in_group(table: torch.Tensor, ids: torch.Tensor,
                       compute: torch.dtype, ctx: Optional[ShardingCtx],
                       vocab: int) -> torch.Tensor:
    """(V, D) table rows of ids (N,), where ``ids`` is the same on the
    ranks of a model group but may differ between data ranks (a rank's
    block of retrieval candidates): over row shards each rank gathers
    the rows it owns and the model group sums them (no data split, no
    gather), else the local gather.  (N, D) in ``compute``, no
    gradient."""
    nm = row_shards(ctx, vocab)
    _check_rows(table[None], vocab, nm)
    if nm > 1:
        out = _own_rows(table[None], ids[:, None], ctx)
    else:
        out = _lookup_local(table[None], ids[:, None], table.dtype)
    return out[:, 0].to(compute)


def _shard_bags(ids: torch.Tensor, mi: int, v_loc: int, V: int
                ) -> torch.Tensor:
    """Multi-hot ids (B, F, L) (-1 pad) -> (B*F, L) int32 bags into a
    rank's flat shard (F*v_loc, D): the ids it owns (mod V) as rows of
    the shard, every other id -1, the op's padding."""
    B, n_fields, L = ids.shape
    rel = torch.remainder(ids, V) - mi * v_loc
    ok = (ids >= 0) & (rel >= 0) & (rel < v_loc)
    offs = (torch.arange(n_fields, device=ids.device) * v_loc)[None, :, None]
    return torch.where(ok, rel + offs, -1).to(torch.int32).reshape(
        B * n_fields, L)


class _RowShardBag(torch.autograd.Function):
    """Multi-hot bags over row-sharded tables, on the EmbeddingBag
    kernels.  Forward: the batch padded and split over the data axes as
    ``_RowShardLookup``; each rank sums the rows it owns of each bag of
    its block in f32 (the forward kernel with f32 out, rows rounded to
    the compute type), the model group sums the partial bags, the data
    group gathers the blocks, and the sum is rounded once to the compute
    type.  Backward: the backward kernel on the whole batch's ids masked
    to this rank's rows, into its shard; no communication (the incoming
    gradient is the same on every rank)."""

    @staticmethod
    def forward(ctx_, tables, ids, sctx, compute):
        F_, v_loc, D = tables.shape
        mi, _, V = _shard_meta(tables, sctx)
        flat = tables.reshape(F_ * v_loc, D)
        blk, dp_axes, dp = _data_block(ids, sctx)
        part = embedding_bag_partials(flat, _shard_bags(blk, mi, v_loc, V),
                                      compute)
        dist.all_reduce(part, group=sctx.group("model"))
        out = _gather_data(part.reshape(-1, F_, D), dp_axes, dp, sctx)
        ctx_.save_for_backward(tables, ids)
        ctx_.meta = (mi, V, compute)
        return out[:ids.shape[0]].to(compute)

    @staticmethod
    def backward(ctx_, g):
        tables, ids = ctx_.saved_tensors
        mi, V, compute = ctx_.meta
        F_, v_loc, D = tables.shape
        d_flat = embedding_bag_table_grad(
            g.reshape(-1, D), tables.reshape(F_ * v_loc, D),
            _shard_bags(ids, mi, v_loc, V), compute)
        return d_flat.reshape(F_, v_loc, D), None, None, None


def _bag_sharded(tables: torch.Tensor, ids: torch.Tensor, ctx: ShardingCtx,
                 compute: torch.dtype,
                 weights: Optional[torch.Tensor] = None,
                 mode: str = "sum") -> torch.Tensor:
    """Multi-hot bags (B, F, L) over row-sharded tables (F, V/nm, D), the
    whole batch on every rank -> (B, F, D) in ``compute``
    (``_RowShardBag``).  Only the form the reference's ``_bag_lookup``
    uses, a sum without weights; anything else raises."""
    if mode != "sum" or weights is not None:
        raise NotImplementedError(
            f"bags over row-sharded tables take mode 'sum' without "
            f"weights (the reference's _bag_lookup), got mode {mode!r}"
            f"{' with weights' if weights is not None else ''}")
    return _RowShardBag.apply(tables, ids, ctx, compute)


def _bag_lookup(tables: torch.Tensor, ids: torch.Tensor,
                compute: torch.dtype, ctx: Optional[ShardingCtx] = None,
                vocab: Optional[int] = None) -> torch.Tensor:
    """Multi-hot bags: tables (F, V, D), ids (B, F, L) (-1 pad) ->
    (B, F, D) in ``compute``, through the EmbeddingBag op (sum).  Where
    ``row_shards(ctx, vocab) > 1`` ``tables`` holds this rank's rows and
    the bags go through ``_bag_sharded``; otherwise the tables are whole
    and their row count is read from their shape, as the reference does
    (a caller may pass a compacted table)."""
    nm = 1 if vocab is None else row_shards(ctx, vocab)
    if nm > 1:
        _check_rows(tables, vocab, nm)
        return _bag_sharded(tables, ids, ctx, compute)
    B, n_fields, L = ids.shape
    V, D = tables.shape[1], tables.shape[2]
    flat_tab = tables.reshape(n_fields * V, D)
    offs = (torch.arange(n_fields, device=ids.device) * V)[None, :, None]
    # one bag per (b, f); the modulo only where ids >= 0
    bag_ids = torch.where(ids >= 0, torch.remainder(ids, V) + offs, -1)
    out = embedding_bag(flat_tab, bag_ids.reshape(B * n_fields, L), None,
                        "sum", compute_dtype=compute)
    return out.reshape(B, n_fields, D)


# ---------------------------------------------------------------------------
# parameter specs and tensor parallelism over ``model``
# ---------------------------------------------------------------------------

_TABLE = (None, "table_rows", "table_dim")
# each kind's MLPs and the logical name of their last layer's output
# (``nn.mlp_init``'s ``final_name``)
_MLPS = {"dlrm": {"bot": "mlp", "top": None}, "wide_deep": {"deep": None},
         "sasrec": {}, "bst": {"mlp": None}}
# a transformer block's leaves (``_tx_block_init``), linear ``w`` in the
# reference's (d_in, d_out) order
_TX = {"wq": ("embed", "heads"), "wk": ("embed", "heads"),
       "wv": ("embed", "heads"), "wo": ("heads", "embed"),
       "ln1": ("embed",), "ln2": ("embed",),
       "ff1.w": ("embed", "mlp"), "ff1.b": ("mlp",),
       "ff2.w": ("mlp", "embed"), "ff2.b": ("embed",)}


def _mlp_dims(cfg: RecsysConfig) -> Dict[str, list]:
    """Each MLP's ``dims`` (``nn.mlp_init``'s), by its key."""
    F_, D = cfg.n_sparse, cfg.embed_dim
    if cfg.kind == "dlrm":
        n_vec = F_ + 1
        return {"bot": [cfg.n_dense, *cfg.bot_mlp],
                "top": [n_vec * (n_vec - 1) // 2 + cfg.bot_mlp[-1],
                        *cfg.top_mlp]}
    if cfg.kind == "wide_deep":
        return {"deep": [F_ * D, *cfg.bot_mlp, 1]}
    if cfg.kind == "bst":
        return {"mlp": [(cfg.seq_len + 1) * D + F_ * D, *cfg.top_mlp]}
    return {}


def _ref_shapes(cfg: RecsysConfig) -> Dict[str, tuple]:
    """``flatten_params``' names -> each parameter's shape in the
    reference's layout (a linear ``w`` (d_in, d_out))."""
    F_, V, D = cfg.n_sparse, cfg.default_vocab, cfg.embed_dim
    out: Dict[str, tuple] = {}
    if cfg.kind in ("dlrm", "wide_deep"):
        out["tables"] = (F_, V, D)
    if cfg.kind == "wide_deep":
        out["wide"] = (F_, V, 1)
    if cfg.kind in ("sasrec", "bst"):
        out["items"] = (V, D)
        out["pos"] = (cfg.seq_len + (cfg.kind == "bst"), D)
        hd = max(D // cfg.n_heads, 1)
        shapes = {"wq": (D, cfg.n_heads * hd), "wk": (D, cfg.n_heads * hd),
                  "wv": (D, cfg.n_heads * hd), "wo": (cfg.n_heads * hd, D),
                  "ln1": (D,), "ln2": (D,), "ff1.w": (D, 4 * D),
                  "ff1.b": (4 * D,), "ff2.w": (4 * D, D), "ff2.b": (D,)}
        for i in range(cfg.n_blocks):
            out.update({f"blocks.{i}.{k}": v for k, v in shapes.items()})
    if cfg.kind == "bst":
        out["other"] = (F_, V, D)
    for name, dims in _mlp_dims(cfg).items():
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            out[f"{name}.{i}.w"], out[f"{name}.{i}.b"] = (a, b), (b,)
    return out


def _logical(kind: str, name: str, depth: Dict[str, int]) -> tuple:
    """The reference's logical spec of leaf ``name`` (a linear ``w`` in
    its (d_in, d_out) order), as its inits annotate it
    (``repro/models/recsys/models.py``; ``repro/nn/core.py::mlp_init``:
    layer 0 ``(embed, mlp)``, a later one ``(mlp, mlp)``, the last
    ``(mlp, final_name)``, each bias ``(out_name,)``).  ``depth``: each
    MLP's layers."""
    top, *rest = name.split(".")
    if top in ("tables", "wide", "other"):
        return _TABLE
    if top == "items":
        return ("table_rows", "table_dim")
    if top == "pos":
        return (None, None)
    if top == "blocks":
        return _TX[".".join(rest[1:])]
    i, leaf = int(rest[0]), rest[1]
    out = _MLPS[kind][top] if i == depth[top] - 1 else "mlp"
    return ("embed" if i == 0 else "mlp", out) if leaf == "w" else (out,)


def _linear_w(name: str) -> bool:
    """A linear layer's weight, held (d_out, d_in) where the reference
    holds (d_in, d_out)."""
    return name.endswith(".w")


def _depth(names) -> Dict[str, int]:
    """Each MLP's layers, from its leaves' names."""
    out: Dict[str, int] = {}
    for k in names:
        top, *rest = k.split(".")
        if top in ("bot", "top", "deep", "mlp"):
            out[top] = max(out.get(top, 0), int(rest[0]) + 1)
    return out


def param_specs(cfg: RecsysConfig) -> Dict[str, tuple]:
    """Every parameter's logical spec by ``flatten_params``' name: the
    reference's, in its (d_in, d_out) order for a linear ``w``."""
    shapes = _ref_shapes(cfg)
    depth = _depth(shapes)
    return {k: _logical(cfg.kind, k, depth) for k in shapes}


def _layout(kind: str, shapes: Dict[str, tuple], ctx: ShardingCtx
            ) -> Dict[str, tuple]:
    """Specs in the port's layout of leaves of the given port-layout
    shapes (``param_layout``)."""
    sizes = mesh_sizes(ctx.mesh)
    depth = _depth(shapes)
    out = {}
    for k, shape in shapes.items():
        w = _linear_w(k)
        spec = param_spec(_logical(kind, k, depth), ctx.rules,
                          shape[::-1] if w else shape, sizes)
        out[k] = spec[::-1] if w else spec
    return out


def param_layout(cfg: RecsysConfig, ctx: ShardingCtx) -> Dict[str, tuple]:
    """Each parameter's spec under ``ctx`` in the port's layout, by
    ``flatten_params``' name: the reference's logical spec through
    ``logical_to_spec`` (a mesh axis once a spec) and ``_safe`` (a dim the
    axes do not divide stays whole; ``distributed.sharding.param_spec``),
    on the reference's shape, then reversed for a linear ``w`` (``(d_out,
    d_in)`` here).  Under the default rules an MLP's first layer splits
    by columns (``mlp`` over ``model``), each later layer by rows (``(mlp,
    mlp)`` maps ``model`` once) with its bias split all the same;
    ``wq``/``wk``/``wv`` by columns, ``wo`` by rows; the tables by rows
    (``table_rows``, as ``row_sharded_leaves``)."""
    return _layout(cfg.kind, {k: v[::-1] if _linear_w(k) else v
                              for k, v in _ref_shapes(cfg).items()}, ctx)


def shard_groups(cfg: RecsysConfig, ctx: Optional[ShardingCtx]
                 ) -> Optional[Dict[str, tuple]]:
    """For the clip's norm (``optim.optimizers.global_norm(shards=)``):
    each leaf's process group a dim, None where whole; None with no
    mesh."""
    if ctx is None or ctx.mesh is None:
        return None
    return {k: spec_groups(v, ctx) for k, v in param_layout(cfg, ctx).items()}


def _tp(cfg: RecsysConfig, ctx: Optional[ShardingCtx]):
    """(the model group, ``param_layout``) where the mesh's ``model`` axis
    holds more than one rank, else (None, None)."""
    if ctx is None or ctx.mesh is None \
            or "model" not in ctx.mesh.mesh_dim_names \
            or ctx.size("model") == 1:
        return None, None
    return ctx.group("model"), param_layout(cfg, ctx)


def _at(tree, name: str):
    """The node of a tree at a dotted path's parent, and the last key."""
    *path, last = name.split(".")
    for p in path:
        tree = tree[int(p)] if isinstance(tree, list) else tree[p]
    return tree, (int(last) if isinstance(tree, list) else last)


def shard_dense(params: Params, kind: str,
                ctx: Optional[ShardingCtx]) -> Params:
    """A ``kind`` tree (whole but for the row-sharded leaves, which hold
    their rows already) with every other leaf cut to this rank's block
    under ``param_layout``, in place of the whole one."""
    if ctx is None or ctx.mesh is None:
        return params
    flat = flatten_params(params)
    rows = ROW_SHARDED[kind]
    lay = _layout(kind, {k: tuple(t.shape) for k, t in flat.items()}, ctx)
    for k, t in flat.items():
        if k.split(".")[0] not in rows and any(lay[k]):
            node, key = _at(params, k)
            node[key] = shard_of(t, lay[k], ctx)
    return params


def _on(spec: tuple, dim: int) -> bool:
    s = spec[dim]
    return s is not None and "model" in ((s,) if isinstance(s, str) else s)


def _linear_tp(p: Params, x: torch.Tensor, split_in: bool, sw: tuple,
               sb: tuple, group) -> Tuple[torch.Tensor, bool]:
    """One linear layer ``x @ w^T + b`` (two roundings, as
    ``nn.linear_apply``) on this rank's shards, ``sw``/``sb`` their specs
    (port layout); ``split_in``: ``x`` is this rank's block of columns.
    Returns (y, whether y is this rank's block of columns).  Split by
    columns: the input enters the split products (``enter_split``), the
    bias is the rank's block.  Split by rows: a whole input gives the
    rank its columns (``split_of``); the partial sums leave summed over
    the group in f32 (``nn.mm_f32``, ``leave_split``) and round once; the
    bias, split by the reference's spec but added to a whole output, is
    gathered (``gather_split``).  A split input meets a layer split by
    rows: the reference's specs split a layer's input dim wherever they
    split the dim before it."""
    if split_in and not _on(sw, 1):
        raise ValueError(f"a split input into a layer laid out {sw}")
    b = p["b"]
    if _on(sw, 0):
        return nn.linear_apply(p, C.enter_split(x, group)), True
    if _on(sb, 0):
        b = C.gather_split(b, 0, group)
    if _on(sw, 1):
        if not split_in:
            x = C.split_of(x, -1, group)
        y = C.leave_split(nn.mm_f32(x, p["w"].to(x.dtype).t()), group)
        return y.to(x.dtype) + b.to(x.dtype), False
    return nn.linear_apply({"w": p["w"], "b": b}, x), False


def _mlp(layers, x: torch.Tensor, name: str, group, lay, *, act=F.relu,
         final_act=None) -> torch.Tensor:
    """``nn.mlp_apply`` of the MLP ``name``, under tensor parallelism
    (``group``) layer by layer through ``_linear_tp``; the output
    whole."""
    if group is None:
        return nn.mlp_apply(layers, x, act=act, final_act=final_act)
    split = False
    for i, p in enumerate(layers):
        x, split = _linear_tp(p, x, split, lay[f"{name}.{i}.w"],
                              lay[f"{name}.{i}.b"], group)
        if i < len(layers) - 1:
            x = act(x)
        elif final_act is not None:
            x = final_act(x)
    return C.gather_split(x, -1, group) if split else x


# ---------------------------------------------------------------------------
# DLRM  [arXiv:1906.00091]
# ---------------------------------------------------------------------------

def dlrm_init(cfg: RecsysConfig, *, generator: Optional[torch.Generator]
              = None, device=None, ctx: Optional[ShardingCtx] = None
              ) -> Params:
    """Under a ``ctx`` that shards rows, ``tables`` holds this rank's
    rows, equal to those rows of the one-process init."""
    g, dev = _init_ctx(generator, device)
    dtype = DTYPES[cfg.param_dtype]
    tbl = _tables_init(g, (cfg.n_sparse, cfg.default_vocab, cfg.embed_dim),
                       dtype, dev, shard_rows(ctx, cfg.default_vocab))
    bot = nn.mlp_init(g, [cfg.n_dense, *cfg.bot_mlp], dtype=dtype,
                      device=dev)
    n_vec = cfg.n_sparse + 1
    d_inter = n_vec * (n_vec - 1) // 2 + cfg.bot_mlp[-1]
    top = nn.mlp_init(g, [d_inter, *cfg.top_mlp], dtype=dtype, device=dev)
    return shard_dense({"tables": tbl, "bot": bot, "top": top}, cfg.kind,
                       ctx)


def dlrm_forward(params: Params, cfg: RecsysConfig, dense: torch.Tensor,
                 sparse_ids: torch.Tensor,
                 ctx: Optional[ShardingCtx] = None) -> torch.Tensor:
    """Multi-hot bags (``sparse_ids`` (B, F, L)) go through
    ``_bag_lookup``, over row shards ``_bag_sharded``."""
    compute = DTYPES[cfg.dtype]
    if sparse_ids.dim() == 3:          # multi-hot bags
        emb = _bag_lookup(params["tables"], sparse_ids, compute, ctx,
                          cfg.default_vocab)
    else:
        emb = _lookup_simple(params["tables"], sparse_ids, compute, ctx,
                             cfg.default_vocab)
    group, lay = _tp(cfg, ctx)
    bot = _mlp(params["bot"], dense.to(compute), "bot", group, lay,
               final_act=F.relu)                                  # (B, D)
    vecs = torch.cat([bot[:, None, :], emb], dim=1)               # (B, F+1, D)
    # dot interaction: upper triangle of the (F+1)x(F+1) gram matrix
    gram = torch.einsum("bfd,bgd->bfg", vecs, vecs)
    n = vecs.shape[1]
    iu, ju = torch.triu_indices(n, n, 1, device=vecs.device)
    inter = gram[:, iu, ju]                                       # (B, nC2)
    x = torch.cat([bot, inter], dim=1)
    logit = _mlp(params["top"], x, "top", group, lay)
    return logit[:, 0]


# ---------------------------------------------------------------------------
# Wide & Deep  [arXiv:1606.07792]
# ---------------------------------------------------------------------------

def wide_deep_init(cfg: RecsysConfig, *, generator: Optional[
        torch.Generator] = None, device=None,
        ctx: Optional[ShardingCtx] = None) -> Params:
    """Under a ``ctx`` that shards rows, ``tables`` and ``wide`` hold this
    rank's rows."""
    g, dev = _init_ctx(generator, device)
    dtype = DTYPES[cfg.param_dtype]
    rows = shard_rows(ctx, cfg.default_vocab)
    tbl = _tables_init(g, (cfg.n_sparse, cfg.default_vocab, cfg.embed_dim),
                       dtype, dev, rows)
    wide = _tables_init(g, (cfg.n_sparse, cfg.default_vocab, 1), dtype, dev,
                        rows)
    deep = nn.mlp_init(g, [cfg.n_sparse * cfg.embed_dim, *cfg.bot_mlp, 1],
                       dtype=dtype, device=dev)
    return shard_dense({"tables": tbl, "wide": wide, "deep": deep},
                       cfg.kind, ctx)


def wide_deep_forward(params: Params, cfg: RecsysConfig, dense,
                      sparse_ids: torch.Tensor,
                      ctx: Optional[ShardingCtx] = None) -> torch.Tensor:
    compute, V = DTYPES[cfg.dtype], cfg.default_vocab
    emb = _lookup_simple(params["tables"], sparse_ids, compute, ctx, V)
    deep_in = emb.reshape(emb.shape[0], -1)               # concat interaction
    deep = _mlp(params["deep"], deep_in, "deep", *_tp(cfg, ctx))[:, 0]
    # wide: sum of per-field scalar weights (an embedding of dim 1)
    wide_e = _lookup_simple(params["wide"], sparse_ids, compute, ctx, V)
    wide = torch.sum(wide_e[..., 0], dim=1)
    return deep + wide


# ---------------------------------------------------------------------------
# small transformer encoder shared by sasrec / bst
# ---------------------------------------------------------------------------

def _tx_block_init(generator: torch.Generator, d: int, n_heads: int,
                   d_ff: int, dtype: torch.dtype, device) -> Params:
    hd = max(d // n_heads, 1)
    init = nn.lecun_normal             # variance_scaling(1, fan_in, normal)
    p = {"wq": init(generator, (d, n_heads * hd), dtype, device=device),
         "wk": init(generator, (d, n_heads * hd), dtype, device=device),
         "wv": init(generator, (d, n_heads * hd), dtype, device=device),
         "wo": init(generator, (n_heads * hd, d), dtype, device=device),
         "ln1": torch.ones(d, dtype=dtype, device=device),
         "ln2": torch.ones(d, dtype=dtype, device=device)}
    p["ff1"], p["ff2"] = nn.mlp_init(generator, [d, d_ff, d], dtype=dtype,
                                     device=device, init=nn.xavier_uniform)
    return p


def _tx_block_apply(p: Params, x: torch.Tensor, n_heads: int,
                    causal: bool, group=None, lay=None) -> torch.Tensor:
    """Pre-norm block; bf16 rounds after every product, as in JAX.  Under
    tensor parallelism (``group``, ``lay`` the block's specs by leaf,
    ``wq`` ... ``ff2.b``): where ``wq`` is split by columns and the
    group divides the heads, a rank runs its heads (the input entering
    its split products) and ``wo`` by rows; where it splits within a head
    (sasrec at ``model`` 2), ``wq``/``wk``/``wv``'s columns are gathered
    (``gather_split``) and the attention runs whole, ``wo`` by rows on the
    rank's columns of it; ``ff1`` by columns, ``ff2`` by rows
    (``_linear_tp``).  The residual is whole on every rank."""
    B, S, d = x.shape
    hd = max(d // n_heads, 1)
    h = nn.rmsnorm_apply(p["ln1"], x)
    H, by_heads = n_heads, False
    w = {n: p[n] for n in ("wq", "wk", "wv")}
    if group is not None and _on(lay["wq"], 1):
        nm = C.group_size(group)
        if n_heads % nm == 0:
            H, by_heads = n_heads // nm, True
            h = C.enter_split(h, group)
        else:
            w = {n: C.gather_split(t, 1, group) for n, t in w.items()}
    q = (h @ w["wq"].to(x.dtype)).reshape(B, S, H, hd)
    k = (h @ w["wk"].to(x.dtype)).reshape(B, S, H, hd)
    v = (h @ w["wv"].to(x.dtype)).reshape(B, S, H, hd)
    s = torch.einsum("bshd,bthd->bhst", q, k).to(torch.float32) \
        * hd ** -0.5
    if causal:
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                     device=x.device))
        s = torch.where(mask[None, None], s, -1e30)
    att = torch.softmax(s, dim=-1).to(x.dtype)
    o = torch.einsum("bhst,bthd->bshd", att, v).reshape(B, S, H * hd)
    if group is not None and _on(lay["wo"], 0):
        if not by_heads:
            o = C.split_of(o, -1, group)
        x = x + C.leave_split(nn.mm_f32(o, p["wo"].to(x.dtype)),
                              group).to(x.dtype)
    else:
        x = x + o @ p["wo"].to(x.dtype)
    h = nn.rmsnorm_apply(p["ln2"], x)
    if group is None:
        h = F.relu(nn.linear_apply(p["ff1"], h))
        return x + nn.linear_apply(p["ff2"], h)
    h, split = _linear_tp(p["ff1"], h, False, lay["ff1.w"], lay["ff1.b"],
                          group)
    h, split = _linear_tp(p["ff2"], F.relu(h), split, lay["ff2.w"],
                          lay["ff2.b"], group)
    return x + (C.gather_split(h, -1, group) if split else h)


def _blocks(params: Params, cfg: RecsysConfig, x: torch.Tensor,
            causal: bool, ctx: Optional[ShardingCtx]) -> torch.Tensor:
    """The transformer blocks in turn, under ``ctx``'s tensor
    parallelism where it has any."""
    group, lay = _tp(cfg, ctx)
    for i, p in enumerate(params["blocks"]):
        bl = None if lay is None else {
            k[len(f"blocks.{i}."):]: v for k, v in lay.items()
            if k.startswith(f"blocks.{i}.")}
        x = _tx_block_apply(p, x, cfg.n_heads, causal, group, bl)
    return x


def _seq_embed(params: Params, cfg: RecsysConfig, seq: torch.Tensor,
               compute: torch.dtype,
               ctx: Optional[ShardingCtx] = None) -> torch.Tensor:
    """Item rows of a (B, S) sequence (-1 pad -> zero row) plus the
    position rows."""
    V = cfg.default_vocab
    x = take_rows(params["items"],
                  torch.remainder(torch.where(seq >= 0, seq, 0), V), compute,
                  ctx, V)
    x = x * (seq >= 0).to(compute)[..., None]
    return x + params["pos"].to(compute)[None, : x.shape[1]]


# ---------------------------------------------------------------------------
# SASRec  [arXiv:1808.09781]
# ---------------------------------------------------------------------------

def sasrec_init(cfg: RecsysConfig, *, generator: Optional[torch.Generator]
                = None, device=None,
                ctx: Optional[ShardingCtx] = None) -> Params:
    """Under a ``ctx`` that shards rows, ``items`` holds this rank's
    rows."""
    g, dev = _init_ctx(generator, device)
    dtype = DTYPES[cfg.param_dtype]
    d = cfg.embed_dim
    items = _tables_init(g, (cfg.default_vocab, d), dtype, dev,
                         shard_rows(ctx, cfg.default_vocab))
    pos = _tables_init(g, (cfg.seq_len, d), dtype, dev)
    blocks = [_tx_block_init(g, d, cfg.n_heads, 4 * d, dtype, dev)
              for _ in range(cfg.n_blocks)]
    return shard_dense({"items": items, "pos": pos, "blocks": blocks},
                       cfg.kind, ctx)


def sasrec_user_repr(params: Params, cfg: RecsysConfig,
                     seq_ids: torch.Tensor,
                     ctx: Optional[ShardingCtx] = None) -> torch.Tensor:
    """seq_ids (B, S) item history (-1 pad) -> (B, D) user representation
    (hidden state at the last position)."""
    x = _seq_embed(params, cfg, seq_ids, DTYPES[cfg.dtype], ctx)
    return _blocks(params, cfg, x, True, ctx)[:, -1]


def sasrec_scores(params: Params, cfg: RecsysConfig,
                  user_repr: torch.Tensor, cand_ids: torch.Tensor,
                  ctx: Optional[ShardingCtx] = None) -> torch.Tensor:
    """(B, D) x (N,) candidate ids -> (B, N) dot scores (retrieval)."""
    V = cfg.default_vocab
    cand = take_rows(params["items"], torch.remainder(cand_ids, V),
                     user_repr.dtype, ctx, V)
    return user_repr @ cand.T


# ---------------------------------------------------------------------------
# BST  [arXiv:1905.06874]
# ---------------------------------------------------------------------------

def bst_init(cfg: RecsysConfig, *, generator: Optional[torch.Generator]
             = None, device=None,
             ctx: Optional[ShardingCtx] = None) -> Params:
    """Under a ``ctx`` that shards rows, ``items`` and ``other`` hold this
    rank's rows."""
    g, dev = _init_ctx(generator, device)
    dtype = DTYPES[cfg.param_dtype]
    d = cfg.embed_dim
    rows = shard_rows(ctx, cfg.default_vocab)
    items = _tables_init(g, (cfg.default_vocab, d), dtype, dev, rows)
    pos = _tables_init(g, (cfg.seq_len + 1, d), dtype, dev)
    other = _tables_init(g, (cfg.n_sparse, cfg.default_vocab, d), dtype, dev,
                         rows)
    blocks = [_tx_block_init(g, d, cfg.n_heads, 4 * d, dtype, dev)
              for _ in range(cfg.n_blocks)]
    d_in = (cfg.seq_len + 1) * d + cfg.n_sparse * d
    mlp = nn.mlp_init(g, [d_in, *cfg.top_mlp], dtype=dtype, device=dev)
    return shard_dense({"items": items, "pos": pos, "other": other,
                        "blocks": blocks, "mlp": mlp}, cfg.kind, ctx)


def bst_forward(params: Params, cfg: RecsysConfig, seq_ids: torch.Tensor,
                target_id: torch.Tensor, other_ids: torch.Tensor,
                ctx: Optional[ShardingCtx] = None) -> torch.Tensor:
    """Behavior sequence (B, S) + target item (B,) + profile fields
    (B, F) -> CTR logit (B,)."""
    compute = DTYPES[cfg.dtype]
    B = seq_ids.shape[0]
    x = _seq_embed(params, cfg,
                   torch.cat([seq_ids, target_id[:, None]], dim=1), compute,
                   ctx)
    x = _blocks(params, cfg, x, False, ctx)
    other = _lookup_simple(params["other"], other_ids, compute, ctx,
                           cfg.default_vocab)
    feats = torch.cat([x.reshape(B, -1), other.reshape(B, -1)], dim=1)
    logit = _mlp(params["mlp"], feats, "mlp", *_tp(cfg, ctx))
    return logit[:, 0]


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    l32 = logits.to(torch.float32)
    return torch.mean(torch.clamp_min(l32, 0) - l32 * labels
                      + torch.log1p(torch.exp(-torch.abs(l32))))


def sasrec_loss(params: Params, cfg: RecsysConfig, seq_ids: torch.Tensor,
                pos_ids: torch.Tensor, neg_ids: torch.Tensor,
                ctx: Optional[ShardingCtx] = None) -> torch.Tensor:
    """Sampled softmax: the positive next item against the negatives."""
    u = sasrec_user_repr(params, cfg, seq_ids, ctx)
    V = cfg.default_vocab
    pos = take_rows(params["items"], torch.remainder(pos_ids, V), u.dtype,
                    ctx, V)
    neg = take_rows(params["items"], torch.remainder(neg_ids, V), u.dtype,
                    ctx, V)
    s_pos = torch.sum(u * pos, dim=-1, keepdim=True)           # (B, 1)
    s_neg = torch.einsum("bd,bnd->bn", u, neg)                 # (B, N)
    logits = torch.cat([s_pos, s_neg], dim=1).to(torch.float32)
    return -torch.mean(torch.log_softmax(logits, dim=-1)[:, 0])


INITS = {"dlrm": dlrm_init, "wide_deep": wide_deep_init,
         "sasrec": sasrec_init, "bst": bst_init}


def init_params(cfg: RecsysConfig, *, generator: Optional[torch.Generator]
                = None, device=None,
                ctx: Optional[ShardingCtx] = None) -> Params:
    """The parameter tree of ``cfg.kind``; under a ``ctx`` that shards
    rows, each of ``row_sharded_leaves(cfg, ctx)`` holds this rank's rows,
    equal to those rows of the one-process init."""
    return INITS[cfg.kind](cfg, generator=generator, device=device, ctx=ctx)
