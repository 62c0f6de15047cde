"""RecSys architecture family: dlrm-rm2, wide-deep, sasrec, bst, as
``repro/models/recsys/models.py`` (single-device half).

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

``dlrm_init``, ``dlrm_forward``, the recsys train and serve steps and
``run_recsys`` take a ``ShardingCtx`` (``ctx=None``: one process).
Under a mesh with a ``"model"`` axis of ``nm > 1`` ranks, a vocabulary
``V`` that ``nm`` divides and ``rules["table_rows"] == "model"`` (the
reference's dispatch, ``row_shards``), each rank of the model axis holds
rows ``[mi*V/nm, (mi+1)*V/nm)`` of every field's table, and the lookup
is ``_lookup_sharded``: each rank gathers the rows it owns (zeros for
the rest), the batch is padded to the data axes and split over them as
the reference does, the model group sums, and the data group gathers
the blocks back, so every rank holds the whole batch's rows, bitwise
the local gather (``x + 0 == x``).  Its backward (``_RowShardLookup``)
gives each rank's shard the gradient of the rows it owns, from the
whole batch.

Departures: a rank's tensor holds only its rows, so the lookup is told
the table's whole row count (``vocab``; by default the tensor's own,
the table whole).  The reference's ``REPRO_BASELINE`` switch to the
local gather is not read.  The model runs replicated on every rank
around the lookup (the port has no GSPMD), so the gradient coming into
the lookup is the same on every rank and the dense parameters'
gradients are whole on every rank.  Only ``dlrm`` takes a sharding
context; wide-deep, sasrec and bst raise under one that shards rows.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import RecsysConfig
from repro_torch.distributed.sharding import ShardingCtx, mesh_sizes
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.embedding_bag.ops import embedding_bag
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
    """An embedding table (or stack of them), N(0, 1) * 0.01, drawn in
    place one field at a time (no temporary the size of the tables).
    ``rows``: keep only these rows of each field's table (a stack's dim
    1), each field drawn whole first, so the rows equal the whole
    table's."""
    if rows is None:
        out = torch.empty(shape, dtype=dtype, device=device)
        for part in (out if out.dim() == 3 else [out]):
            part.normal_(0.0, 1.0, generator=generator).mul_(0.01)
        return out
    F_, V, D = shape
    out = torch.empty((F_, rows.stop - rows.start, D), dtype=dtype,
                      device=device)
    for f in range(F_):
        whole = torch.empty((V, D), dtype=dtype, device=device)
        whole.normal_(0.0, 1.0, generator=generator).mul_(0.01)
        out[f] = whole[rows]
        del whole
    return out


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


def _lookup_local(tables: torch.Tensor, ids: torch.Tensor,
                  compute: torch.dtype) -> torch.Tensor:
    """Per-field gather: tables (F, V, D), ids (B, F) -> (B, F, D) in
    ``compute``; ids are taken mod V (floor semantics, as JAX's ``%``)."""
    n_fields, V, D = tables.shape
    offs = torch.arange(n_fields, device=ids.device)[None, :] * V
    flat = offs + torch.remainder(ids, V)
    return tables.reshape(-1, D)[flat].to(compute)


class _RowShardLookup(torch.autograd.Function):
    """Forward: the whole batch's rows from row-sharded tables (see
    ``_lookup_sharded``).  Backward: this rank's shard gets the gradient
    of the rows it owns, summed over the whole batch from the incoming
    gradient (the same on every rank), as the local gather's gradient
    restricted to the shard; no communication."""

    @staticmethod
    def forward(ctx_, tables, ids, sctx, compute):
        F_, v_loc, D = tables.shape
        sizes = mesh_sizes(sctx.mesh)
        nm = sizes["model"]
        V = v_loc * nm
        mi = sctx.axis_index("model")
        dp_axes = tuple(a for a in ("pod", "data") if a in sizes)
        dp = math.prod(sizes[a] for a in dp_axes)
        n = ids.shape[0]
        pad = (-n) % max(dp, 1)
        if pad:  # e.g. a single request's short id list vs 16 DP shards
            ids = torch.cat([ids, ids.new_zeros((pad, ids.shape[1]))])
        b = ids.shape[0] // dp
        di = sctx.axis_index(dp_axes) if dp > 1 else 0
        blk = ids[di * b:(di + 1) * b]
        rel = torch.remainder(blk, V) - mi * v_loc            # (b, F)
        ok = (rel >= 0) & (rel < v_loc)
        safe = torch.clamp(rel, 0, v_loc - 1)
        flat = torch.arange(F_, device=ids.device)[None, :] * v_loc + safe
        rows = tables.reshape(F_ * v_loc, D)[flat]
        rows = rows * ok[..., None].to(rows.dtype)
        dist.all_reduce(rows, group=sctx.group("model"))
        if dp > 1:
            parts = [torch.empty_like(rows) for _ in range(dp)]
            dist.all_gather(parts, rows, group=sctx.group(dp_axes))
            rows = torch.cat(parts)
        ctx_.save_for_backward(ids[:n])
        ctx_.meta = (tables.shape, tables.dtype, mi, V)
        return rows[:n].to(compute)

    @staticmethod
    def backward(ctx_, g):
        (ids,) = ctx_.saved_tensors
        (F_, v_loc, D), dtype, mi, V = ctx_.meta
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
    if tables.shape[1] * nm != V:
        raise ValueError(f"a table of {V} rows over {nm} row shards: "
                         f"expected {V // nm} rows here, got "
                         f"{tables.shape[1]}")
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


def _bag_lookup(tables: torch.Tensor, ids: torch.Tensor,
                compute: torch.dtype) -> torch.Tensor:
    """Multi-hot bags: tables (F, V, D), ids (B, F, L) (-1 pad) ->
    (B, F, D) in ``compute``, through the EmbeddingBag op (sum)."""
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
    return {"tables": tbl, "bot": bot, "top": top}


def dlrm_forward(params: Params, cfg: RecsysConfig, dense: torch.Tensor,
                 sparse_ids: torch.Tensor,
                 ctx: Optional[ShardingCtx] = None) -> torch.Tensor:
    """Multi-hot bags stay local (``_bag_lookup``), as in the
    reference."""
    compute = DTYPES[cfg.dtype]
    if sparse_ids.dim() == 3:          # multi-hot bags
        if row_shards(ctx, cfg.default_vocab) > 1:
            raise NotImplementedError("multi-hot bags over row-sharded "
                                      "tables: the reference's bag lookup "
                                      "is local")
        emb = _bag_lookup(params["tables"], sparse_ids, compute)
    else:
        emb = _lookup_simple(params["tables"], sparse_ids, compute, ctx,
                             cfg.default_vocab)
    bot = nn.mlp_apply(params["bot"], dense.to(compute), act=F.relu,
                       final_act=F.relu)                          # (B, D)
    vecs = torch.cat([bot[:, None, :], emb], dim=1)               # (B, F+1, D)
    # dot interaction: upper triangle of the (F+1)x(F+1) gram matrix
    gram = torch.einsum("bfd,bgd->bfg", vecs, vecs)
    n = vecs.shape[1]
    iu, ju = torch.triu_indices(n, n, 1, device=vecs.device)
    inter = gram[:, iu, ju]                                       # (B, nC2)
    x = torch.cat([bot, inter], dim=1)
    logit = nn.mlp_apply(params["top"], x, act=F.relu)
    return logit[:, 0]


# ---------------------------------------------------------------------------
# Wide & Deep  [arXiv:1606.07792]
# ---------------------------------------------------------------------------

def wide_deep_init(cfg: RecsysConfig, *, generator: Optional[
        torch.Generator] = None, device=None) -> Params:
    g, dev = _init_ctx(generator, device)
    dtype = DTYPES[cfg.param_dtype]
    tbl = _tables_init(g, (cfg.n_sparse, cfg.default_vocab, cfg.embed_dim),
                       dtype, dev)
    wide = _tables_init(g, (cfg.n_sparse, cfg.default_vocab, 1), dtype, dev)
    deep = nn.mlp_init(g, [cfg.n_sparse * cfg.embed_dim, *cfg.bot_mlp, 1],
                       dtype=dtype, device=dev)
    return {"tables": tbl, "wide": wide, "deep": deep}


def wide_deep_forward(params: Params, cfg: RecsysConfig, dense,
                      sparse_ids: torch.Tensor) -> torch.Tensor:
    compute = DTYPES[cfg.dtype]
    emb = _lookup_simple(params["tables"], sparse_ids, compute)
    deep_in = emb.reshape(emb.shape[0], -1)               # concat interaction
    deep = nn.mlp_apply(params["deep"], deep_in, act=F.relu)[:, 0]
    # wide: sum of per-field scalar weights (an embedding of dim 1)
    wide_e = _lookup_simple(params["wide"], sparse_ids, compute)
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
                    causal: bool) -> torch.Tensor:
    """Pre-norm block; bf16 rounds after every product, as in JAX."""
    B, S, d = x.shape
    hd = max(d // n_heads, 1)
    h = nn.rmsnorm_apply(p["ln1"], x)
    q = (h @ p["wq"].to(x.dtype)).reshape(B, S, n_heads, hd)
    k = (h @ p["wk"].to(x.dtype)).reshape(B, S, n_heads, hd)
    v = (h @ p["wv"].to(x.dtype)).reshape(B, S, n_heads, hd)
    s = torch.einsum("bshd,bthd->bhst", q, k).to(torch.float32) \
        * hd ** -0.5
    if causal:
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                     device=x.device))
        s = torch.where(mask[None, None], s, -1e30)
    att = torch.softmax(s, dim=-1).to(x.dtype)
    o = torch.einsum("bhst,bthd->bshd", att, v).reshape(B, S, n_heads * hd)
    x = x + o @ p["wo"].to(x.dtype)
    h = nn.rmsnorm_apply(p["ln2"], x)
    h = F.relu(nn.linear_apply(p["ff1"], h))
    return x + nn.linear_apply(p["ff2"], h)


def _seq_embed(params: Params, seq: torch.Tensor,
               compute: torch.dtype) -> torch.Tensor:
    """Item rows of a (B, S) sequence (-1 pad -> zero row) plus the
    position rows."""
    V = params["items"].shape[0]
    x = take_rows(params["items"],
                  torch.remainder(torch.where(seq >= 0, seq, 0), V), compute)
    x = x * (seq >= 0).to(compute)[..., None]
    return x + params["pos"].to(compute)[None, : x.shape[1]]


# ---------------------------------------------------------------------------
# SASRec  [arXiv:1808.09781]
# ---------------------------------------------------------------------------

def sasrec_init(cfg: RecsysConfig, *, generator: Optional[torch.Generator]
                = None, device=None) -> Params:
    g, dev = _init_ctx(generator, device)
    dtype = DTYPES[cfg.param_dtype]
    d = cfg.embed_dim
    items = _tables_init(g, (cfg.default_vocab, d), dtype, dev)
    pos = _tables_init(g, (cfg.seq_len, d), dtype, dev)
    blocks = [_tx_block_init(g, d, cfg.n_heads, 4 * d, dtype, dev)
              for _ in range(cfg.n_blocks)]
    return {"items": items, "pos": pos, "blocks": blocks}


def sasrec_user_repr(params: Params, cfg: RecsysConfig,
                     seq_ids: torch.Tensor) -> torch.Tensor:
    """seq_ids (B, S) item history (-1 pad) -> (B, D) user representation
    (hidden state at the last position)."""
    x = _seq_embed(params, seq_ids, DTYPES[cfg.dtype])
    for p in params["blocks"]:
        x = _tx_block_apply(p, x, cfg.n_heads, causal=True)
    return x[:, -1]


def sasrec_scores(params: Params, cfg: RecsysConfig,
                  user_repr: torch.Tensor, cand_ids: torch.Tensor
                  ) -> torch.Tensor:
    """(B, D) x (N,) candidate ids -> (B, N) dot scores (retrieval)."""
    V = params["items"].shape[0]
    cand = take_rows(params["items"], torch.remainder(cand_ids, V),
                     user_repr.dtype)
    return user_repr @ cand.T


# ---------------------------------------------------------------------------
# BST  [arXiv:1905.06874]
# ---------------------------------------------------------------------------

def bst_init(cfg: RecsysConfig, *, generator: Optional[torch.Generator]
             = None, device=None) -> Params:
    g, dev = _init_ctx(generator, device)
    dtype = DTYPES[cfg.param_dtype]
    d = cfg.embed_dim
    items = _tables_init(g, (cfg.default_vocab, d), dtype, dev)
    pos = _tables_init(g, (cfg.seq_len + 1, d), dtype, dev)
    other = _tables_init(g, (cfg.n_sparse, cfg.default_vocab, d), dtype, dev)
    blocks = [_tx_block_init(g, d, cfg.n_heads, 4 * d, dtype, dev)
              for _ in range(cfg.n_blocks)]
    d_in = (cfg.seq_len + 1) * d + cfg.n_sparse * d
    mlp = nn.mlp_init(g, [d_in, *cfg.top_mlp], dtype=dtype, device=dev)
    return {"items": items, "pos": pos, "other": other, "blocks": blocks,
            "mlp": mlp}


def bst_forward(params: Params, cfg: RecsysConfig, seq_ids: torch.Tensor,
                target_id: torch.Tensor, other_ids: torch.Tensor
                ) -> torch.Tensor:
    """Behavior sequence (B, S) + target item (B,) + profile fields
    (B, F) -> CTR logit (B,)."""
    compute = DTYPES[cfg.dtype]
    B = seq_ids.shape[0]
    x = _seq_embed(params, torch.cat([seq_ids, target_id[:, None]], dim=1),
                   compute)
    for p in params["blocks"]:
        x = _tx_block_apply(p, x, cfg.n_heads, causal=False)
    other = _lookup_simple(params["other"], other_ids, compute)
    feats = torch.cat([x.reshape(B, -1), other.reshape(B, -1)], dim=1)
    logit = nn.mlp_apply(params["mlp"], feats, act=F.relu)
    return logit[:, 0]


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    l32 = logits.to(torch.float32)
    return torch.mean(torch.clamp_min(l32, 0) - l32 * labels
                      + torch.log1p(torch.exp(-torch.abs(l32))))


def sasrec_loss(params: Params, cfg: RecsysConfig, seq_ids: torch.Tensor,
                pos_ids: torch.Tensor, neg_ids: torch.Tensor
                ) -> torch.Tensor:
    """Sampled softmax: the positive next item against the negatives."""
    u = sasrec_user_repr(params, cfg, seq_ids)
    V = params["items"].shape[0]
    pos = take_rows(params["items"], torch.remainder(pos_ids, V), u.dtype)
    neg = take_rows(params["items"], torch.remainder(neg_ids, V), u.dtype)
    s_pos = torch.sum(u * pos, dim=-1, keepdim=True)           # (B, 1)
    s_neg = torch.einsum("bd,bnd->bn", u, neg)                 # (B, N)
    logits = torch.cat([s_pos, s_neg], dim=1).to(torch.float32)
    return -torch.mean(torch.log_softmax(logits, dim=-1)[:, 0])


INITS = {"dlrm": dlrm_init, "wide_deep": wide_deep_init,
         "sasrec": sasrec_init, "bst": bst_init}


def check_ctx(cfg: RecsysConfig, ctx: Optional[ShardingCtx]) -> None:
    """Raise where ``ctx`` shards rows for a kind other than dlrm."""
    if cfg.kind != "dlrm" and row_shards(ctx, cfg.default_vocab) > 1:
        raise NotImplementedError(f"row-sharded tables for {cfg.kind}: "
                                  f"only dlrm takes a sharding context")


def init_params(cfg: RecsysConfig, *, generator: Optional[torch.Generator]
                = None, device=None,
                ctx: Optional[ShardingCtx] = None) -> Params:
    """The parameter tree of ``cfg.kind``; dlrm's tables row-sharded
    under ``ctx`` (see ``dlrm_init``)."""
    check_ctx(cfg, ctx)
    if cfg.kind == "dlrm":
        return dlrm_init(cfg, generator=generator, device=device, ctx=ctx)
    return INITS[cfg.kind](cfg, generator=generator, device=device)
