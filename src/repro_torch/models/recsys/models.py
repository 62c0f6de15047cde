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

On one card every lookup takes the local gather; the JAX package's
``_lookup_sharded`` (row-sharded tables over a model axis) waits for
the port of ``distributed/``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import RecsysConfig
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
                 device) -> torch.Tensor:
    """An embedding table (or stack of them), N(0, 1) * 0.01, drawn in
    place one field at a time (no temporary the size of the tables)."""
    out = torch.empty(shape, dtype=dtype, device=device)
    for part in (out if out.dim() == 3 else [out]):
        part.normal_(0.0, 1.0, generator=generator).mul_(0.01)
    return out


def _lookup_local(tables: torch.Tensor, ids: torch.Tensor,
                  compute: torch.dtype) -> torch.Tensor:
    """Per-field gather: tables (F, V, D), ids (B, F) -> (B, F, D) in
    ``compute``; ids are taken mod V (floor semantics, as JAX's ``%``)."""
    n_fields, V, D = tables.shape
    offs = torch.arange(n_fields, device=ids.device)[None, :] * V
    flat = offs + torch.remainder(ids, V)
    return tables.reshape(-1, D)[flat].to(compute)


def _lookup_simple(tables: torch.Tensor, ids: torch.Tensor,
                   compute: torch.dtype) -> torch.Tensor:
    """Embedding lookup; on one card always the local gather."""
    return _lookup_local(tables, ids, compute)


def take_rows(table: torch.Tensor, ids: torch.Tensor,
              compute: Optional[torch.dtype] = None) -> torch.Tensor:
    """(V, D) table row gather, ids any shape, in ``compute`` (default:
    the table's type).  Callers sanitize negative ids (padding)."""
    shape = ids.shape
    out = _lookup_simple(table[None], ids.reshape(-1, 1),
                         compute or table.dtype)
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
              = None, device=None) -> Params:
    g, dev = _init_ctx(generator, device)
    dtype = DTYPES[cfg.param_dtype]
    tbl = _tables_init(g, (cfg.n_sparse, cfg.default_vocab, cfg.embed_dim),
                       dtype, dev)
    bot = nn.mlp_init(g, [cfg.n_dense, *cfg.bot_mlp], dtype=dtype,
                      device=dev)
    n_vec = cfg.n_sparse + 1
    d_inter = n_vec * (n_vec - 1) // 2 + cfg.bot_mlp[-1]
    top = nn.mlp_init(g, [d_inter, *cfg.top_mlp], dtype=dtype, device=dev)
    return {"tables": tbl, "bot": bot, "top": top}


def dlrm_forward(params: Params, cfg: RecsysConfig, dense: torch.Tensor,
                 sparse_ids: torch.Tensor) -> torch.Tensor:
    compute = DTYPES[cfg.dtype]
    if sparse_ids.dim() == 3:          # multi-hot bags
        emb = _bag_lookup(params["tables"], sparse_ids, compute)
    else:
        emb = _lookup_simple(params["tables"], sparse_ids, compute)
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


def init_params(cfg: RecsysConfig, *, generator: Optional[torch.Generator]
                = None, device=None) -> Params:
    """The parameter tree of ``cfg.kind``."""
    return INITS[cfg.kind](cfg, generator=generator, device=device)
