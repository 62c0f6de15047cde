"""RankGraph-2 training step (paper §4.3 + §4.4 co-learning) and
embedding generation, as ``repro/core/trainer.py``.

One ``train_step`` consumes a batch of all edge types in one of the
three layouts of ``data.edge_dataset.BATCH_FORMATS``: ``dedup_ids``
(id-only packs: every referenced node is encoded once from the
device-resident ``FeatureStore``, endpoints are aggregated once, per-edge
views are gathers), ``dedup`` (the same packs carrying their rows'
features, no store needed) or ``legacy`` (per-(edge type, side) feature
tensors: every endpoint is encoded again, ``model.embed_side``).  The
three give the same losses on the same draws up to the order of float
sums; ``dedup`` and ``dedup_ids`` are the same arithmetic.  It computes
the contrastive losses of every direction (U-I both ways) through the
``fused_contrastive`` op, co-learns the RQ index on all endpoint
primaries (reconstruction, contrastive on the reconstruction, balance
regularizer, utilization gap), combines everything with learned
uncertainty weights,
clips, and applies the partitioned AdaGrad/AdamW update.  The step is
two halves, ``make_grad_step`` (forward, backward and the data-parallel
reduction of the gradients) and ``apply_grads`` (clip, update, pool and
RQ state); a caller that needs the gradients or the RQ selections runs
them itself.

Unlike the JAX package's pure step, the port updates the state in
place: the parameters, optimizer moments, RQ histograms and pool are
rewritten where they lie, so no second copy of the state is held.  The
eval step (``make_eval_step``) and the dead-code reset
(``reset_dead_codes``, which writes re-seeded codebook rows into the
live parameters) follow the same rule.

Data-parallel training (``make_train_step(cfg, opt, ctx)`` with a mesh
whose ``"batch"`` axes have ``dp > 1`` ranks) is manual SPMD, with the
values of the JAX package's global step under a ``ShardingCtx`` of the
same ``dp`` (GSPMD's batch sharding and shard-local negatives): every
rank holds the whole batch, keeps rows ``r*B/dp`` to ``(r+1)*B/dp - 1``
of each edge type (``rank_batch``: its own dedup pack, so the encoder's
work divides across ranks) and draws its negatives inside that block.
What the global step takes over the whole batch is reduced across the
data group: the task losses' means, the RQ batch statistics, the pool
insert (the blocks' embeddings gathered in global row order) and the
gradients, before clipping.  The log-variances enter only through the
reduced task losses, so every rank already holds their whole gradient:
they are not summed again.  After the step every rank holds the same
state.  Where ``dp`` does not divide an edge type's ``B`` the reference
falls back to whole-batch negatives, which GSPMD gathers across shards.
The port does the same: rank ``r`` then keeps rows
``r*c`` to ``min(B, (r+1)*c) - 1``, ``c = ceil(B/dp)``
(``collectives.block_rows``: the last ranks hold fewer, possibly none),
and gathers the whole batch's destination rows of that type
(``collectives.gather_blocks``, whose backward returns each row's
gradient, summed over the ranks, to the rank that owns it) to build its
own rows' banks from them (``negatives.sample_negatives(rows=)``); each
task loss is every rank's sum over the global ``B``, never a mean of the
ranks' means.  A rank with no rows of a type runs the same collectives
on empty blocks (the contrastive kernels launch nothing at zero rows),
so every rank takes part in every exchange.

Under a ``(data, model)`` mesh the model axis adds tensor parallelism
(``core/model.py``: the encoders' hidden layer over ``mlp``, the
aggregators over ``heads``; ``shard_state`` cuts a whole state to a
rank's shards).  The data group works as above and ``rank_batch``
reads the data index, so the ranks of a model group hold the same rows
and compute the same losses; a split leaf's gradient is its block's,
reduced over the data group only, and the clip's norm counts each split
leaf once over its group (``StepGrads.shards``).  Everything after the
aggregators is the same on every rank of a model group, so after a step
the replicated state (RQ codebooks, histograms, pool, log-variances) is
bitwise equal across ranks.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import RankGraph2Config
from repro_torch.core import losses as L
from repro_torch.core import model as M
from repro_torch.core import negatives as N
from repro_torch.core import rq_index as RQ
from repro_torch.distributed.collectives import (block_rows, gather_blocks,
                                                 gather_rows, reduce_grads_,
                                                 sum_across)
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.kernels.common import resolve_device
from repro_torch.optim import optimizers as opt_lib


@dataclasses.dataclass
class TrainState:
    params: torch.nn.ModuleDict      # f_*, agg_*, rq, uncertainty
    opt_state: Any
    rq_state: RQ.RQState
    pool: N.NegPoolState
    step: int = 0


@dataclasses.dataclass(frozen=True)
class FeatureStore:
    """Device-resident raw feature tables that id-only batches index."""
    user_feat: torch.Tensor     # (n_users, d_user_feat) float32
    item_feat: torch.Tensor     # (n_items, d_item_feat) float32


def named_params(params: torch.nn.ModuleDict) -> Dict[str, torch.Tensor]:
    return dict(params.named_parameters())


def init_state(cfg: RankGraph2Config, *, generator: torch.Generator,
               pool_size: int = 8192,
               optimizer: Optional[opt_lib.Optimizer] = None, device=None
               ) -> Tuple[TrainState, opt_lib.Optimizer]:
    """Fresh parameters (encoders and aggregators, then RQ codebooks,
    drawn from ``generator``), zero log-variances, empty RQ histograms
    and pool, on ``device``, with gradients on."""
    dev = resolve_device(device)
    params = M.init_params(cfg, generator=generator, device=dev)
    params["rq"] = RQ.init_rq(cfg.rq, cfg.d_embed, generator=generator,
                              device=dev)
    params["uncertainty"] = L.init_uncertainty(device=dev)
    params.requires_grad_(True)
    optimizer = optimizer or opt_lib.rankgraph2_optimizer()
    state = TrainState(params, optimizer.init(named_params(params)),
                       RQ.init_rq_state(cfg.rq, dev),
                       N.init_pool(pool_size, cfg.d_embed, device=dev))
    return state, optimizer


def shard_state(state: TrainState, cfg: RankGraph2Config,
                ctx: Optional[ShardingCtx]) -> TrainState:
    """``state`` (whole) with its split parameters and their optimizer
    moments cut to this rank's blocks under ``ctx``
    (``model.param_layout``), in place; returns ``state``."""
    lay = M.param_layout(cfg, ctx)
    if not any(any(s is not None for s in v) for v in lay.values()):
        return state
    M.shard_params(state.params, cfg, ctx)

    def cut(tree):
        if isinstance(tree, opt_lib.AdamState):
            return opt_lib.AdamState(cut(tree.mu), cut(tree.nu), tree.count)
        if isinstance(tree, dict):
            return {k: M.shard_tensor(k, v, cfg, ctx)
                    if isinstance(v, torch.Tensor) and k in lay else cut(v)
                    for k, v in tree.items()}
        return tree
    state.opt_state = cut(state.opt_state)
    return state


# edge type -> (src node type, dst node type)
_ET_TYPES = {"uu": (M.USER, M.USER), "ui": (M.USER, M.ITEM),
             "ii": (M.ITEM, M.ITEM)}
_NODE_TYPES = (("user", M.USER), ("item", M.ITEM))


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take(x, idx, axis=0)`` for an index of any shape."""
    return x.index_select(0, idx.reshape(-1)).reshape(
        *idx.shape, *x.shape[1:])


def _dedup_per_type(params, cfg: RankGraph2Config, batch,
                    features: Optional[FeatureStore],
                    ctx: Optional[ShardingCtx] = None):
    """Unique-node forward: encode each pack row once (its ``feat``, or
    its ``ids``' rows of ``features``), aggregate each endpoint-unique
    node once, gather per-(edge_type, side) views.  Returns {et:
    (src_heads, src_prim, dst_heads, dst_prim)} with the edge types in
    sorted order, as the JAX step iterates them (a jitted function
    receives a dict with its keys sorted); the order decides which
    negative draws each direction gets, and the row order of the RQ
    batch and the pool update."""
    nodes, edges = batch["nodes"], batch["edges"]
    enc: Dict[str, torch.Tensor] = {}
    for tname, ntype in _NODE_TYPES:
        side = nodes[tname]
        if "feat" in side:
            feat = side["feat"]
        else:
            if features is None:
                raise ValueError(
                    "id-only batch but no FeatureStore; pass features= "
                    "to make_train_step / make_eval_step")
            table = features.user_feat if ntype == M.USER \
                else features.item_feat
            feat = _take(table, side["ids"])
        enc[tname] = M.encode_nodes(params, cfg, ntype, feat, ctx)
    heads, prims = {}, {}
    for tname, ntype in _NODE_TYPES:
        side = nodes[tname]
        e_pad = side["unbr_idx"].shape[0]    # endpoint-unique rows first
        h = M.aggregate_nodes(
            params, cfg, ntype, enc[tname][:e_pad],
            _take(enc["user"], side["unbr_idx"]), side["unbr_mask"],
            _take(enc["item"], side["inbr_idx"]), side["inbr_mask"], ctx)
        heads[tname] = h
        prims[tname] = M.primary_embedding(h)
    per_type = {}
    for et in sorted(edges):
        e = edges[et]
        st, dt = _ET_TYPES[et]
        sn = "user" if st == M.USER else "item"
        dn = "user" if dt == M.USER else "item"
        per_type[et] = (_take(heads[sn], e["src_map"]),
                        _take(prims[sn], e["src_map"]),
                        _take(heads[dn], e["dst_map"]),
                        _take(prims[dn], e["dst_map"]))
    return per_type


def _per_type(params, cfg: RankGraph2Config, batch,
              features: Optional[FeatureStore],
              ctx: Optional[ShardingCtx] = None):
    """``_dedup_per_type`` of a dedup batch; of a legacy batch every
    endpoint encoded again, each side through ``model.embed_side``, as
    the reference's legacy path.  Edge types in sorted order."""
    if "nodes" in batch:
        return _dedup_per_type(params, cfg, batch, features, ctx)
    per_type = {}
    for et in sorted(batch):
        st, dt = _ET_TYPES[et]
        sh, sp = M.embed_side(params, cfg, batch[et]["src"], st, ctx)
        dh, dp = M.embed_side(params, cfg, batch[et]["dst"], dt, ctx)
        per_type[et] = (sh, sp, dh, dp)
    return per_type


def edge_rows(batch) -> Dict[str, int]:
    """Each edge type's row count, of a batch in any layout."""
    edges = batch["edges"] if "nodes" in batch else batch
    return {et: e["weight"].shape[0] for et, e in edges.items()}


def loss_directions(batch) -> Tuple[str, ...]:
    """The contrastive directions of a batch, in the order their
    negatives are drawn: each edge type in sorted order (the order the
    jitted JAX step sees a batch dict in), with ``iu`` after ``ui``."""
    out = []
    for et in sorted(edge_rows(batch)):
        out.append(et)
        if et == "ui":
            out.append("iu")
    return tuple(out)


def draw_keys(cfg: RankGraph2Config, batch) -> Tuple[str, ...]:
    """The keys of a step's negative banks in the order the reference
    draws them (``keys[0]``, ``keys[1]``, ...): ``loss_directions``, then
    with ``reuse_lprime_negatives=False`` one ``lprime_<et>`` bank a
    edge type in sorted order, each against its destination side (the
    reference's double draw)."""
    dirs = loss_directions(batch)
    if cfg.reuse_lprime_negatives:
        return dirs
    return dirs + tuple(f"lprime_{et}" for et in sorted(edge_rows(batch)))


def _edge_of(key: str) -> str:
    """The edge type whose rows a draw key's bank covers."""
    return "ui" if key == "iu" else key.replace("lprime_", "")


def _mean(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """The whole batch's mean of a per-row loss: ``x.mean()`` on one
    process; over a data group, this rank's sum reduced over the group
    (gradient to this rank's rows only) over the whole batch's row count
    ``n``."""
    if group is None:
        return x.mean()
    return sum_across(x.sum(), group) / n


def forward_losses(params, cfg: RankGraph2Config, batch,
                   pool: N.NegPoolState, rq_state: RQ.RQState, *,
                   features: Optional[FeatureStore] = None,
                   train: bool = True,
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
                   rq_codes: Optional[torch.Tensor] = None,
                   shard_block: int = 0, group=None,
                   spans: Optional[Dict[str, Tuple[int, slice]]] = None,
                   ctx: Optional[ShardingCtx] = None):
    """Returns (task_losses, aux); aux carries the RQ state, the
    endpoint embeddings for the pool update, and the RQ's input rows
    (``rq_input``) and selections (``codes``).  ``batch`` is in any of
    the three layouts; ``features`` is needed for ``dedup_ids`` packs.
    ``draws`` maps each of ``draw_keys(cfg, batch)`` to its
    ``negatives.negative_draws``; missing ones are drawn from
    ``generator``, in that order.  ``rq_codes``, if given,
    are the RQ selections of the endpoint rows (``aux["codes"]`` of
    another call on the same batch; see ``rq_index.rq_forward``).
    ``shard_block`` keeps in-batch negatives inside blocks of that many
    rows (``negatives.sample_negatives``).  ``group``: the data group
    when ``batch`` is this rank's block (``rank_batch``); the task
    losses and RQ statistics are then the whole batch's, the pool's
    embeddings in ``aux`` the whole batch's in global row order, and
    ``rq_input`` and ``codes`` this rank's rows.  ``spans`` (needed with
    ``group``) maps each edge type to the whole batch's row count and
    this rank's rows of it (``block_rows``); a
    type that the group does not divide takes whole-batch negatives
    (module docstring), its ``draws`` laid out for the whole batch
    (``shard_block`` 0) and cut to this rank's rows.  ``ctx``: the mesh
    whose model axis splits ``params`` (``core/model.py``)."""
    tasks: Dict[str, torch.Tensor] = {}
    per_type = _per_type(params, cfg, batch, features, ctx)
    draws = draws or {}
    world = 1 if group is None else torch.distributed.get_world_size(group)
    if spans is None:
        if group is not None:
            raise ValueError("a data group's step needs each edge type's "
                             "spans (make_grad_step's)")
        spans = {et: (v[1].shape[0], None) for et, v in per_type.items()}

    user_embs, item_embs = [], []
    endpoint_prims, endpoint_splits = [], []
    for et, (sh, sp, dh, dp) in per_type.items():
        st, dt = _ET_TYPES[et]
        (user_embs if st == M.USER else item_embs).append((sp, et))
        (user_embs if dt == M.USER else item_embs).append((dp, et))
        endpoint_prims += [sp, dp]
        endpoint_splits += [(et, "src"), (et, "dst")]

    def _pair(src, dst, negs):
        return L.pair_losses(src, dst, negs, margin=cfg.margin, tau=cfg.tau)

    loss_dirs = []   # (task_suffix, src_prim, dst_prim, dst_heads, dst_type)
    for suffix in loss_directions(batch):
        if suffix == "iu":  # U-I both ways (paper: L_UI and L_IU)
            sh, sp, dh, dp = per_type["ui"]
            loss_dirs.append(("iu", dp, sp, sh, _ET_TYPES["ui"][0]))
        else:
            sh, sp, dh, dp = per_type[suffix]
            loss_dirs.append((suffix, sp, dp, dh, _ET_TYPES[suffix][1]))

    def bank(key, dp_, dh_, dt_):
        """The negatives of draw key ``key`` against destination rows
        ``dp_`` / ``dh_`` of type ``dt_``."""
        buf = pool.user if dt_ == M.USER else pool.item
        fill = pool.user_fill if dt_ == M.USER else pool.item_fill
        n, rows = spans[_edge_of(key)]
        if group is not None and not N.shard_block_for(n, world):
            # whole-batch negatives: this rank's rows' banks drawn from
            # the whole batch's destination rows
            return N.sample_negatives(
                gather_blocks(dp_, n, group), gather_blocks(dh_, n, group),
                buf, fill, cfg.n_negatives, cfg.n_pool_neg,
                draws=draws[key], rows=rows)
        return N.sample_negatives(dp_, dh_, buf, fill, cfg.n_negatives,
                                  cfg.n_pool_neg, draws=draws.get(key),
                                  generator=generator,
                                  shard_block=shard_block)

    dir_negs = {}
    for suffix, sp_, dp_, dh_, dt_ in loss_dirs:
        n = spans[_edge_of(suffix)][0]
        negs = dir_negs[suffix] = bank(suffix, dp_, dh_, dt_)
        marg, info = _pair(sp_, dp_, negs)
        tasks[f"margin_{suffix}"] = _mean(marg, group, n)
        tasks[f"infonce_{suffix}"] = _mean(info, group, n)

    # --- RQ co-learning on all endpoint embeddings -----------------------
    all_prim = torch.cat(endpoint_prims, dim=0)
    rq_out = RQ.rq_forward(params["rq"], rq_state, all_prim, cfg.rq,
                           train=train, codes=rq_codes, group=group,
                           n_rows=2 * sum(n for n, _ in spans.values()))
    tasks["rq_recon"] = rq_out["l_recon"]
    tasks["rq_reg"] = rq_out["l_reg"]
    if cfg.rq.util_coef > 0:
        tasks["rq_util"] = rq_out["l_util"]
    # contrastive on reconstructed embeddings (L'), straight-through to
    # the encoder: each edge type's direction's negative bank, or with
    # reuse_lprime_negatives=False a second bank against its destination
    # side, drawn after the L banks (the reference's double draw)
    recon_st = rq_out["recon_st"]
    offs = np.cumsum([0] + [p.shape[0] for p in endpoint_prims])
    recon_parts = {key: recon_st[lo:hi] for key, lo, hi
                   in zip(endpoint_splits, offs[:-1], offs[1:])}
    lprime = []
    for et, (sh, sp, dh, dp) in per_type.items():
        negs = dir_negs[et] if cfg.reuse_lprime_negatives \
            else bank(f"lprime_{et}", dp, dh, _ET_TYPES[et][1])
        marg, info = _pair(recon_parts[(et, "src")],
                           recon_parts[(et, "dst")], negs)
        lprime.append(_mean(0.5 * marg + 0.5 * info, group, spans[et][0]))
    tasks["rq_contrastive"] = torch.stack(lprime).mean()
    # the pool takes the whole batch's rows, in global row order
    user_embs = [e if group is None else gather_rows(e, group, spans[et][0])
                 for e, et in user_embs]
    item_embs = [e if group is None else gather_rows(e, group, spans[et][0])
                 for e, et in item_embs]

    aux = dict(rq_state=rq_out["state"],
               user_emb=torch.cat(user_embs) if user_embs else None,
               item_emb=torch.cat(item_embs) if item_embs else None,
               codes=rq_out["codes"], rq_input=all_prim.detach())
    return tasks, aux


_SIDE_NAMES = {M.USER: "user", M.ITEM: "item"}


def rank_batch(batch, rank: int, dp: int):
    """Rank ``rank``'s block of a batch split over ``dp`` ranks: its
    ``block_rows`` of each edge type (rows ``rank*B/dp`` to
    ``(rank+1)*B/dp - 1`` where ``dp`` divides ``B``; else blocks of
    ``ceil(B/dp)``, the last ranks holding fewer or none).  A dedup batch
    (``ids`` or ``feat`` packs) gets a pack of its own that holds only
    the nodes those rows need (their endpoints first, in pack order, then
    the neighbours the endpoints reference, in pack order), so the rank
    encodes and aggregates only those; a legacy batch, the rows of every
    tensor."""
    if "nodes" not in batch:
        def cut(tree, rows):
            return {k: cut(v, rows) if isinstance(v, dict) else v[rows]
                    for k, v in tree.items()}
        return {et: cut(sub, block_rows(sub["weight"].shape[0], dp, rank))
                for et, sub in sorted(batch.items())}
    nodes, edges = batch["nodes"], batch["edges"]
    ep = {"user": [], "item": []}
    rows = {}
    for et in sorted(edges):
        rows[et] = block_rows(edges[et]["src_map"].shape[0], dp, rank)
        st, dt = _ET_TYPES[et]
        ep[_SIDE_NAMES[st]].append(edges[et]["src_map"][rows[et]].long())
        ep[_SIDE_NAMES[dt]].append(edges[et]["dst_map"][rows[et]].long())
    dev = nodes["user"]["unbr_idx"].device
    rows_of = "feat" if "feat" in nodes["user"] else "ids"
    ends = {t: (torch.unique(torch.cat(v)) if v else
                torch.zeros(0, dtype=torch.long, device=dev))
            for t, v in ep.items()}
    # pack rows each type needs: its endpoints and every neighbour the
    # endpoints of either type reference (masked entries point at row 0)
    nbr_key = {"user": "unbr_idx", "item": "inbr_idx"}
    remap, keep = {}, {}
    for t in ("user", "item"):
        U = nodes[t][rows_of].shape[0]
        need = torch.zeros(U, dtype=torch.bool, device=dev)
        for s in ("user", "item"):
            need[nodes[s][nbr_key[t]][ends[s]].long().reshape(-1)] = True
        need[ends[t]] = False
        keep[t] = torch.cat([ends[t], torch.nonzero(need).flatten()])
        remap[t] = torch.full((U,), -1, dtype=torch.long, device=dev)
        remap[t][keep[t]] = torch.arange(len(keep[t]), device=dev)
    out_nodes = {}
    for t in ("user", "item"):
        side, e = nodes[t], ends[t]
        out_nodes[t] = {rows_of: side[rows_of][keep[t]]}
        out_nodes[t].update(
            unbr_idx=remap["user"][side["unbr_idx"][e].long()].to(
                torch.int32),
            unbr_mask=side["unbr_mask"][e],
            inbr_idx=remap["item"][side["inbr_idx"][e].long()].to(
                torch.int32),
            inbr_mask=side["inbr_mask"][e])
    out_edges = {}
    for et in sorted(edges):
        st, dt = _ET_TYPES[et]
        sub = {k: v[rows[et]] for k, v in edges[et].items()}
        sub["src_map"] = remap[_SIDE_NAMES[st]][sub["src_map"].long()].to(
            torch.int32)
        sub["dst_map"] = remap[_SIDE_NAMES[dt]][sub["dst_map"].long()].to(
            torch.int32)
        out_edges[et] = sub
    return {"nodes": out_nodes, "edges": out_edges}


_DST_OF = {"uu": M.USER, "ui": M.ITEM, "iu": M.USER, "ii": M.ITEM}


def _rank_draws(cfg: RankGraph2Config, batch, pool: N.NegPoolState, draws,
                generator, spans, dp: int):
    """This rank's rows (``spans``) of the whole batch's draws of
    each of ``draw_keys`` (the L banks, and the L' banks where they are
    drawn apart): the given ones, or those the global step would draw
    from ``generator`` (shard-local negatives where ``dp`` divides ``B``,
    else whole-batch ones: ``shard_block_for``; the same generator state
    on every rank gives every rank the same draws)."""
    out = {}
    for key in draw_keys(cfg, batch):
        B, rows = spans[_edge_of(key)]
        d = (draws or {}).get(key)
        if d is None:
            dst = _DST_OF[key.replace("lprime_", "")]
            fill = pool.user_fill if dst == M.USER else pool.item_fill
            d = N.negative_draws(B, cfg.n_heads, cfg.n_negatives,
                                 cfg.n_pool_neg, fill, generator=generator,
                                 device=pool.user.device,
                                 shard_block=N.shard_block_for(B, dp))
        out[key] = {k: v[rows] for k, v in d.items()}
    return out


@dataclasses.dataclass
class StepGrads:
    """One train step's forward and backward: the task losses, their
    uncertainty-weighted total, ``forward_losses``'s ``aux`` and every
    parameter's gradient by name as the update takes it, before
    clipping (summed over the data group in a data-parallel step);
    ``shards``: the split leaves' groups (``model.shard_groups``), by
    which the clip's norm counts each leaf once, None where every leaf
    is whole."""
    tasks: Dict[str, torch.Tensor]
    total: torch.Tensor
    aux: Dict[str, object]
    grads: Dict[str, torch.Tensor]
    shards: Optional[Dict[str, Tuple[Any, ...]]] = None


def make_grad_step(cfg: RankGraph2Config, ctx: Optional[ShardingCtx] = None,
                   *, features: Optional[FeatureStore] = None,
                   shard_block: int = 0):
    """Builds ``grad_step(state, batch, *, generator=None, draws=None)
    -> StepGrads``, the first half of ``make_train_step``'s step (which
    ``apply_grads`` completes); ``state`` is not changed.  ``batch`` is
    in any layout of ``BATCH_FORMATS``; ``features`` is needed for
    ``dedup_ids`` packs only.

    ``ctx`` with a mesh whose ``"batch"`` axes have ``dp > 1`` ranks
    makes the data-parallel step (see the module docstring): each rank
    passes the same whole ``batch`` and the whole batch's ``draws`` (or
    a generator in the same state), laid out as ``negative_draws`` with
    ``shard_block = negatives.shard_block_for(B, dp)`` (``B/dp``, or 0
    for whole-batch negatives where ``dp`` does not divide ``B``);
    ``aux`` then holds this rank's rows.  With no mesh or ``dp == 1`` it
    is the one-process step; ``shard_block`` then keeps its in-batch
    negatives inside blocks of that many rows (the global step a
    ``dp``-rank run equals).  A mesh with a ``model`` axis splits the
    model over it (module docstring): ``state`` then holds this rank's
    shards (``shard_state``)."""
    dp = 1 if ctx is None else ctx.axis_size("batch")
    shards = M.shard_groups(cfg, ctx) or None
    group, rank = None, 0
    if dp > 1:
        if shard_block:
            raise ValueError("the data-parallel step sets its own "
                             "shard_block (shard_block_for(B, dp))")
        axes = ctx.mesh_axes("batch")
        group, rank = ctx.group(axes), ctx.axis_index(axes)

    def grad_step(state: TrainState, batch, *,
                  generator: Optional[torch.Generator] = None,
                  draws=None) -> StepGrads:
        params = named_params(state.params)
        for p in params.values():
            p.grad = None
        spans = None
        if group is not None:
            spans = {et: (n, block_rows(n, dp, rank))
                     for et, n in edge_rows(batch).items()}
            draws = _rank_draws(cfg, batch, state.pool, draws, generator,
                                spans, dp)
            batch = rank_batch(batch, rank, dp)
        tasks, aux = forward_losses(state.params, cfg, batch, state.pool,
                                    state.rq_state, features=features,
                                    train=True, generator=generator,
                                    draws=draws, shard_block=shard_block,
                                    group=group, spans=spans, ctx=ctx)
        total = L.uncertainty_combine(tasks, state.params["uncertainty"])
        total.backward()
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}
        for p in params.values():
            p.grad = None
        if group is not None:   # the log-variances' are whole already
            reduce_grads_(grads, [k for k in grads
                                  if not k.startswith("uncertainty.")],
                          group)
        return StepGrads(tasks, total, aux, grads, shards)

    return grad_step


def apply_grads(state: TrainState, sg: StepGrads,
                optimizer: opt_lib.Optimizer, *, grad_clip: float = 1.0):
    """The second half of the step: clips ``sg.grads`` by their global
    norm, updates the parameters in place, inserts the batch's
    embeddings into the pool and takes the new RQ state.  Returns
    ``(state, metrics)``; ``metrics`` are 0-d device tensors (reading
    them is the caller's sync)."""
    params = named_params(state.params)
    grads, gnorm = opt_lib.clip_by_global_norm(sg.grads, grad_clip,
                                               sg.shards)
    with torch.no_grad():
        updates, state.opt_state = optimizer.update(
            grads, state.opt_state, params)
        opt_lib.apply_updates(params, updates)
    N.update_pool(state.pool, sg.aux["user_emb"], sg.aux["item_emb"])
    state.rq_state = sg.aux["rq_state"]
    state.step += 1
    metrics = {k: v.detach() for k, v in sg.tasks.items()}
    metrics["total"] = sg.total.detach()
    metrics["grad_norm"] = gnorm.detach()
    return state, metrics


def make_train_step(cfg: RankGraph2Config, optimizer: opt_lib.Optimizer,
                    ctx: Optional[ShardingCtx] = None, *,
                    features: Optional[FeatureStore] = None,
                    grad_clip: float = 1.0):
    """Builds ``train_step(state, batch, *, generator=None, draws=None)
    -> (state, metrics)``: ``make_grad_step(cfg, ctx, features=)``'s
    gradients, then ``apply_grads``."""
    grad_step = make_grad_step(cfg, ctx, features=features)

    def train_step(state: TrainState, batch, *,
                   generator: Optional[torch.Generator] = None,
                   draws=None):
        return apply_grads(state, grad_step(state, batch,
                                            generator=generator,
                                            draws=draws),
                           optimizer, grad_clip=grad_clip)

    return train_step


def make_eval_step(cfg: RankGraph2Config, *,
                   features: Optional[FeatureStore] = None):
    """Builds ``eval_step(state, batch, *, generator=None, draws=None)
    -> task_losses``: ``forward_losses`` with ``train=False`` (Eq. 9
    hard RQ selection, no state update), under ``no_grad``; negatives
    as in ``make_train_step``."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch, *,
                  generator: Optional[torch.Generator] = None, draws=None):
        tasks, _ = forward_losses(state.params, cfg, batch, state.pool,
                                  state.rq_state, features=features,
                                  train=False, generator=generator,
                                  draws=draws)
        return tasks

    return eval_step


# ---------------------------------------------------------------------------
# self-healing: dead-code reset over the whole TrainState
# ---------------------------------------------------------------------------

def reset_dead_codes(state: TrainState, probe_emb, cfg: RankGraph2Config,
                     *, seed: int, step: int = 0, usage=None
                     ) -> Tuple[TrainState, Dict[str, int]]:
    """Run ``rq_index.dead_code_reset`` against a TrainState.

    Host-side; only the dead codebook rows and the RQ usage counters
    change.  The new codebooks are written into the same
    ``nn.Parameter`` objects, in place and outside autograd, so the
    optimizer's state (keyed by parameter name) stays valid; the RQ
    state is replaced by one with the new usage on its device and the
    same histograms, ``ptr`` and ``filled``.  Every other parameter, the
    optimizer's state, the pool and the step are left untouched.
    ``probe_emb`` is a (P, d_embed) sample of current embeddings (array
    or tensor) supplying the donor residuals; ``usage`` optionally
    overrides the EMA counters with published corpus occupancy (the
    repair path).  Returns ``(state, report)``, ``state`` updated in
    place.
    """
    new_rq, new_rq_state, report = RQ.dead_code_reset(
        state.params["rq"], state.rq_state, probe_emb, cfg.rq,
        seed=seed, step=step, usage=usage)
    books = state.params["rq"]["codebooks"]
    with torch.no_grad():
        for name, book in new_rq["codebooks"].items():
            books[name].copy_(book)
    state.rq_state = new_rq_state
    return state, report


# ---------------------------------------------------------------------------
# embedding generation (paper: embeddings regenerated after each rebuild)
# ---------------------------------------------------------------------------

@torch.inference_mode()
def embed_all(params, cfg: RankGraph2Config, dataset, *, node_type: int,
              ids: np.ndarray, batch: int = 4096,
              ctx: Optional[ShardingCtx] = None) -> torch.Tensor:
    """Primary embeddings (len(ids), d_embed) in ``cfg.dtype`` on the
    dataset's device, for global node ids.

    Every chunk is padded to the fixed ``batch`` by repeating its last
    id, as the JAX package does: the neighbour draw of a chunk depends
    on its padded shape, so the same rule gives the same draws.  Under
    ``ctx`` ``params`` are this rank's shards (``shard_state``) and every
    rank returns every id's embedding."""
    ids = np.asarray(ids)
    out = []
    for lo in range(0, len(ids), batch):
        chunk = ids[lo:lo + batch]
        pad = batch - len(chunk)
        if pad:
            chunk = np.r_[chunk, np.repeat(chunk[-1:], pad)]
        side = dataset.node_inference_batch(chunk)
        _, prim = M.embed_side(params, cfg, side, node_type, ctx)
        out.append(prim[: len(prim) - pad] if pad else prim)
    if not out:
        return torch.empty((0, cfg.d_embed), dtype=M.DTYPES[cfg.dtype],
                           device=dataset.device)
    return torch.cat(out, dim=0)
