"""The steps a production job runs, as the functions
``repro/launch/steps.py::_lm_cell`` and ``_recsys_cell`` build (without
their mesh, shardings and shape stand-ins).

The LM train step (the train_4k cell's):

  * ``lm_train_step``: ``lm_loss``, its gradients,
    ``clip_by_global_norm_(1.0)`` (in place) and the update of
    ``make_optimizer(cfg.optimizer)``, formed and applied one parameter
    at a time (``apply_leafwise``), so that the step holds the
    parameters, the gradients, the optimizer's state and one parameter's
    temporaries (the JAX step gets the same from XLA's buffer reuse).

Under a mesh (``ctx``, rules from ``lm_rules``: the LM branch of
``repro/launch/steps.py::_rules_for``, with FSDP's ``embed -> data`` for
training and grok's ``RULES_OVERRIDE``) ``lm_train_step`` is the data
parallel step over the shards ``models.lm.model.shard_params`` lays out:
each data rank takes its rows of the batch (the model group's ranks the
same rows), the loss is the mean of the data ranks' means, the gradients
of the parameters split over the data ranks come from their gathers'
reduce-scatter and the others are all-reduced, both over ``dp``, and the
clip's norm and Adafactor's statistics are the whole parameters'
(``optim.optimizers``, ``shards``).  The model axis runs tensor and
sequence parallelism (``models.lm.model``): a leaf split over it keeps
its block's gradient, which no reduction over the model group touches.

The LM serve steps:

  * ``lm_prefill_step``: a prompt batch (B, S) -> last-position logits
    and the caches (L, B, S, Hkv, hd);
  * ``lm_decode_step``: one token (B, 1) against caches (L, B, S, Hkv,
    hd) filled to ``S - 1``, as the JAX decode cell takes it; the caches
    are written in place.  Under the decode rules a rank passes its block
    of the caches' sequence (``models.lm.model.shard_caches``).

The recsys steps:

  * ``recsys_train_step``: loss, gradients, ``clip_by_global_norm(1.0)``
    and the ``rankgraph2_optimizer`` update (AdaGrad on ``tables``,
    AdamW on the rest), applied to the parameters in place;
  * ``recsys_serve_step``: forward scoring of a request batch (for
    sasrec the user representation);
  * ``recsys_retrieval_step``: one query representation against the
    candidate items, top k (100) with the lowest index first among equal
    scores, as ``jax.lax.top_k``.

The recsys steps take ``ctx`` (a ``ShardingCtx``), every kind: under a
mesh that shards the tables' rows every rank passes the whole batch and
its own rows of the tables (``models.init_params(ctx=)``), the lookups
are ``models._lookup_sharded`` and ``_bag_sharded``, and the rest of the
model runs replicated over the data ranks and, where the rules split
``mlp`` and ``heads`` over ``model`` (the default rules), tensor
parallel over the model group (``models.param_layout``), so the loss and
the logits are the whole batch's on every rank, a whole leaf's gradient
is whole, and a split leaf's (a table's rows, a layer's block) covers
the rank's block.  The retrieval step splits the candidates over the
``candidates`` rule's axes and merges the ranks' top k.

Batches are dicts of tensors on the parameters' device: ``dense``,
``sparse`` ((B, F) ids, or (B, F, L) multi-hot bags for dlrm) and
``labels`` for dlrm / wide_deep; ``seq``, ``pos``, ``neg`` for sasrec;
``seq``, ``target``, ``other``, ``labels`` for bst.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import (LMConfig, RecsysConfig, ShapeSpec,
                                     get_arch)
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import ShardingCtx, make_rules
from repro_torch.models.lm import model as LM
from repro_torch.models.recsys import models as R
from repro_torch.optim import optimizers as O

Batch = Dict[str, torch.Tensor]


def recsys_forward(params: R.Params, cfg: RecsysConfig, batch: Batch,
                   ctx: Optional[ShardingCtx] = None) -> torch.Tensor:
    kind = cfg.kind
    if kind == "dlrm":
        return R.dlrm_forward(params, cfg, batch["dense"], batch["sparse"],
                              ctx)
    if kind == "wide_deep":
        return R.wide_deep_forward(params, cfg, None, batch["sparse"], ctx)
    if kind == "sasrec":
        return R.sasrec_user_repr(params, cfg, batch["seq"], ctx)
    return R.bst_forward(params, cfg, batch["seq"], batch["target"],
                         batch["other"], ctx)


def recsys_loss(params: R.Params, cfg: RecsysConfig, batch: Batch,
                ctx: Optional[ShardingCtx] = None) -> torch.Tensor:
    if cfg.kind == "sasrec":
        return R.sasrec_loss(params, cfg, batch["seq"], batch["pos"],
                             batch["neg"], ctx)
    return R.bce_loss(recsys_forward(params, cfg, batch, ctx),
                      batch["labels"])


def loss_and_grads(params: R.Params, cfg: RecsysConfig, batch: Batch,
                   ctx: Optional[ShardingCtx] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The loss and the gradient of every parameter, by dotted name."""
    flat = R.flatten_params(params)
    for p in flat.values():
        p.requires_grad_(True)
    loss = recsys_loss(params, cfg, batch, ctx)
    grads = torch.autograd.grad(loss, list(flat.values()))
    return loss.detach(), dict(zip(flat, grads))


def recsys_train_step(params: R.Params, opt_state, batch: Batch,
                      cfg: RecsysConfig, optimizer: O.Optimizer,
                      ctx: Optional[ShardingCtx] = None
                      ) -> Tuple[torch.Tensor, object]:
    """One step; updates ``params`` in place (the JAX step returns new
    ones) and returns (loss, new optimizer state).  ``optimizer`` is
    ``rankgraph2_optimizer()``, its state ``optimizer.init(
    flatten_params(params))``.  Under a ``ctx`` the global norm of the
    clip is the whole model's: the squared norms of every split leaf's
    blocks (the row-sharded tables, ``row_sharded_leaves``, and the
    tensor-parallel layers, ``param_layout``) are summed over the groups
    they are split over, each whole leaf counted once
    (``shard_groups``).  The optimizers are elementwise."""
    loss, grads = loss_and_grads(params, cfg, batch, ctx)
    flat = R.flatten_params(params)
    with torch.no_grad():
        grads, _ = O.clip_by_global_norm(grads, 1.0,
                                         R.shard_groups(cfg, ctx))
        upd, opt_state = optimizer.update(grads, opt_state, flat)
        del grads
        O.apply_updates(flat, upd)
    return loss, opt_state


@torch.no_grad()
def recsys_serve_step(params: R.Params, cfg: RecsysConfig, batch: Batch,
                      ctx: Optional[ShardingCtx] = None) -> torch.Tensor:
    """Logits (B,) in the compute type; for sasrec (B, D) user
    representations."""
    return recsys_forward(params, cfg, batch, ctx)


def top_k(scores: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest of a 1-D ``scores``, in descending order, the lower
    index first among equal values (``jax.lax.top_k``'s order;
    ``torch.topk`` promises none).  Returns (values, indices)."""
    k = min(k, scores.shape[0])
    thr = torch.topk(scores, k).values[-1]
    cand = torch.nonzero(scores >= thr).flatten()          # ascending ids
    order = torch.sort(scores[cand], descending=True, stable=True).indices
    idx = cand[order[:k]]
    return scores[idx], idx


SCORE_ROWS = 1 << 17  # candidate rows ``dot_scores`` scores at a time


def dot_scores(u: torch.Tensor, cvec: torch.Tensor) -> torch.Tensor:
    """(1, D) query x (N, D) candidate rows -> (N,) scores in ``u``'s
    type: each the f32 sum of its D products (exact in f32 for bf16
    inputs), rounded once, as ``u @ cvec.T`` with f32 accumulation.  A
    row-wise reduction: a candidate's score depends on its row alone,
    where a matrix product's CPU and cuBLAS kernels sum a column of an
    edge tile in another order, so that equal candidates at other
    positions, or in a block of another width, would not tie.  Scored
    ``SCORE_ROWS`` rows at a time (the rows cast to f32 inside the
    product), so that the f32 products stay small: 32 MB at D 64."""
    uf = u.to(torch.float32)
    out = torch.empty(cvec.shape[0], dtype=torch.float32, device=cvec.device)
    for r0 in range(0, cvec.shape[0], SCORE_ROWS):
        torch.sum(cvec[r0:r0 + SCORE_ROWS] * uf, dim=-1,
                  out=out[r0:r0 + SCORE_ROWS])
    return out.to(u.dtype)


def merge_top_k(values: torch.Tensor, indices: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k best of candidate (value, index) pairs, in ``top_k``'s order:
    value descending, the lower index first among equal values."""
    order = torch.argsort(indices, stable=True)  # position order = index
    v, i = top_k(values[order], k)
    return v, indices[order][i]


def _candidate_axes(ctx: Optional[ShardingCtx]) -> Tuple[str, ...]:
    """The mesh axes of the ``candidates`` rule that hold more than one
    rank (none in one process)."""
    if ctx is None or ctx.mesh is None:
        return ()
    return tuple(a for a in ctx.mesh_axes("candidates") if ctx.size(a) > 1)


@torch.no_grad()
def retrieval_scores(params: R.Params, cfg: RecsysConfig, batch: Batch,
                     cand_ids: torch.Tensor,
                     ctx: Optional[ShardingCtx] = None
                     ) -> Tuple[torch.Tensor, slice]:
    """(scores, block): this rank's block of ``cand_ids`` (N,) and its dot
    scores (``dot_scores``, in the compute type) against the query
    representation of ``batch`` (a batch of one; sasrec: its user
    representation; the others: the mean of its rows in the first table,
    in the stored type, then cast).  The block is the
    ``collectives.block_rows`` block of the ``candidates`` rule's axes
    under ``ctx``, all the candidates otherwise; the rows come through
    the sharded lookup."""
    compute, V = R.DTYPES[cfg.dtype], cfg.default_vocab
    if cfg.kind == "sasrec":
        u = R.sasrec_user_repr(params, cfg, batch["seq"], ctx)
    else:
        tab = params["items"] if cfg.kind == "bst" else params["tables"][0]
        ids = batch["seq"] if cfg.kind == "bst" else batch["sparse"]
        e = R.take_rows(tab, torch.remainder(ids[0], V), ctx=ctx, vocab=V)
        u = torch.mean(e, dim=0, keepdim=True).to(compute)
    table = params["items"] if cfg.kind in ("sasrec", "bst") \
        else params["tables"][0]
    axes = _candidate_axes(ctx)
    if not axes:
        cvec = R.take_rows(table, torch.remainder(cand_ids, V), u.dtype,
                           ctx, V)
        return dot_scores(u, cvec), slice(0, cand_ids.shape[0])
    blk = C.block_rows(cand_ids.shape[0], ctx.size(axes),
                       ctx.axis_index(axes))
    cvec = R.take_rows_in_group(table, torch.remainder(cand_ids[blk], V),
                                u.dtype, ctx, V)
    return dot_scores(u, cvec), blk


@torch.no_grad()
def recsys_retrieval_step(params: R.Params, cfg: RecsysConfig,
                          batch: Batch, cand_ids: torch.Tensor,
                          k: int = 100, ctx: Optional[ShardingCtx] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One query (a batch of one) against ``cand_ids`` (N,): the scores of
    ``retrieval_scores``, top ``k``.  Returns (scores, indices into
    ``cand_ids``).

    Under ``ctx`` (after the reference's ``retrieval_cand`` step, which
    shards the candidates by the ``candidates`` rule): every rank passes
    the whole query and candidates and scores its block; each rank takes
    its block's own top ``k``, the candidate group gathers (values, global
    indices) and merges them in ``top_k``'s order, so every rank returns
    the same k: the one-process step's, since ``dot_scores`` gives a
    candidate the same score in any block."""
    scores, blk = retrieval_scores(params, cfg, batch, cand_ids, ctx)
    axes = _candidate_axes(ctx)
    if not axes:
        return top_k(scores, k)
    # each block's top, padded to the longest (index -1) for the gather
    kk = min(k, -(-cand_ids.shape[0] // ctx.size(axes)))
    vals = scores.new_zeros(kk)
    idx = torch.full((kk,), -1, dtype=torch.long, device=scores.device)
    if scores.shape[0]:
        v, i = top_k(scores, k)
        vals[:v.shape[0]], idx[:i.shape[0]] = v, i + blk.start
    group = ctx.group(axes)
    all_v, all_i = C.gather_rows(vals, group), C.gather_rows(idx, group)
    keep = all_i >= 0
    return merge_top_k(all_v[keep], all_i[keep], k)


def lm_rules(arch_id: str, shape: ShapeSpec, mesh,
             overrides: Optional[dict] = None) -> dict:
    """The rules of an LM cell, as ``repro/launch/steps.py::_rules_for``
    makes them for the LM family: grok's ``RULES_OVERRIDE``; for a train
    shape FSDP (``embed -> data``) and sequence parallelism (``seq ->
    model``: the residual between blocks is a rank's ``S / nm``
    positions); for a decode shape the KV cache's sequence over ``kv_seq``
    (``model``, or ``("data", "model")`` at a global batch of 1, where the
    batch stays whole: a rank holds its block of the positions and the
    ranks fold their attention, ``models.lm.model.decode_step``), heads
    whole.  The default rules split ``heads``, ``kv_heads``,
    ``mlp`` and ``vocab`` over ``model`` (tensor parallelism,
    ``models.lm.model``); ``overrides`` map names first, as the
    reference's ``_rules_for(overrides=)`` (``{"mlp": None}`` keeps the
    MLP whole).  ``mesh``: a ``DeviceMesh`` or a sequence of axis
    names."""
    if get_arch(arch_id).family != "lm":
        raise ValueError(f"{arch_id} is not an LM")
    ov = dict(overrides or {})
    if arch_id == "grok-1-314b":
        from repro_torch.configs.grok_1_314b import RULES_OVERRIDE
        ov.update(RULES_OVERRIDE)
    if shape.step == "train":
        ov.setdefault("embed", "data")
        ov.setdefault("seq", "model")
    if shape.step == "decode":
        batch = shape.dims.get("global_batch", 2)
        ov.setdefault("kv_seq", ("model",) if batch > 1
                      else ("data", "model"))
        ov.setdefault("heads", None)
        ov.setdefault("kv_heads", None)
        if batch == 1:
            ov.setdefault("batch", None)
    return make_rules(mesh, ov)


def lm_loss_and_grads(params: LM.Params, cfg: LMConfig, tokens: torch.Tensor,
                      ctx: Optional[ShardingCtx] = None, lay=None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``lm_loss`` of tokens (B, S) and the gradient of every parameter by
    ``named_params``' name.  Under ``ctx`` ``tokens`` is the whole batch:
    this rank takes its data rank's rows (``rank_rows``), and returns the
    whole batch's loss (the mean of the data ranks' means) and the
    gradients of its shards of that loss; ``lay``: ``param_layout(cfg,
    ctx)`` where the caller has it."""
    flat = LM.named_params(params)
    for p in flat.values():
        p.requires_grad_(True)
    if ctx is not None and ctx.mesh is not None and lay is None:
        lay = LM.param_layout(cfg, ctx)
    axes = LM.data_axes(ctx)
    dp = ctx.size(axes) if axes else 1
    loss = LM.lm_loss(params, cfg, LM.rank_rows(tokens, ctx), ctx=ctx,
                      lay=lay)
    grads = dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))
    loss = loss.detach()
    if dp > 1:
        with torch.no_grad():
            group = ctx.group(axes)
            split = {k for k, spec in LM.named_params(lay).items()
                     if any(set(a if isinstance(a, tuple) else (a,))
                            & set(axes) for a in spec if a is not None)}
            # the FSDP leaves' gathers reduce-scattered theirs already
            C.reduce_grads_(grads, [k for k in grads if k not in split],
                            group)
            for k in grads:
                grads[k] = grads[k] / dp
            loss = C.sum_across_(loss.clone(), group) / dp
    return loss, grads


def lm_train_step(params: LM.Params, cfg: LMConfig, opt: O.Optimizer,
                  opt_state, tokens: torch.Tensor,
                  ctx: Optional[ShardingCtx] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, object]:
    """One step on tokens (B, S); updates ``params`` in place (the JAX step
    returns new ones) and returns (loss, the gradients' global norm before
    clipping, the new optimizer state).  ``opt`` is
    ``make_optimizer(cfg.optimizer)``, its state ``opt.init(
    named_params(params))``.  Under ``ctx`` ``params`` are this rank's
    shards (``shard_params``), ``tokens`` the whole batch, and ``opt``
    ``make_optimizer(cfg.optimizer, shards=shard_groups(cfg, ctx))``
    (an Adafactor made for another layout raises); every rank returns
    the whole batch's loss and the whole norm."""
    flat = LM.named_params(params)
    lay = shards = None
    if ctx is not None and ctx.mesh is not None:
        lay = LM.param_layout(cfg, ctx)
        shards = LM.shard_groups(cfg, ctx, lay)
    O.check_shards(opt, shards)
    loss, grads = lm_loss_and_grads(params, cfg, tokens, ctx, lay)
    with torch.no_grad():
        gnorm = O.clip_by_global_norm_(grads, 1.0, shards)
        opt_state = O.apply_leafwise(opt, grads, opt_state, flat)
    return loss, gnorm, opt_state


@torch.no_grad()
def lm_prefill_step(params: LM.Params, cfg: LMConfig, tokens: torch.Tensor,
                    ctx: Optional[ShardingCtx] = None
                    ) -> Tuple[torch.Tensor, LM.Caches]:
    return LM.prefill(params, cfg, tokens, ctx=ctx)


@torch.no_grad()
def lm_decode_step(params: LM.Params, cfg: LMConfig, caches: LM.Caches,
                   tokens: torch.Tensor, ctx: Optional[ShardingCtx] = None
                   ) -> Tuple[torch.Tensor, LM.Caches]:
    return LM.decode_step(params, cfg, tokens, caches,
                          LM.cache_length(caches, ctx) - 1, ctx=ctx)
