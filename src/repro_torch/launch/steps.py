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
(``optim.optimizers``, ``shards``).

The LM serve steps:

  * ``lm_prefill_step``: a prompt batch (B, S) -> last-position logits
    and the caches (L, B, S, Hkv, hd);
  * ``lm_decode_step``: one token (B, 1) against caches (L, B, S, Hkv,
    hd) filled to ``S - 1``, as the JAX decode cell takes it; the caches
    are written in place.

The recsys steps:

  * ``recsys_train_step``: loss, gradients, ``clip_by_global_norm(1.0)``
    and the ``rankgraph2_optimizer`` update (AdaGrad on ``tables``,
    AdamW on the rest), applied to the parameters in place;
  * ``recsys_serve_step``: forward scoring of a request batch (for
    sasrec the user representation);
  * ``recsys_retrieval_step``: one query representation against the
    candidate items, top k (100) with the lowest index first among equal
    scores, as ``jax.lax.top_k``.

The recsys train and serve steps take ``ctx`` (a ``ShardingCtx``; dlrm
only): under a mesh that shards the tables' rows every rank passes the
whole batch and its own rows of the tables (``models.dlrm_init(ctx=)``),
the lookup is ``models._lookup_sharded``, and the rest of the model runs
replicated, so the loss, the dense gradients and the logits are the
whole batch's on every rank and each rank's table gradient covers its
own rows.

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
    R.check_ctx(cfg, ctx)
    if kind == "dlrm":
        return R.dlrm_forward(params, cfg, batch["dense"], batch["sparse"],
                              ctx)
    if kind == "wide_deep":
        return R.wide_deep_forward(params, cfg, None, batch["sparse"])
    if kind == "sasrec":
        return R.sasrec_user_repr(params, cfg, batch["seq"])
    return R.bst_forward(params, cfg, batch["seq"], batch["target"],
                         batch["other"])


def recsys_loss(params: R.Params, cfg: RecsysConfig, batch: Batch,
                ctx: Optional[ShardingCtx] = None) -> torch.Tensor:
    if cfg.kind == "sasrec":
        R.check_ctx(cfg, ctx)
        return R.sasrec_loss(params, cfg, batch["seq"], batch["pos"],
                             batch["neg"])
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
    flatten_params(params))``.  Under a ``ctx`` that shards the tables'
    rows the global norm of the clip is the whole model's: the squared
    norms of the shards are summed over the model group."""
    loss, grads = loss_and_grads(params, cfg, batch, ctx)
    flat = R.flatten_params(params)
    with torch.no_grad():
        sharded = R.row_shards(ctx, cfg.default_vocab) > 1
        grads, _ = O.clip_by_global_norm(
            grads, 1.0, {"tables": (None, ctx.group("model"), None)}
            if sharded else None)
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


@torch.no_grad()
def recsys_retrieval_step(params: R.Params, cfg: RecsysConfig,
                          batch: Batch, cand_ids: torch.Tensor,
                          k: int = 100) -> Tuple[torch.Tensor, torch.Tensor]:
    """One query (a batch of one) against ``cand_ids`` (N,): the query
    representation (sasrec: its user representation; the others: the
    mean of its rows in the first table, in the stored type, then cast),
    dot scores in the compute type, top ``k``.  Returns (scores, indices
    into ``cand_ids``)."""
    compute = R.DTYPES[cfg.dtype]
    if cfg.kind == "sasrec":
        u = R.sasrec_user_repr(params, cfg, batch["seq"])
    elif cfg.kind == "bst":
        V = params["items"].shape[0]
        e = R.take_rows(params["items"], torch.remainder(batch["seq"][0], V))
        u = torch.mean(e, dim=0, keepdim=True).to(compute)
    else:
        tab = params["tables"]
        e = R.take_rows(tab[0], torch.remainder(batch["sparse"][0],
                                                tab.shape[1]))
        u = torch.mean(e, dim=0, keepdim=True).to(compute)
    table = params["items"] if cfg.kind in ("sasrec", "bst") \
        else params["tables"][0]
    cvec = R.take_rows(table, torch.remainder(cand_ids, table.shape[0]),
                       u.dtype)
    scores = (u @ cvec.T)[0]
    return top_k(scores, k)


def lm_rules(arch_id: str, shape: ShapeSpec, mesh,
             overrides: Optional[dict] = None) -> dict:
    """The rules of an LM cell, as ``repro/launch/steps.py::_rules_for``
    makes them for the LM family: grok's ``RULES_OVERRIDE``; for a train
    shape FSDP (``embed -> data``) and sequence parallelism (``seq ->
    model``, which the port's replicated activations ignore); for a
    decode shape the KV cache over ``kv_seq``, heads whole and, at a
    global batch of 1, the batch whole.  ``mesh``: a ``DeviceMesh`` or a
    sequence of axis names."""
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
                          caches["k"].shape[2] - 1, ctx=ctx)
