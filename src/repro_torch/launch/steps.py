"""The steps a production job runs, as the functions
``repro/launch/steps.py::_lm_cell`` and ``_recsys_cell`` build, and the
cells themselves (``build_cell``, ``all_cells``; at the end of this
module).

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
    of the caches' sequence (``models.lm.model.shard_caches``), or the
    whole cache where the ``kv_seq`` ranks do not divide it.

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

A cell (``build_cell(arch_id, shape_name, mesh)``) is one (arch, shape)
of the registry on a mesh: the step above that a production job would
run (the rankgraph2 train step in the ``dedup`` layout, its serve step,
or the online-KNN baseline ``knn_retrieval_step``), one rank's arguments
on ``meta`` laid out by the families' ``param_layout`` and ``shard_of``,
and the reference's useful-FLOPs count (``model_flops``: 6 N D for
training, 2 N D for inference, ``_recsys_flops``,
``_rg2_dedup_train_flops`` and ``_rg2_flops``).  On an
``launch.mesh.AbstractMesh`` a cell builds with no process group and
does not run (``launch/dryrun.py`` reads its bytes); on a ``DeviceMesh``
it runs.  Departures: the batch is the port's step's own (the whole
batch where the step takes its rows inside, so rankgraph2's 10,922 rows
a type are ``block_rows`` blocks where ``_safe`` keeps them whole; the
notes say so), LM layers are one leaf each where the reference stacks
them, and ``all_cells()`` lacks ``equiformer-v2``'s four cells (the GNN
family is not ported yet).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import (LMConfig, RankGraph2Config,
                                     RecsysConfig, ShapeSpec, get_arch)
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import (ShardingCtx, make_rules,
                                              split_axes)
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
    return _merged_top_k(scores, blk.start, cand_ids.shape[0], k, ctx)


def _merged_top_k(scores: torch.Tensor, start: int, n_total: int, k: int,
                  ctx: Optional[ShardingCtx]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top ``k`` of ``n_total`` candidates whose block from ``start``
    this rank scored (``scores``): each rank's own top ``k``, gathered
    over the candidate group as (value, global index) and merged in
    ``top_k``'s order; with no candidate axes, ``top_k`` itself."""
    axes = _candidate_axes(ctx)
    if not axes:
        return top_k(scores, k)
    # each block's top, padded to the longest (index -1) for the gather
    kk = min(k, -(-n_total // ctx.size(axes)))
    vals = scores.new_zeros(kk)
    idx = torch.full((kk,), -1, dtype=torch.long, device=scores.device)
    if scores.shape[0]:
        v, i = top_k(scores, k)
        vals[:v.shape[0]], idx[:i.shape[0]] = v, i + start
    group = ctx.group(axes)
    all_v, all_i = C.gather_rows(vals, group), C.gather_rows(idx, group)
    keep = all_i >= 0
    return merge_top_k(all_v[keep], all_i[keep], k)


def rules_for(arch_id: str, shape: ShapeSpec, mesh,
              overrides: Optional[dict] = None) -> dict:
    """The rules of a cell, as ``repro/launch/steps.py::_rules_for``
    makes them (``REPRO_BASELINE`` is not read): ``make_rules(mesh,
    overrides)`` for every family, and for the LM family also grok's
    ``RULES_OVERRIDE``; for a train shape FSDP (``embed -> data``) and
    sequence parallelism (``seq -> model``: the residual between blocks
    is a rank's ``S / nm`` positions); for a decode shape the KV cache's
    sequence over ``kv_seq`` (``model``, or ``("data", "model")`` at a
    global batch of 1, where the batch stays whole: a rank holds its
    block of the positions and the ranks fold their attention,
    ``models.lm.model.decode_step``), heads whole.  The default rules
    split ``heads``, ``kv_heads``, ``mlp`` and ``vocab`` over ``model``
    (tensor parallelism); ``overrides`` map names first, as the
    reference's ``_rules_for(overrides=)`` (``{"mlp": None}`` keeps the
    MLP whole).  ``mesh``: a ``DeviceMesh``, an ``AbstractMesh`` or a
    sequence of axis names."""
    ov = dict(overrides or {})
    if get_arch(arch_id).family != "lm":
        return make_rules(mesh, ov)
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


def lm_rules(arch_id: str, shape: ShapeSpec, mesh,
             overrides: Optional[dict] = None) -> dict:
    """``rules_for`` of an LM cell; raises for another family."""
    if get_arch(arch_id).family != "lm":
        raise ValueError(f"{arch_id} is not an LM")
    return rules_for(arch_id, shape, mesh, overrides)


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


# ---------------------------------------------------------------------------
# cells: the step of every (arch, shape) and a rank's arguments
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Cell:
    """One (arch, shape) on a mesh, as ``repro/launch/steps.py::Cell``:
    ``fn(*args)`` is the port's step a production job would run, ``args``
    the arguments one rank passes (on the ``meta`` device: nothing is
    allocated), ``parts`` the same arguments by role (``params``,
    ``opt_state``, ``state``: other state the step carries, ``batch``),
    ``model_flops`` the useful-FLOPs count of the whole step (all ranks),
    by the reference's formulas.  ``fn`` makes its process groups on its
    first call, so a cell on an ``AbstractMesh`` builds but does not
    run."""
    arch_id: str
    shape_name: str
    fn: Callable
    args: Tuple[Any, ...]
    parts: Dict[str, Any]
    model_flops: float
    notes: str = ""
    ctx: Optional[ShardingCtx] = None


META = torch.device("meta")


def _meta_shard(shape, spec, ctx: ShardingCtx, dtype) -> torch.Tensor:
    """A rank's block of a leaf of ``shape`` under ``spec`` (equal blocks
    along each split dim), on ``meta``."""
    local = list(shape)
    for dim, axes in split_axes(spec):
        local[dim] //= ctx.size(axes)
    return torch.empty(local, dtype=dtype, device=META)


def _unflatten(flat: Dict[str, torch.Tensor]):
    """A tree of dicts (lists where every key is an index) from dotted
    names, as ``flatten_params`` flattens it."""
    root: Dict[str, Any] = {}
    for name, v in flat.items():
        node = root
        *path, last = name.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = v

    def fix(node):
        if not isinstance(node, dict):
            return node
        node = {k: fix(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node
    return fix(root)


def _lazy(build: Callable[[], Callable]) -> Callable:
    """A step that is made (with its process groups) on its first call."""
    made: list = []

    def step(*args, **kwargs):
        if not made:
            made.append(build())
        return made[0](*args, **kwargs)
    return step


def _meta_rows(n: int, ctx: ShardingCtx) -> int:
    """The rows of a batch of ``n`` that ``rank_rows`` gives this rank."""
    return LM.rank_rows(torch.empty((n,), device=META), ctx).shape[0]


def _lm_cell(arch, shape: ShapeSpec, mesh, cfg: Optional[LMConfig] = None
             ) -> Cell:
    cfg = cfg or arch.config
    ctx = ShardingCtx(rules_for(arch.arch_id, shape, mesh), mesh)
    B, S = shape.dims["global_batch"], shape.dims["seq_len"]
    dtype = LM.DTYPES[cfg.param_dtype]
    leaves, lay = LM._leaves(cfg), LM.param_layout(cfg, ctx)

    def mk(leaf, spec):
        return _meta_shard(leaf[0], spec, ctx, dtype)
    params = {k: mk(v, lay[k]) for k, v in leaves.items() if k != "layers"}
    params["layers"] = [{k: mk(v, ll[k]) for k, v in lv.items()}
                        for lv, ll in zip(leaves["layers"], lay["layers"])]
    n = cfg.n_active_params()
    if shape.step == "train":
        opt_state = O.make_optimizer(cfg.optimizer).init(
            LM.named_params(params))
        tokens = torch.empty((B, S), dtype=torch.int32, device=META)

        def build():
            opt = O.make_optimizer(cfg.optimizer,
                                   shards=LM.shard_groups(cfg, ctx))
            return lambda p, st, t: lm_train_step(p, cfg, opt, st, t, ctx)
        rows = _meta_rows(B, ctx)
        return Cell(arch.arch_id, shape.name, _lazy(build),
                    (params, opt_state, tokens),
                    dict(params=params, opt_state=opt_state, batch=tokens),
                    6.0 * n * B * S, ctx=ctx,
                    notes=f"train: every rank passes the whole (B, S) "
                          f"batch and takes its data rank's {rows} rows "
                          f"(rank_rows), as the reference shards the "
                          f"batch")
    if shape.step == "prefill":
        tokens = torch.empty((_meta_rows(B, ctx), S), dtype=torch.int32,
                             device=META)
        return Cell(arch.arch_id, shape.name,
                    lambda p, t: lm_prefill_step(p, cfg, t, ctx),
                    (params, tokens), dict(params=params, batch=tokens),
                    2.0 * n * B * S, ctx=ctx)
    rows = _meta_rows(B, ctx)
    caches = LM.init_kv_cache(cfg, rows, S, device=META, ctx=ctx)
    tokens = torch.empty((rows, 1), dtype=torch.int32, device=META)
    return Cell(arch.arch_id, shape.name,
                lambda p, c, t: lm_decode_step(p, cfg, c, t, ctx),
                (params, caches, tokens),
                dict(params=params, state=caches, batch=tokens),
                2.0 * n * B, ctx=ctx,
                notes="decode: 1 new token against a filled KV cache")


def _recsys_batch(cfg: RecsysConfig, B: int) -> Batch:
    """The reference's ``batch_sds`` of a recsys cell, on ``meta``."""
    def t(shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=META)
    f32 = torch.float32
    if cfg.kind == "dlrm":
        return {"dense": t((B, cfg.n_dense), f32),
                "sparse": t((B, cfg.n_sparse)), "labels": t((B,), f32)}
    if cfg.kind == "wide_deep":
        return {"sparse": t((B, cfg.n_sparse)), "labels": t((B,), f32)}
    if cfg.kind == "sasrec":
        return {"seq": t((B, cfg.seq_len)), "pos": t((B,)),
                "neg": t((B, 100))}
    return {"seq": t((B, cfg.seq_len)), "target": t((B,)),
            "other": t((B, cfg.n_sparse)), "labels": t((B,), f32)}


def _recsys_cell(arch, shape: ShapeSpec, mesh) -> Cell:
    cfg = arch.config
    ctx = ShardingCtx(rules_for(arch.arch_id, shape, mesh), mesh)
    B = shape.dims["batch"]
    dtype = R.DTYPES[cfg.param_dtype]
    lay = R.param_layout(cfg, ctx)
    params = _unflatten({
        k: _meta_shard(v[::-1] if R._linear_w(k) else v, lay[k], ctx, dtype)
        for k, v in R._ref_shapes(cfg).items()})
    flops = _recsys_flops(cfg, B)
    whole = "every rank passes the whole batch (the reference shards it)"
    if shape.step == "train":
        optimizer = O.rankgraph2_optimizer()
        opt_state = optimizer.init(R.flatten_params(params))
        batch = _recsys_batch(cfg, B)
        return Cell(arch.arch_id, shape.name,
                    lambda p, st, b: recsys_train_step(p, st, b, cfg,
                                                       optimizer, ctx),
                    (params, opt_state, batch),
                    dict(params=params, opt_state=opt_state, batch=batch),
                    3.0 * flops, notes=f"train: {whole}", ctx=ctx)
    if shape.name == "retrieval_cand":
        N = shape.dims["n_candidates"]
        batch = {k: v for k, v in _recsys_batch(cfg, 1).items()
                 if k not in ("labels", "pos", "neg")}
        cand = torch.empty((N,), dtype=torch.int32, device=META)
        return Cell(arch.arch_id, shape.name,
                    lambda p, b, c: recsys_retrieval_step(p, cfg, b, c,
                                                          100, ctx),
                    (params, batch, cand),
                    dict(params=params, batch=(batch, cand)),
                    2.0 * N * cfg.embed_dim, ctx=ctx,
                    notes="retrieval: query embedding vs 1M candidates, "
                          "each rank scores its block of the candidates "
                          "and the ranks merge their top k")
    batch = {k: v for k, v in _recsys_batch(cfg, B).items() if k != "labels"}
    if cfg.kind == "sasrec":
        batch = {"seq": batch["seq"]}
    return Cell(arch.arch_id, shape.name,
                lambda p, b: recsys_serve_step(p, cfg, b, ctx),
                (params, batch), dict(params=params, batch=batch), flops,
                notes=f"serve: {whole}", ctx=ctx)


def _recsys_flops(cfg: RecsysConfig, B: int) -> float:
    D = cfg.embed_dim
    if cfg.kind == "dlrm":
        dims = [cfg.n_dense, *cfg.bot_mlp]
        mlp = sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
        n_vec = cfg.n_sparse + 1
        inter = n_vec * n_vec * D * 2
        dims = [n_vec * (n_vec - 1) // 2 + cfg.bot_mlp[-1], *cfg.top_mlp]
        mlp += sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
        return float(B) * (mlp + inter)
    if cfg.kind == "wide_deep":
        dims = [cfg.n_sparse * D, *cfg.bot_mlp, 1]
        return float(B) * sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
    if cfg.kind == "sasrec":
        S = cfg.seq_len
        per_block = 2 * S * (4 * D * D) + 2 * 2 * S * S * D + 2 * S * 8 * D * D
        return float(B) * cfg.n_blocks * per_block
    S = cfg.seq_len + 1
    per_block = 2 * S * (4 * D * D) + 2 * 2 * S * S * D + 2 * S * 8 * D * D
    dims = [S * D + cfg.n_sparse * D, *cfg.top_mlp]
    mlp = sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
    return float(B) * (cfg.n_blocks * per_block + mlp)


@torch.no_grad()
def knn_retrieval_step(q: torch.Tensor, pool: torch.Tensor, k: int = 100,
                       ctx: Optional[ShardingCtx] = None,
                       n_total: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The online-KNN baseline that rankgraph2's cluster index replaces:
    one query (1, d) against ``pool`` (N, d), top ``k`` of
    ``dot_scores``.  Under ``ctx`` ``pool`` is this rank's
    ``block_rows`` block of ``n_total`` candidates split over the
    ``candidates`` rule's axes, and the ranks merge their top ``k``, as
    ``recsys_retrieval_step``.  Returns (scores, row indices of the
    whole pool)."""
    axes = _candidate_axes(ctx)
    start = C.block_rows(n_total, ctx.size(axes), ctx.axis_index(axes)
                         ).start if axes else 0
    return _merged_top_k(dot_scores(q, pool), start,
                         n_total or pool.shape[0], k, ctx)


def _round_up(n: int, m: int) -> int:
    """n rounded up to a multiple of m (at least m): the reference's
    pack sizes of the rankgraph2 train cell round to 128, not to the
    dataset's pad multiple."""
    return max(m, -(-n // m) * m)


@functools.lru_cache(maxsize=None)
def _rg2_whole_state(cfg: RankGraph2Config):
    """A whole rankgraph2 ``TrainState`` on ``meta`` (drawn once per
    config on the host, then moved: the init draws into host tensors)."""
    from repro_torch.core import trainer as T
    st, _ = T.init_state(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    return T.TrainState(st.params.to(META), _to_meta(st.opt_state),
                        _to_meta(st.rq_state), _to_meta(st.pool), 0)


def _to_meta(tree):
    """Every tensor of a tree (dicts, lists, tuples, named tuples and
    dataclasses) moved to ``meta``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(META)
    if isinstance(tree, dict):
        return {k: _to_meta(v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _to_meta(getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to_meta(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_meta(v) for v in tree)
    return tree


def _rg2_state(cfg: RankGraph2Config, ctx: ShardingCtx):
    """A rank's ``TrainState`` on ``meta``: ``shard_state`` of the whole
    one (its split parameters and their moments cut to the rank's
    blocks)."""
    import copy
    from repro_torch.core import trainer as T
    whole = _rg2_whole_state(cfg)
    st = T.TrainState(copy.deepcopy(whole.params), _to_meta(whole.opt_state),
                      _to_meta(whole.rq_state), _to_meta(whole.pool), 0)
    return T.shard_state(st, cfg, ctx)


def rankgraph2_train_batch(cfg: RankGraph2Config, B: int, device=META,
                           generator: Optional[torch.Generator] = None
                           ) -> Dict[str, Dict]:
    """The ``dedup`` batch of the rankgraph2 train cell: ``B`` edges of
    each type, packs sized as the reference's cell sizes them (``E =
    _round_up(3B * 6 // 10, 128)`` endpoint rows, ``U = 3E`` rows with the
    neighbour-only extras), carrying their features.  On ``meta``, or
    drawn from ``generator`` (features normal, indices and maps uniform
    in range, masks and weights in [0, 1)) for a run."""
    K = cfg.k_train
    E = _round_up(3 * B * 6 // 10, 128)
    U = 3 * E
    f32, i32 = torch.float32, torch.int32

    def t(shape, dtype, hi=None):
        """On meta, or drawn: integers in [0, hi) (indices, maps, and the
        masks' 0s and 1s), else features normal, weights in [0, 1)."""
        if generator is None:
            return torch.empty(shape, dtype=dtype, device=device)
        if hi is not None:
            x = torch.randint(0, hi, shape, generator=generator)
        elif len(shape) == 2:
            x = torch.randn(shape, generator=generator)
        else:
            x = torch.rand(shape, generator=generator)
        return x.to(dtype).to(device)

    def pack(d_feat):
        return {"unbr_idx": t((E, K), i32, U),
                "unbr_mask": t((E, K), f32, 2),
                "inbr_idx": t((E, K), i32, U),
                "inbr_mask": t((E, K), f32, 2), "feat": t((U, d_feat), f32)}

    def edges():
        return {"src_map": t((B,), i32, E), "dst_map": t((B,), i32, E),
                "weight": t((B,), f32), "src_ids": t((B,), i32, E),
                "dst_ids": t((B,), i32, E)}
    return {"nodes": {"user": pack(cfg.d_user_feat),
                      "item": pack(cfg.d_item_feat)},
            "edges": {et: edges() for et in ("ii", "ui", "uu")}}


def _rankgraph2_cell(arch, shape: ShapeSpec, mesh,
                     cfg: Optional[RankGraph2Config] = None) -> Cell:
    from repro_torch.core import model as M
    from repro_torch.core import rq_index as RQ
    from repro_torch.core import trainer as T
    cfg = cfg or arch.config
    ctx = ShardingCtx(rules_for(arch.arch_id, shape, mesh), mesh)
    st = _rg2_state(cfg, ctx)
    if shape.step == "train":
        B = shape.dims["batch"] // 3
        batch = rankgraph2_train_batch(cfg, B)
        E = batch["nodes"]["user"]["unbr_idx"].shape[0]
        dp = ctx.axis_size("batch")
        blk = C.block_rows(B, dp, 0)
        optimizer = O.rankgraph2_optimizer()
        return Cell(
            arch.arch_id, shape.name,
            _lazy(lambda: T.make_train_step(cfg, optimizer, ctx)),
            (st, batch),
            dict(params=st.params, opt_state=st.opt_state,
                 state=(st.rq_state, st.pool), batch=batch),
            3.0 * _rg2_dedup_train_flops(cfg, 3 * B, E, 3 * E), ctx=ctx,
            notes=f"train: dedup packs with features; every rank passes "
                  f"the whole batch and takes its block_rows of each edge "
                  f"type ({blk.stop - blk.start} of {B} over {dp} data "
                  f"ranks, the last fewer) with a pack of its own, where "
                  f"the reference's _safe keeps the {B} rows whole on "
                  f"every rank")
    if shape.name == "retrieval_cand":
        N = shape.dims["n_candidates"]
        axes = _candidate_axes(ctx)
        blk = C.block_rows(N, ctx.size(axes), ctx.axis_index(axes)) \
            if axes else slice(0, N)
        q = torch.empty((1, cfg.d_embed), device=META)
        pool = torch.empty((blk.stop - blk.start, cfg.d_embed), device=META)
        return Cell(arch.arch_id, shape.name,
                    lambda q_, p_: knn_retrieval_step(q_, p_, 100, ctx, N),
                    (q, pool), dict(batch=(q, pool)),
                    2.0 * N * cfg.d_embed, ctx=ctx,
                    notes="online-KNN baseline the cluster index replaces; "
                          "a rank holds its block of the candidates")
    B = shape.dims["batch"]
    axes = ctx.mesh_axes("batch")
    dp = ctx.size(axes) if axes else 1
    blk = C.block_rows(B, dp, ctx.axis_index(axes) if axes else 0)
    rows, K = blk.stop - blk.start, cfg.k_train
    side = {"feat": torch.empty((rows, cfg.d_user_feat), device=META),
            "unbr_feat": torch.empty((rows, K, cfg.d_user_feat),
                                     device=META),
            "unbr_mask": torch.empty((rows, K), device=META),
            "inbr_feat": torch.empty((rows, K, cfg.d_item_feat),
                                     device=META),
            "inbr_mask": torch.empty((rows, K), device=META)}

    @torch.no_grad()
    def step(params, side_):
        _, prim = M.embed_side(params, cfg, side_, M.USER, ctx)
        return prim, RQ.assign_codes(params["rq"], prim, cfg.rq)
    return Cell(arch.arch_id, shape.name, step, (st.params, side),
                dict(params=st.params, batch=side),
                _rg2_flops(cfg, B) / 3.0
                + 2.0 * B * cfg.d_embed * sum(cfg.rq.codebook_sizes),
                ctx=ctx,
                notes=f"embedding refresh + RQ cluster assignment; a rank "
                      f"embeds its {rows} of the {B} rows")


def _rg2_dedup_train_flops(cfg: RankGraph2Config, n_edges: int, E: int,
                           U: int) -> float:
    """Useful FLOPs of the dedup train forward: each pack row runs the
    type encoder once, each endpoint-unique row aggregates once, and the
    contrastive and RQ terms stay per edge."""
    de, h, H = cfg.d_embed, cfg.d_hidden, cfg.n_heads
    enc_u = 2 * cfg.d_user_feat * h + 2 * h * H * de
    enc_i = 2 * cfg.d_item_feat * h + 2 * h * H * de
    agg = H * 2 * 3 * de * de
    contrastive = 2 * cfg.n_negatives * de + 2 * de
    rq = 2 * de * sum(cfg.rq.codebook_sizes)
    return float(U * (enc_u + enc_i) + 2 * E * agg
                 + n_edges * (4 * contrastive + 2 * rq))


def _rg2_flops(cfg: RankGraph2Config, B: int) -> float:
    d, h, de, K = (cfg.d_user_feat, cfg.d_hidden, cfg.d_embed, cfg.k_train)
    H = cfg.n_heads
    enc = 2 * d * h + 2 * h * H * de
    per_node = (1 + 2 * K) * enc + H * 2 * 3 * de * de
    contrastive = 2 * cfg.n_negatives * de + 2 * de
    rq = 2 * de * sum(cfg.rq.codebook_sizes)
    return float(B) * (2 * per_node + 4 * contrastive + 2 * rq)


def build_cell(arch_id: str, shape_name: str, mesh, cfg=None) -> Cell:
    """The cell of ``arch_id`` at ``shape_name`` on ``mesh`` (a
    ``DeviceMesh`` to run it, an ``AbstractMesh`` to lay a rank's
    arguments out); ``cfg`` in place of the arch's config (a cut config,
    as the reference's ``_lm_cell(cfg=)`` takes its probes; LM and
    rankgraph2)."""
    arch = get_arch(arch_id)
    shape = arch.shape(shape_name)
    if arch.family == "lm":
        return _lm_cell(arch, shape, mesh, cfg)
    if arch.family == "recsys":
        return _recsys_cell(arch, shape, mesh)
    if arch.family == "rankgraph2":
        return _rankgraph2_cell(arch, shape, mesh, cfg)
    raise ValueError(arch.family)


def all_cells() -> List[Tuple[str, str]]:
    """Every (arch, shape) of the registry: the reference's cells less
    the four of ``equiformer-v2``, whose GNN family the port does not
    have yet (its ``_gnn_cell`` comes with it)."""
    from repro_torch.configs.base import list_archs
    return [(a, s.name) for a in list_archs() for s in get_arch(a).shapes]
