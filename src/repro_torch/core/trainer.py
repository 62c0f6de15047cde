"""RankGraph-2 training step (paper §4.3 + §4.4 co-learning) and
embedding generation, as ``repro/core/trainer.py``.

One ``train_step`` consumes an id-only ``dedup_ids`` batch (all edge
types): every referenced node is encoded once from the device-resident
feature tables, endpoints are aggregated once, per-edge views are
gathers.  It computes the contrastive losses of every direction (U-I
both ways) through the ``fused_contrastive`` op, co-learns the RQ index
on all endpoint primaries (reconstruction, contrastive on the
reconstruction reusing each direction's negatives, balance regularizer,
utilization gap), combines everything with learned uncertainty weights,
clips, and applies the partitioned AdaGrad/AdamW update.

Unlike the JAX package's pure step, the port updates the state in
place: the parameters, optimizer moments, RQ histograms and pool are
rewritten where they lie, so no second copy of the state is held.  The
eval step (``make_eval_step``) and the dead-code reset
(``reset_dead_codes``, which writes re-seeded codebook rows into the
live parameters) follow the same rule.
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


# edge type -> (src node type, dst node type)
_ET_TYPES = {"uu": (M.USER, M.USER), "ui": (M.USER, M.ITEM),
             "ii": (M.ITEM, M.ITEM)}
_NODE_TYPES = (("user", M.USER), ("item", M.ITEM))


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take(x, idx, axis=0)`` for an index of any shape."""
    return x.index_select(0, idx.reshape(-1)).reshape(
        *idx.shape, *x.shape[1:])


def _dedup_per_type(params, cfg: RankGraph2Config, batch,
                    features: FeatureStore):
    """Unique-node forward: encode each pack row once, aggregate each
    endpoint-unique node once, gather per-(edge_type, side) views.
    Returns {et: (src_heads, src_prim, dst_heads, dst_prim)} with the
    edge types in sorted order, as the JAX step iterates them (a jitted
    function receives a dict with its keys sorted); the order decides
    which negative draws each direction gets, and the row order of the
    RQ batch and the pool update."""
    nodes, edges = batch["nodes"], batch["edges"]
    enc: Dict[str, torch.Tensor] = {}
    for tname, ntype in _NODE_TYPES:
        table = features.user_feat if ntype == M.USER else features.item_feat
        enc[tname] = M.encode_nodes(params, cfg, ntype,
                                    _take(table, nodes[tname]["ids"]))
    heads, prims = {}, {}
    for tname, ntype in _NODE_TYPES:
        side = nodes[tname]
        e_pad = side["unbr_idx"].shape[0]    # endpoint-unique rows first
        h = M.aggregate_nodes(
            params, cfg, ntype, enc[tname][:e_pad],
            _take(enc["user"], side["unbr_idx"]), side["unbr_mask"],
            _take(enc["item"], side["inbr_idx"]), side["inbr_mask"])
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


def loss_directions(batch) -> Tuple[str, ...]:
    """The contrastive directions of a batch, in the order their
    negatives are drawn: each edge type in sorted order (the order the
    jitted JAX step sees a batch dict in), with ``iu`` after ``ui``."""
    out = []
    for et in sorted(batch["edges"]):
        out.append(et)
        if et == "ui":
            out.append("iu")
    return tuple(out)


def forward_losses(params, cfg: RankGraph2Config, batch,
                   pool: N.NegPoolState, rq_state: RQ.RQState, *,
                   features: FeatureStore, train: bool = True,
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
                   rq_codes: Optional[torch.Tensor] = None):
    """Returns (task_losses, aux); aux carries the RQ state and the
    endpoint embeddings for the pool update.  ``draws`` maps each of
    ``loss_directions(batch)`` to its ``negatives.negative_draws``;
    missing ones are drawn from ``generator``.  ``rq_codes``, if given,
    are the RQ selections of the endpoint rows (``aux["codes"]`` of
    another call on the same batch; see ``rq_index.rq_forward``)."""
    tasks: Dict[str, torch.Tensor] = {}
    per_type = _dedup_per_type(params, cfg, batch, features)
    draws = draws or {}

    user_embs, item_embs = [], []
    endpoint_prims, endpoint_splits = [], []
    for et, (sh, sp, dh, dp) in per_type.items():
        st, dt = _ET_TYPES[et]
        (user_embs if st == M.USER else item_embs).append(sp)
        (user_embs if dt == M.USER else item_embs).append(dp)
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

    dir_negs = {}
    for suffix, sp_, dp_, dh_, dt_ in loss_dirs:
        buf = pool.user if dt_ == M.USER else pool.item
        fill = pool.user_fill if dt_ == M.USER else pool.item_fill
        negs = N.sample_negatives(dp_, dh_, buf, fill, cfg.n_negatives,
                                  cfg.n_pool_neg, draws=draws.get(suffix),
                                  generator=generator)
        dir_negs[suffix] = negs
        marg, info = _pair(sp_, dp_, negs)
        tasks[f"margin_{suffix}"] = marg.mean()
        tasks[f"infonce_{suffix}"] = info.mean()

    # --- RQ co-learning on all endpoint embeddings -----------------------
    all_prim = torch.cat(endpoint_prims, dim=0)
    rq_out = RQ.rq_forward(params["rq"], rq_state, all_prim, cfg.rq,
                           train=train, codes=rq_codes)
    tasks["rq_recon"] = rq_out["l_recon"]
    tasks["rq_reg"] = rq_out["l_reg"]
    if cfg.rq.util_coef > 0:
        tasks["rq_util"] = rq_out["l_util"]
    # contrastive on reconstructed embeddings (L'), straight-through to
    # the encoder, reusing each direction's negative bank
    if not cfg.reuse_lprime_negatives:
        raise NotImplementedError("the port reuses each direction's "
                                  "negatives for L' (the JAX default)")
    recon_st = rq_out["recon_st"]
    offs = np.cumsum([0] + [p.shape[0] for p in endpoint_prims])
    recon_parts = {key: recon_st[lo:hi] for key, lo, hi
                   in zip(endpoint_splits, offs[:-1], offs[1:])}
    lprime = []
    for et in per_type:
        marg, info = _pair(recon_parts[(et, "src")],
                           recon_parts[(et, "dst")], dir_negs[et])
        lprime.append((0.5 * marg + 0.5 * info).mean())
    tasks["rq_contrastive"] = torch.stack(lprime).mean()

    aux = dict(rq_state=rq_out["state"],
               user_emb=torch.cat(user_embs) if user_embs else None,
               item_emb=torch.cat(item_embs) if item_embs else None,
               codes=rq_out["codes"])
    return tasks, aux


def make_train_step(cfg: RankGraph2Config, optimizer: opt_lib.Optimizer,
                    *, features: FeatureStore, grad_clip: float = 1.0):
    """Builds ``train_step(state, batch, *, generator=None, draws=None)
    -> (state, metrics)``; ``metrics`` are 0-d device tensors (reading
    them is the caller's sync)."""

    def train_step(state: TrainState, batch, *,
                   generator: Optional[torch.Generator] = None,
                   draws=None):
        params = named_params(state.params)
        for p in params.values():
            p.grad = None
        tasks, aux = forward_losses(state.params, cfg, batch, state.pool,
                                    state.rq_state, features=features,
                                    train=True, generator=generator,
                                    draws=draws)
        total = L.uncertainty_combine(tasks, state.params["uncertainty"])
        total.backward()
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}
        grads, gnorm = opt_lib.clip_by_global_norm(grads, grad_clip)
        with torch.no_grad():
            updates, state.opt_state = optimizer.update(
                grads, state.opt_state, params)
            opt_lib.apply_updates(params, updates)
        for p in params.values():
            p.grad = None
        N.update_pool(state.pool, aux["user_emb"], aux["item_emb"])
        state.rq_state = aux["rq_state"]
        state.step += 1
        metrics = {k: v.detach() for k, v in tasks.items()}
        metrics["total"] = total.detach()
        metrics["grad_norm"] = gnorm.detach()
        return state, metrics

    return train_step


def make_eval_step(cfg: RankGraph2Config, *, features: FeatureStore):
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
              ids: np.ndarray, batch: int = 4096) -> torch.Tensor:
    """Primary embeddings (len(ids), d_embed) in ``cfg.dtype`` on the
    dataset's device, for global node ids.

    Every chunk is padded to the fixed ``batch`` by repeating its last
    id, as the JAX package does: the neighbour draw of a chunk depends
    on its padded shape, so the same rule gives the same draws."""
    ids = np.asarray(ids)
    out = []
    for lo in range(0, len(ids), batch):
        chunk = ids[lo:lo + batch]
        pad = batch - len(chunk)
        if pad:
            chunk = np.r_[chunk, np.repeat(chunk[-1:], pad)]
        side = dataset.node_inference_batch(chunk)
        _, prim = M.embed_side(params, cfg, side, node_type)
        out.append(prim[: len(prim) - pad] if pad else prim)
    if not out:
        return torch.empty((0, cfg.d_embed), dtype=M.DTYPES[cfg.dtype],
                           device=dataset.device)
    return torch.cat(out, dim=0)
