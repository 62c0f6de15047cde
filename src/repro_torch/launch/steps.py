"""The recsys steps a production job runs, as the functions
``repro/launch/steps.py::_recsys_cell`` builds (without its mesh,
shardings and shape stand-ins):

  * ``recsys_train_step``: loss, gradients, ``clip_by_global_norm(1.0)``
    and the ``rankgraph2_optimizer`` update (AdaGrad on ``tables``,
    AdamW on the rest), applied to the parameters in place;
  * ``recsys_serve_step``: forward scoring of a request batch (for
    sasrec the user representation);
  * ``recsys_retrieval_step``: one query representation against the
    candidate items, top k (100) with the lowest index first among equal
    scores, as ``jax.lax.top_k``.

Batches are dicts of tensors on the parameters' device: ``dense``,
``sparse`` ((B, F) ids, or (B, F, L) multi-hot bags for dlrm) and
``labels`` for dlrm / wide_deep; ``seq``, ``pos``, ``neg`` for sasrec;
``seq``, ``target``, ``other``, ``labels`` for bst.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import RecsysConfig
from repro_torch.models.recsys import models as R
from repro_torch.optim import optimizers as O

Batch = Dict[str, torch.Tensor]


def recsys_forward(params: R.Params, cfg: RecsysConfig,
                   batch: Batch) -> torch.Tensor:
    kind = cfg.kind
    if kind == "dlrm":
        return R.dlrm_forward(params, cfg, batch["dense"], batch["sparse"])
    if kind == "wide_deep":
        return R.wide_deep_forward(params, cfg, None, batch["sparse"])
    if kind == "sasrec":
        return R.sasrec_user_repr(params, cfg, batch["seq"])
    return R.bst_forward(params, cfg, batch["seq"], batch["target"],
                         batch["other"])


def recsys_loss(params: R.Params, cfg: RecsysConfig,
                batch: Batch) -> torch.Tensor:
    if cfg.kind == "sasrec":
        return R.sasrec_loss(params, cfg, batch["seq"], batch["pos"],
                             batch["neg"])
    return R.bce_loss(recsys_forward(params, cfg, batch), batch["labels"])


def loss_and_grads(params: R.Params, cfg: RecsysConfig, batch: Batch
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The loss and the gradient of every parameter, by dotted name."""
    flat = R.flatten_params(params)
    for p in flat.values():
        p.requires_grad_(True)
    loss = recsys_loss(params, cfg, batch)
    grads = torch.autograd.grad(loss, list(flat.values()))
    return loss.detach(), dict(zip(flat, grads))


def recsys_train_step(params: R.Params, opt_state, batch: Batch,
                      cfg: RecsysConfig, optimizer: O.Optimizer
                      ) -> Tuple[torch.Tensor, object]:
    """One step; updates ``params`` in place (the JAX step returns new
    ones) and returns (loss, new optimizer state).  ``optimizer`` is
    ``rankgraph2_optimizer()``, its state ``optimizer.init(
    flatten_params(params))``."""
    loss, grads = loss_and_grads(params, cfg, batch)
    flat = R.flatten_params(params)
    with torch.no_grad():
        grads, _ = O.clip_by_global_norm(grads, 1.0)
        upd, opt_state = optimizer.update(grads, opt_state, flat)
        del grads
        O.apply_updates(flat, upd)
    return loss, opt_state


@torch.no_grad()
def recsys_serve_step(params: R.Params, cfg: RecsysConfig,
                      batch: Batch) -> torch.Tensor:
    """Logits (B,) in the compute type; for sasrec (B, D) user
    representations."""
    return recsys_forward(params, cfg, batch)


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
