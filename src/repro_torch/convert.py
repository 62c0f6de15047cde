"""State of the JAX package, as trees of numpy arrays, to the port.

``params_from_jax`` covers the encoders ``f_user`` / ``f_item``, the
aggregators ``agg_user`` / ``agg_item``, the RQ codebooks
``rq.codebooks.layer{l}`` and the learned log-variances
``uncertainty``.  The JAX ``linear`` keeps ``w`` as ``(d_in, d_out)``
and computes ``x @ w``; ``nn.Linear`` keeps ``(d_out, d_in)``, so ``w``
is transposed here.  ``rq_state_from_jax`` and ``pool_from_jax`` carry
the RQ histograms and the negative pool over, and
``train_state_from_jax`` a whole ``TrainState`` (parameters, the
optimizer's moments, RQ state, pool, step), so the port can start a
train step or a lifecycle runtime from the exact JAX state.  ``recsys_params_from_jax`` carries
a recsys model's tree over (MLP ``w`` transposed, everything else as
it is).  ``lm_params_from_jax`` carries a dense LM's tree over, its
stacked layers split into one dict per layer.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.losses import TASKS
from repro_torch.core.model import DTYPES, Aggregator, Encoder
from repro_torch.core.negatives import NegPoolState
from repro_torch.core.rq_index import RQState, codebooks_module
from repro_torch.core.trainer import TrainState, named_params
from repro_torch.optim.optimizers import AdamState, is_sparse
from repro_torch.kernels.common import resolve_device


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    dtype = DTYPES.get(a.dtype.name, torch.float32)
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


def _linear(p: Dict[str, Any]) -> torch.nn.Linear:
    w = _tensor(p["w"])                                     # (d_in, d_out)
    lin = torch.nn.utils.skip_init(torch.nn.Linear, w.shape[0], w.shape[1],
                                   dtype=w.dtype)
    with torch.no_grad():
        lin.weight.copy_(w.T)
        lin.bias.copy_(_tensor(p["b"]))
    return lin


def params_from_jax(tree: Dict[str, Any], *, device=None,
                    trainable: bool = False) -> torch.nn.ModuleDict:
    """JAX params tree (numpy leaves) -> ``ModuleDict`` with the same
    keys, on ``device``; ``trainable`` turns gradients on."""
    n_heads, _, d_embed = np.shape(tree["agg_user"]["w"])
    out = torch.nn.ModuleDict()
    for name in ("f_user", "f_item"):
        p = tree[name]
        out[name] = Encoder(_linear(p["l1"]), _linear(p["l2"]),
                            n_heads, d_embed)
    for name in ("agg_user", "agg_item"):
        out[name] = Aggregator(_tensor(tree[name]["w"]),
                               _tensor(tree[name]["b"]))
    if "rq" in tree:
        books = tree["rq"]["codebooks"]
        out["rq"] = codebooks_module(
            [_tensor(books[f"layer{l}"]) for l in range(len(books))])
    if "uncertainty" in tree:
        unc = tree["uncertainty"]
        out["uncertainty"] = torch.nn.ParameterDict({
            t: torch.nn.Parameter(_tensor(unc[t])) for t in TASKS
            if t in unc})
    return out.to(resolve_device(device)).requires_grad_(trainable)


def _f32(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)


def rq_state_from_jax(state, *, device=None) -> RQState:
    """A JAX ``RQState`` (hists, usage, ptr, filled) -> the port's."""
    dev = resolve_device(device)
    return RQState(tuple(_f32(h, dev) for h in state.hists),
                   tuple(_f32(u, dev) for u in state.usage),
                   int(state.ptr), int(state.filled))


def pool_from_jax(pool, *, device=None) -> NegPoolState:
    """A JAX ``NegPoolState`` -> the port's (rings as f32 tensors)."""
    dev = resolve_device(device)
    return NegPoolState(_f32(pool.user, dev), _f32(pool.item, dev),
                        int(pool.user_ptr), int(pool.item_ptr),
                        int(pool.user_fill), int(pool.item_fill))


def _moments_from_jax(tree, like: Dict[str, torch.Tensor], dev
                      ) -> Dict[str, torch.Tensor]:
    """One optimizer-moment tree (the params tree's structure; the JAX
    ``partition`` leaves a 0-d zero where a leaf is routed to the other
    optimizer) -> ``name -> tensor`` over the names of ``like``, laid
    out as the port's parameters (linear ``w`` transposed)."""
    def fill(t, p):
        if isinstance(t, dict):
            return {k: fill(v, p[k]) for k, v in t.items()}
        t = np.asarray(t, np.float32)
        return np.zeros(np.shape(p), np.float32) if t.shape != np.shape(p) \
            else t
    return {k: v.detach().to(torch.float32) for k, v in named_params(
        params_from_jax(fill(tree, like), device=dev)).items()}


def train_state_from_jax(state, *, device=None) -> TrainState:
    """A JAX ``TrainState`` (``rankgraph2_optimizer``'s partitioned
    AdaGrad/AdamW state) -> the port's, on ``device``, with gradients
    on: parameters and every moment in the port's layout, the AdamW
    count, RQ state, pool and step as they are."""
    dev = resolve_device(device)
    tree = state.params
    params = params_from_jax(tree, device=dev, trainable=True)
    sparse, dense = state.opt_state["true"], state.opt_state["false"]
    acc = _moments_from_jax(sparse, tree, dev)
    mu = _moments_from_jax(dense.mu, tree, dev)
    nu = _moments_from_jax(dense.nu, tree, dev)
    opt_state = {"true": {k: v for k, v in acc.items() if is_sparse(k)},
                 "false": AdamState(
                     {k: v for k, v in mu.items() if not is_sparse(k)},
                     {k: v for k, v in nu.items() if not is_sparse(k)},
                     int(np.asarray(dense.count)))}
    return TrainState(params, opt_state,
                      rq_state_from_jax(state.rq_state, device=dev),
                      pool_from_jax(state.pool, device=dev),
                      int(np.asarray(state.step)))


RECSYS_KEYS = {"dlrm": {"tables", "bot", "top"},
               "wide_deep": {"tables", "wide", "deep"},
               "sasrec": {"items", "pos", "blocks"},
               "bst": {"items", "pos", "other", "blocks", "mlp"}}


def _recsys_tree(tree, dev):
    if isinstance(tree, dict):
        if set(tree) == {"w", "b"}:                  # a linear layer
            return {"w": _tensor(tree["w"]).T.contiguous().to(dev),
                    "b": _tensor(tree["b"]).to(dev)}
        return {k: _recsys_tree(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_recsys_tree(v, dev) for v in tree]
    return _tensor(tree).to(dev)


def recsys_params_from_jax(tree: Dict[str, Any], kind: str, *,
                           device=None) -> Dict[str, Any]:
    """A JAX recsys params tree (numpy leaves) of model ``kind`` (dlrm,
    wide_deep, sasrec, bst) -> the port's tree on ``device``: linear
    layers ``{"w", "b"}`` with ``w`` transposed to ``(d_out, d_in)``;
    tables and the attention matrices as they are."""
    if set(tree) != RECSYS_KEYS[kind]:
        raise ValueError(f"a {kind} tree has keys {sorted(RECSYS_KEYS[kind])}"
                         f", got {sorted(tree)}")
    return _recsys_tree(tree, resolve_device(device))


def lm_params_from_jax(tree: Dict[str, Any], *, device=None
                       ) -> Dict[str, Any]:
    """A JAX dense-LM params tree (numpy leaves; ``layers`` stacked
    (L, ...) from ``scan_layers=True``, or a list of per-layer dicts) ->
    the port's tree on ``device``: the same keys and layout (``x @ w``),
    ``layers`` a list of per-layer dicts."""
    dev = resolve_device(device)
    layers = tree["layers"]
    if isinstance(layers, dict):
        n = len(next(iter(layers.values())))
        layers = [{k: v[i] for k, v in layers.items()} for i in range(n)]
    out = {k: _tensor(v).to(dev) for k, v in tree.items() if k != "layers"}
    out["layers"] = [{k: _tensor(v).to(dev) for k, v in lp.items()}
                     for lp in layers]
    return out
