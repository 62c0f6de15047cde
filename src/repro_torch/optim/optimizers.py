"""The optimizer subset the RankGraph-2 train step uses, as
``repro/optim/optimizers.py``: ``clip_by_global_norm``, AdaGrad, AdamW,
``partition`` and ``rankgraph2_optimizer`` (paper §5.1: AdaGrad lr 0.02
on codebook and table parameters, AdamW lr 0.004 on the rest).

The updates are written out, formula for formula as the JAX package
computes them (``eps`` outside the square root, bias correction from a
shared step count, decoupled weight decay on the f32 parameter).
Optimizers are (init, update) pairs over flat dicts ``name -> tensor``:

    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    apply_updates(params, updates)      # in place
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch

Tree = Dict[str, torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable[[Tree], object]
    update: Callable[..., Tuple[Tree, object]]   # (grads, state, params)


@torch.no_grad()
def apply_updates(params: Tree, updates: Tree) -> None:
    """``p += u`` in place, in ``p``'s type."""
    for name, p in params.items():
        p.add_(updates[name].to(p.dtype))


def global_norm(tree: Tree) -> torch.Tensor:
    return torch.sqrt(torch.stack([
        torch.sum(torch.square(x.to(torch.float32))) for x in tree.values()
    ]).sum())


def clip_by_global_norm(grads: Tree, max_norm: float
                        ) -> Tuple[Tree, torch.Tensor]:
    """Scale every gradient by ``min(1, max_norm / (norm + 1e-9))``."""
    norm = global_norm(grads)
    scale = torch.clamp_max(max_norm / (norm + 1e-9), 1.0)
    return {k: g * scale for k, g in grads.items()}, norm


def _zeros(params: Tree) -> Tree:
    return {k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in params.items()}


def adagrad(lr: float = 0.02, eps: float = 1e-8) -> Optimizer:
    def init(params):
        return _zeros(params)

    def update(grads, state, params=None):
        state = {k: a + torch.square(grads[k].to(torch.float32))
                 for k, a in state.items()}
        upd = {k: -lr * grads[k].to(torch.float32) / (torch.sqrt(a) + eps)
               for k, a in state.items()}
        return upd, state

    return Optimizer(init, update)


class AdamState(NamedTuple):
    mu: Tree
    nu: Tree
    count: int


def adamw(lr: float = 0.004, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.01) -> Optimizer:
    def init(params):
        return AdamState(_zeros(params), _zeros(params), 0)

    def update(grads, state, params):
        c = state.count + 1
        mu = {k: b1 * m + (1 - b1) * grads[k].to(torch.float32)
              for k, m in state.mu.items()}
        nu = {k: b2 * v + (1 - b2) * torch.square(grads[k].to(torch.float32))
              for k, v in state.nu.items()}
        # the JAX package forms the corrections in float32
        f32 = torch.float32
        bc1 = 1 - torch.tensor(b1, dtype=f32) ** torch.tensor(c, dtype=f32)
        bc2 = 1 - torch.tensor(b2, dtype=f32) ** torch.tensor(c, dtype=f32)
        upd = {}
        for k, m in mu.items():
            dev = m.device
            step = m / bc1.to(dev) / (torch.sqrt(nu[k] / bc2.to(dev)) + eps)
            upd[k] = -lr * (step + weight_decay * params[k].to(f32))
        return upd, AdamState(mu, nu, c)

    return Optimizer(init, update)


def partition(predicate: Callable[[str, torch.Tensor], bool],
              opt_true: Optimizer, opt_false: Optimizer) -> Optimizer:
    """Route each parameter to one of two optimizers by (name, tensor)."""

    def _split(tree, params):
        t = {k: v for k, v in tree.items() if predicate(k, params[k])}
        f = {k: v for k, v in tree.items() if k not in t}
        return t, f

    def init(params):
        pt, pf = _split(params, params)
        return {"true": opt_true.init(pt), "false": opt_false.init(pf)}

    def update(grads, state, params):
        gt, gf = _split(grads, params)
        pt, pf = _split(params, params)
        ut, st = opt_true.update(gt, state["true"], pt)
        uf, sf = opt_false.update(gf, state["false"], pf)
        return {**ut, **uf}, {"true": st, "false": sf}

    return Optimizer(init, update)


def is_sparse(name: str, _=None) -> bool:
    """'Sparse' = any parameter whose name contains 'table' or
    'codebooks'."""
    return "table" in name or "codebooks" in name


def rankgraph2_optimizer(lr_sparse: float = 0.02, lr_dense: float = 0.004
                         ) -> Optimizer:
    """Paper §5.1: AdaGrad for sparse/embedding-like params, AdamW for
    dense ones."""
    return partition(is_sparse, adagrad(lr_sparse), adamw(lr_dense))
