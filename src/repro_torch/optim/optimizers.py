"""The optimizer library of ``repro/optim/optimizers.py``:
``clip_by_global_norm``, SGD, AdaGrad, AdamW, Adafactor, ``partition``,
``rankgraph2_optimizer`` (paper §5.1: AdaGrad lr 0.02 on codebook and
table parameters, AdamW lr 0.004 on the rest) and ``make_optimizer``.

The updates are written out, formula for formula as the JAX package
computes them (``eps`` outside the square root, bias correction from a
shared step count, decoupled weight decay on the f32 parameter;
Adafactor's factored second moments, ``1 - c^-decay`` decay, ``c^-1/2``
step rate and RMS update clipping).  Optimizers are (init, update) pairs
over flat dicts ``name -> tensor``:

    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    apply_updates(params, updates)      # in place

or, with the same values and one parameter's temporaries at a time,

    state = apply_leafwise(opt, grads, state, params)
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

Tree = Dict[str, torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable[[Tree], object]
    update: Callable[..., Tuple[Tree, object]]   # (grads, state, params)


@torch.no_grad()
def apply_updates(params: Tree, updates: Tree) -> None:
    """``p += u`` in place, in ``p``'s type."""
    for name, p in params.items():
        p.add_(updates[name].to(p.dtype))


def global_norm(tree: Tree, sharded: Sequence[str] = (),
                group=None) -> torch.Tensor:
    """The f32 L2 norm of every leaf together.  The leaves named in
    ``sharded`` are this rank's shards of tensors split over the process
    group ``group``: their squared norms are summed over the group, so
    every rank gets the whole tree's norm."""
    sq = {k: torch.sum(torch.square(x.to(torch.float32)))
          for k, x in tree.items()}
    if sharded:
        part = torch.stack([sq[k] for k in sharded])
        dist.all_reduce(part, group=group)
        sq.update(zip(sharded, part.unbind()))
    return torch.sqrt(torch.stack(list(sq.values())).sum())


def clip_by_global_norm(grads: Tree, max_norm: float,
                        sharded: Sequence[str] = (), group=None
                        ) -> Tuple[Tree, torch.Tensor]:
    """Scale every gradient by ``min(1, max_norm / (norm + 1e-9))``;
    ``sharded`` and ``group`` as in ``global_norm``."""
    norm = global_norm(grads, sharded, group)
    scale = torch.clamp_max(max_norm / (norm + 1e-9), 1.0)
    return {k: g * scale for k, g in grads.items()}, norm


@torch.no_grad()
def clip_by_global_norm_(grads: Tree, max_norm: float) -> torch.Tensor:
    """``clip_by_global_norm`` in place; returns the norm.  An f32
    gradient is scaled where it lies; any other is replaced, one at a
    time, by its f32 product, the type the JAX package's ``g * scale``
    promotes a bf16 gradient to (scaling a bf16 gradient where it lies
    would round the product to bf16)."""
    norm = global_norm(grads)
    scale = torch.clamp_max(max_norm / (norm + 1e-9), 1.0)
    for k, g in grads.items():
        if g.dtype == torch.float32:
            g.mul_(scale)
        else:
            grads[k] = g.to(torch.float32).mul_(scale)
    return norm


def _zeros(params: Tree) -> Tree:
    return {k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in params.items()}


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    def init(params):
        return _zeros(params) if momentum else ()

    def update(grads, state, params=None):
        if momentum:
            state = {k: momentum * m + grads[k].to(torch.float32)
                     for k, m in state.items()}
            return {k: -lr * m for k, m in state.items()}, state
        return {k: -lr * g.to(torch.float32) for k, g in grads.items()}, state

    return Optimizer(init, update)


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


class FactorState(NamedTuple):
    vr: Tree      # row statistics (the full v for parameters below 2-D)
    vc: Tree      # column statistics (0-d zeros below 2-D)
    count: int


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def adafactor(lr: float = 0.01, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0,
              lr_schedule: bool = True) -> Optimizer:
    """Shazeer & Stern: second moments factored over the last two dims
    (row and column means of g^2 + eps) for parameters of 2 dims or more,
    full for the rest; decay ``beta = 1 - c^-decay``; the update divided
    by ``max(1, rms / clip_threshold)``, ``rms = sqrt(mean(step^2) +
    1e-12)``; with ``lr_schedule`` the rate ``lr / sqrt(c)``.  The step's
    scalars are formed in f32, as the JAX package forms them.  Each
    parameter is its own leaf, as the port's LM keeps one a layer: the
    JAX package's numbers for a model with ``scan_layers=False``; over
    stacked (L, ...) leaves its factors and clipping span the layers."""

    def init(params):
        f32 = torch.float32
        vr = {k: torch.zeros(p.shape[:-1], dtype=f32, device=p.device)
              if p.dim() >= 2 else torch.zeros_like(p, dtype=f32)
              for k, p in params.items()}
        vc = {k: torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=f32,
                             device=p.device)
              if p.dim() >= 2 else torch.zeros((), dtype=f32,
                                               device=p.device)
              for k, p in params.items()}
        return FactorState(vr, vc, 0)

    def leaf(g, vr, vc, beta, one_m_beta, step_lr):
        """(update, new vr, new vc) of one parameter; the f32 temporaries
        are freed as soon as the next one exists."""
        g32 = g.to(torch.float32)
        g2 = torch.square(g32).add_(eps)
        if g.dim() >= 2:
            nvr = beta * vr + one_m_beta * torch.mean(g2, dim=-1)
            nvc = beta * vc + one_m_beta * torch.mean(g2, dim=-2)
            del g2
            rfac = torch.rsqrt(nvr / torch.mean(nvr, dim=-1, keepdim=True)
                               + eps)
            cfac = torch.rsqrt(nvc + eps)
            step = (g32 * rfac[..., None]).mul_(cfac[..., None, :])
        else:
            nvr = beta * vr + one_m_beta * g2
            nvc = vc
            step = g32 * torch.rsqrt(nvr + eps)
        del g32
        rms = torch.sqrt(torch.mean(torch.square(step)) + 1e-12)
        step.div_(torch.clamp_min(rms / clip_threshold, 1.0))
        return step.mul_(-step_lr), nvr, nvc

    def update(grads, state, params=None):
        c = state.count + 1
        c32 = _f32(float(c))
        beta_t = 1.0 - c32 ** -decay
        beta, one_m_beta = beta_t.item(), (1.0 - beta_t).item()
        step_lr = (lr * torch.rsqrt(c32) if lr_schedule else _f32(lr)).item()
        upd, vr, vc = {}, {}, {}
        for k, g in grads.items():
            upd[k], vr[k], vc[k] = leaf(g, state.vr[k], state.vc[k], beta,
                                        one_m_beta, step_lr)
        return upd, FactorState(vr, vc, c)

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


def make_optimizer(name: str, lr: Optional[float] = None) -> Optimizer:
    """The optimizer a config names, at ``lr`` or the JAX package's
    default rate for it (adamw 3e-4, adagrad 0.02, adafactor 0.01, sgd
    0.1; rankgraph2 at its own two rates)."""
    if name == "adamw":
        return adamw(lr or 3e-4)
    if name == "adagrad":
        return adagrad(lr or 0.02)
    if name == "adafactor":
        return adafactor(lr or 0.01)
    if name == "sgd":
        return sgd(lr or 0.1)
    if name == "rankgraph2":
        return rankgraph2_optimizer()
    raise ValueError(f"unknown optimizer {name!r}")


# ---------------------------------------------------------------------------
# one parameter at a time
# ---------------------------------------------------------------------------

def _per_param(d: dict) -> bool:
    """A dict of per-parameter tensors (an optimizer's moments), not one
    of sub-states (``partition``'s)."""
    return all(isinstance(v, torch.Tensor) for v in d.values())


def _leaf_state(state, name: str):
    """The part of ``state`` that parameter ``name`` owns: each
    per-parameter dict cut to its entry (or to nothing); step counts as
    they are."""
    if isinstance(state, dict):
        if _per_param(state):
            return {name: state[name]} if name in state else {}
        return {k: _leaf_state(v, name) for k, v in state.items()}
    if isinstance(state, tuple):
        parts = [_leaf_state(s, name) for s in state]
        return type(state)(*parts) if hasattr(state, "_fields") \
            else tuple(parts)
    return state


def _put_leaf(state, new):
    """``new`` (a state of one parameter) written into ``state``: its
    entries into the per-parameter dicts, in place; step counts from
    ``new``."""
    if isinstance(state, dict):
        if _per_param(state):
            state.update(new)
            return state
        return {k: _put_leaf(v, new[k]) for k, v in state.items()}
    if isinstance(state, tuple):
        parts = [_put_leaf(s, n) for s, n in zip(state, new)]
        return type(state)(*parts) if hasattr(state, "_fields") \
            else tuple(parts)
    return new


@torch.no_grad()
def apply_leafwise(opt: Optimizer, grads: Tree, state, params: Tree):
    """``opt.update`` over ``grads`` then ``apply_updates``, one parameter
    at a time: each parameter's update is formed (``opt.update`` on that
    parameter alone, from the step's own count), added to it in place and
    dropped before the next, and its gradient is popped from ``grads``, so
    the peak holds the parameters, the gradients, the state and one
    parameter's temporaries.  The values are bitwise those of the
    whole-dict form (every optimizer here updates each parameter from its
    own gradient, state and the shared count alone); the step is counted
    once.  The state's per-parameter dicts are updated in place; returns
    the new state."""
    out = state           # the counts of ``state`` stay the step's own
    for name, p in params.items():
        upd, new = opt.update({name: grads.pop(name)},
                              _leaf_state(state, name), {name: p})
        p.add_(upd.pop(name).to(p.dtype))
        out = _put_leaf(out, new)
    return out
