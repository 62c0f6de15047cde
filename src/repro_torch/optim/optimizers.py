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

On shards (the LM family under a mesh): each rank holds a block of some
parameters, and ``shards`` maps a name to the process group each dim is
split over (None where whole; ``models.lm.model.shard_groups``).  A
shard's update is then the matching block of the whole parameter's:
AdamW, SGD and AdaGrad are elementwise; ``adafactor(shards=)`` reduces
its factored means and its RMS clip over the groups; and
the clip's norm (``global_norm(shards=)``) counts each parameter's
squares once.
"""
from __future__ import annotations

from typing import (Any, Callable, Dict, Mapping, NamedTuple, Optional,
                    Tuple)

import torch
import torch.distributed as dist

Tree = Dict[str, torch.Tensor]
Shards = Mapping[str, Tuple[Any, ...]]     # name -> a group or None a dim


class Optimizer(NamedTuple):
    init: Callable[[Tree], object]
    update: Callable[..., Tuple[Tree, object]]   # (grads, state, params)
    # the layout an optimizer that reduces within a parameter (Adafactor)
    # was made for ({}: every parameter whole); None for an elementwise
    # one, which suits any layout
    shards: Optional[Shards] = None


@torch.no_grad()
def apply_updates(params: Tree, updates: Tree) -> None:
    """``p += u`` in place, in ``p``'s type."""
    for name, p in params.items():
        p.add_(updates[name].to(p.dtype))


def check_shards(opt: Optimizer, shards: Optional[Shards]) -> None:
    """Raise unless ``opt`` suits parameters laid out as ``shards`` (None:
    every parameter whole): an elementwise optimizer suits any layout,
    Adafactor only the one it was made for (its groups compared by their
    ranks)."""
    if opt.shards is None:
        return

    def split(sh):
        return {k: tuple(None if g is None
                         else tuple(dist.get_process_group_ranks(g))
                         for g in v)
                for k, v in (sh or {}).items()
                if any(g is not None for g in v)}
    if split(opt.shards) != split(shards):
        raise ValueError("the optimizer was made for another layout of the "
                         "parameters: make it with make_optimizer(name, "
                         "shards=) from the step's layout")


def _split_groups(groups) -> list:
    """The distinct groups of a parameter's per-dim groups, in dim order."""
    out = []
    for g in groups or ():
        if g is not None and all(g is not h for h in out):
            out.append(g)
    return out


def global_norm(tree: Tree, shards: Optional[Shards] = None
                ) -> torch.Tensor:
    """The f32 L2 norm of every leaf together.  With ``shards`` (module
    docstring) each leaf is this rank's block of a split parameter: the
    squares of the leaves split over the same groups are summed over
    them and those of a leaf split over none are counted once, so every
    rank gets the whole tree's norm."""
    sq = {k: torch.sum(torch.square(x.to(torch.float32)))
          for k, x in tree.items()}
    if not shards:
        return torch.sqrt(torch.stack(list(sq.values())).sum())
    by: Dict[tuple, tuple] = {}
    for k, v in sq.items():
        groups = _split_groups(shards.get(k))
        by.setdefault(tuple(map(id, groups)), (groups, []))[1].append(v)
    parts = []
    for groups, vals in by.values():
        part = torch.stack(vals).sum()
        for g in groups:
            dist.all_reduce(part, group=g)
        parts.append(part)
    return torch.sqrt(torch.stack(parts).sum())


def clip_by_global_norm(grads: Tree, max_norm: float,
                        shards: Optional[Shards] = None
                        ) -> Tuple[Tree, torch.Tensor]:
    """Scale every gradient by ``min(1, max_norm / (norm + 1e-9))``;
    ``shards`` as in ``global_norm``."""
    norm = global_norm(grads, shards)
    scale = torch.clamp_max(max_norm / (norm + 1e-9), 1.0)
    return {k: g * scale for k, g in grads.items()}, norm


@torch.no_grad()
def clip_by_global_norm_(grads: Tree, max_norm: float,
                         shards: Optional[Shards] = None) -> torch.Tensor:
    """``clip_by_global_norm`` in place; returns the norm.  An f32
    gradient is scaled where it lies; any other is replaced, one at a
    time, by its f32 product, the type the JAX package's ``g * scale``
    promotes a bf16 gradient to (scaling a bf16 gradient where it lies
    would round the product to bf16)."""
    norm = global_norm(grads, shards)
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


def _mean(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The mean over ``dim`` of a tensor split along it over ``group`` in
    equal blocks (None: held whole)."""
    m = torch.mean(t, dim=dim)
    if group is not None:
        dist.all_reduce(m, group=group)
        m = m / dist.get_world_size(group)
    return m


def adafactor(lr: float = 0.01, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0,
              lr_schedule: bool = True,
              shards: Optional[Shards] = None) -> Optimizer:
    """Shazeer & Stern: second moments factored over the last two dims
    (row and column means of g^2 + eps) for parameters of 2 dims or more,
    full for the rest; decay ``beta = 1 - c^-decay``; the update divided
    by ``max(1, rms / clip_threshold)``, ``rms = sqrt(mean(step^2) +
    1e-12)``; with ``lr_schedule`` the rate ``lr / sqrt(c)``.  The step's
    scalars are formed in f32, as the JAX package forms them.  Each
    parameter is its own leaf, as the port's LM keeps one a layer: the
    JAX package's numbers for a model with ``scan_layers=False``; over
    stacked (L, ...) leaves its factors and clipping span the layers.
    With ``shards`` a parameter's block gets its block of the whole
    parameter's update: the row and column means of ``g^2`` and the mean
    of the row statistics are reduced over the group of the dim they
    cross, and the RMS of the update over every group the parameter is
    split over."""

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

    def leaf(g, vr, vc, beta, one_m_beta, step_lr, groups=None):
        """(update, new vr, new vc) of one parameter (its block split over
        ``groups``, one a dim); the f32 temporaries are freed as soon as
        the next one exists."""
        groups = groups or (None,) * g.dim()
        g32 = g.to(torch.float32)
        g2 = torch.square(g32).add_(eps)
        if g.dim() >= 2:
            nvr = beta * vr + one_m_beta * _mean(g2, -1, groups[-1])
            nvc = beta * vc + one_m_beta * _mean(g2, -2, groups[-2])
            del g2
            rfac = torch.rsqrt(nvr / _mean(nvr, -1, groups[-2])[..., None]
                               + eps)
            cfac = torch.rsqrt(nvc + eps)
            step = (g32 * rfac[..., None]).mul_(cfac[..., None, :])
        else:
            nvr = beta * vr + one_m_beta * g2
            nvc = vc
            step = g32 * torch.rsqrt(nvr + eps)
        del g32
        ms = torch.mean(torch.square(step))
        for grp in _split_groups(groups):
            dist.all_reduce(ms, group=grp)
            ms = ms / dist.get_world_size(grp)
        rms = torch.sqrt(ms + 1e-12)
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
                                        one_m_beta, step_lr,
                                        (shards or {}).get(k))
        return upd, FactorState(vr, vc, c)

    return Optimizer(init, update, dict(shards or {}))


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


def make_optimizer(name: str, lr: Optional[float] = None,
                   shards: Optional[Shards] = None) -> Optimizer:
    """The optimizer a config names, at ``lr`` or the JAX package's
    default rate for it (adamw 3e-4, adagrad 0.02, adafactor 0.01, sgd
    0.1; rankgraph2 at its own two rates).  ``shards`` (module
    docstring) reaches Adafactor; the others are elementwise."""
    if name == "adamw":
        return adamw(lr or 3e-4)
    if name == "adagrad":
        return adagrad(lr or 0.02)
    if name == "adafactor":
        return adafactor(lr or 0.01, shards=shards)
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
