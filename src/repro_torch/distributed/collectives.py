"""The collectives the manual SPMD paths use, with the gradients they
need.

``sum_across`` all-reduces a partial statistic (a sum over this rank's
rows) so that every rank holds the whole batch's value and computes the
same replicated terms from it.  Its backward is the identity: each rank
passes the replicated term's gradient to its own rows only, and the
data-parallel step then sums the parameters' gradients over the ranks
once.  ``torch.distributed.nn.functional.all_reduce`` would all-reduce
the gradient as well, and a term built from the statistic would then
be counted once a rank.

``gather_rows`` concatenates every rank's rows in rank order, outside
autograd, and ``gather_blocks`` under it (its backward sums the
cotangents over the group and returns each rank its own rows' block);
both take ranks that hold ``block_rows`` blocks, the last ones shorter
or empty.  ``reduce_grads_`` sums gradients over a group in place, one
flat all-reduce a dtype.

The autograd collectives of the LM family under a mesh
(``models/lm/model.py``: the FSDP gathers and ``_moe_shard_map``) give
the gradients of the reference's ``jax.shard_map`` transpose under
``check_vma=False`` (``_shard_map_transpose``): an output's cotangent
is divided by the size of the mesh axes its spec leaves out, and an
input's cotangent is summed over the axes its spec leaves out.  In the
port every rank of a group that holds a replicated value computes the
same cotangent for it, so those rules read:

  * ``all_to_all``: dim 0 tiled over the group, chunk ``i`` to rank
    ``i``; its backward is the same exchange of the cotangents;
  * ``gather_dim``: the ranks' shards concatenated along a dim (an FSDP
    gather; optionally cast before it is sent); its backward
    reduce-scatters the cotangent with a sum in f32, times
    ``grad_scale`` (``1 / n`` for an output replicated over the group);
  * ``slice_rows``: this rank's ``i``-th of ``n`` row blocks of a value
    replicated over the group; its backward puts the cotangent into its
    rows of zeros and all-reduces over the group;
  * ``mean_across``: the mean over the group (``pmean``), an output
    replicated over it: its backward is the all-reduced cotangent over
    ``n ** 2``;
  * ``all_sum``: the sum over the group whose backward is the sum of the
    cotangents, for a statistic of every rank's rows in a step that
    averages its gradients over those ranks.

Tensor parallelism over a model group (``models/lm/model.py``'s split
products and vocabulary, ``core/model.py``'s encoders and aggregators)
keeps another rule: a value every rank of the group holds alike has the
whole of its gradient on every rank, a split value the gradient of the
rank's block, and between ``enter_split`` and ``leave_split`` a rank's
gradients are its partial sums.  The pair and its gathers:

  * ``enter_split``: a replicated value entering the rank's split
    products (or a whole parameter used among them): the identity, and
    its cotangents, partial a rank, all-reduced;
  * ``leave_split``: the split products' partial sums leaving: the
    all-reduce, and the cotangent passed back unchanged (``sum_across``);
  * ``seq_gather``: sequence parallelism's entry, the ranks' blocks of
    the sequence all-gathered and the partial cotangents reduce-scattered
    (``gather_dim``'s gradient);
  * ``seq_scatter``: its exit, the partial sums reduce-scattered to each
    rank's block of the sequence and the cotangents all-gathered;
  * ``gather_split``: the ranks' blocks of a value that each computes for
    its own heads (or vocabulary rows) put back together, and each rank's
    block of the whole cotangent taken back;
  * ``split_of``: a rank's block of a replicated value, and the blocks'
    cotangents all-gathered.

The decode rules split a KV cache's sequence over ``kv_seq``'s ranks
(``models/lm/model.py``): each rank attends over its block of the keys
and ``fold_seq`` folds the ranks' (f32 output, lse) partials into the
softmax over every key, in rank order, with no gradient.

``gather_dim`` and ``all_sum`` must not stand in for these: their
gradients sum over the group a cotangent that every rank computes
alike, which makes it ``n`` times too large.  With grad mode off (serving,
``torch.inference_mode``) each runs its forward's collective alone.

Under gloo a CUDA tensor is staged through the host for ``all_to_all``
and ``reduce_scatter`` (``_host_staged``), which gloo does not take on
the card in every torch build; gloo stages every collective through the
host anyway.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import torch
import torch.distributed as dist


class _SumAcross(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        y = x.detach().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g, None


def sum_across(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group``, on every rank; the
    gradient flows back to this rank's ``x`` unchanged."""
    return _SumAcross.apply(x, group)


@torch.no_grad()
def sum_across_(x: torch.Tensor, group) -> torch.Tensor:
    """In-place sum over the ranks of ``group``, no gradient."""
    dist.all_reduce(x, group=group)
    return x


def block_rows(n: int, world: int, rank: int) -> slice:
    """Rank ``rank``'s rows of ``n`` rows over ``world`` ranks: blocks of
    ``ceil(n / world)`` rows in rank order, so the last ranks hold fewer
    (or none) where ``world`` does not divide ``n``, and the ``rank``-th
    of ``world`` equal blocks where it does."""
    c = -(-n // world)
    lo = min(n, rank * c)
    return slice(lo, min(n, lo + c))


def _padded(x: torch.Tensor, rows: int) -> torch.Tensor:
    """``x`` with zero rows appended up to ``rows``."""
    if x.shape[0] == rows:
        return x
    return torch.cat([x, x.new_zeros((rows - x.shape[0],) + x.shape[1:])])


@torch.no_grad()
def gather_rows(x: torch.Tensor, group, n: Optional[int] = None
                ) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0 in the group's rank
    order; detached.  ``n``: the whole's rows, each rank holding its
    ``block_rows`` (every block padded to ``ceil(n / world)`` rows for the
    exchange, the padding dropped); by default every rank's ``x`` has the
    same shape."""
    world = dist.get_world_size(group)
    c = x.shape[0] if n is None else -(-n // world)
    parts = [x.new_empty((c,) + x.shape[1:]) for _ in range(world)]
    dist.all_gather(parts, _padded(x.detach(), c).contiguous(), group=group)
    out = torch.cat(parts, dim=0)
    return out if n is None else out[:n]


def gather_blocks(x: torch.Tensor, n: int, group) -> torch.Tensor:
    """``gather_rows(x, group, n)`` under autograd: the whole's (n, ...)
    rows, each rank holding its ``block_rows``.  Every rank may use every
    row (in-batch negatives across ranks), so the gradient of this rank's
    ``x`` is the sum over the group of the cotangents of its rows
    (``gather_dim``'s reduce-scatter, in f32)."""
    c = -(-n // group_size(group))
    return gather_dim(_padded(x, c), 0, group)[:n]


@torch.no_grad()
def reduce_grads_(grads: Dict[str, torch.Tensor], names: Iterable[str],
                  group) -> None:
    """Sum ``grads[name]`` for every name in ``names`` over the ranks of
    ``group``, in place: one flat all-reduce for each dtype."""
    by_dtype: Dict[torch.dtype, list] = {}
    for n in names:
        by_dtype.setdefault(grads[n].dtype, []).append(n)
    for members in by_dtype.values():
        flat = torch.cat([grads[n].reshape(-1) for n in members])
        dist.all_reduce(flat, group=group)
        off = 0
        for n in members:
            k = grads[n].numel()
            grads[n] = flat[off:off + k].view_as(grads[n])
            off += k


def group_size(group) -> int:
    return dist.get_world_size(group)


def _host_staged(fn: Callable, out: torch.Tensor, inp: torch.Tensor,
                 group) -> torch.Tensor:
    """``fn(out, inp)``, through host copies where gloo would take the
    card's tensors; returns ``out``."""
    if inp.is_cuda and dist.get_backend(group) == "gloo":
        o = out.cpu()
        fn(o, inp.cpu())
        out.copy_(o)
    else:
        fn(out, inp)
    return out


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    return _host_staged(lambda o, i: dist.all_to_all_single(o, i,
                                                            group=group),
                        torch.empty_like(x), x, group)


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(group_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _reduce_scatter(g: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over the group of ``g``, this rank's block along ``dim``."""
    n = group_size(group)
    chunks = [c.contiguous() for c in torch.chunk(g.movedim(dim, 0), n)]
    out = torch.empty_like(chunks[0])

    def rs(o, i):
        dist.reduce_scatter(o, list(torch.chunk(i, n)), group=group)
    _host_staged(rs, out, torch.cat(chunks), group)
    return out.movedim(0, dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, 0, 0, tiled=True)``: dim 0 cut into
    one block a rank, block ``i`` sent to rank ``i``; block ``j`` of the
    result came from rank ``j``."""
    return _AllToAll.apply(x, group)


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, dtype, grad_scale):
        ctx.dim, ctx.group, ctx.grad_scale = dim, group, grad_scale
        ctx.in_dtype = x.dtype
        return _all_gather(x if dtype is None else x.to(dtype), dim, group)

    @staticmethod
    def backward(ctx, g):
        out = _reduce_scatter(g.to(torch.float32), ctx.dim, ctx.group)
        if ctx.grad_scale != 1.0:
            out = out * ctx.grad_scale
        return out.to(ctx.in_dtype), None, None, None, None


def gather_dim(x: torch.Tensor, dim: int, group, *,
               dtype: Optional[torch.dtype] = None,
               grad_scale: float = 1.0) -> torch.Tensor:
    """The group's shards of equal shape concatenated along ``dim`` in
    rank order (``all_gather(..., tiled=True)``), cast to ``dtype`` before
    they are sent.  The gradient of this rank's shard is the sum over the
    group of the cotangents' block (a reduce-scatter in f32) times
    ``grad_scale``, in ``x``'s type."""
    return _GatherDim.apply(x, dim, group, dtype, grad_scale)


class _SliceRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, i, n, group):
        ctx.i, ctx.n, ctx.group, ctx.shape = i, n, group, x.shape
        rows = x.shape[0] // n
        return x[i * rows:(i + 1) * rows].clone()

    @staticmethod
    def backward(ctx, g):
        rows = ctx.shape[0] // ctx.n
        full = g.new_zeros(ctx.shape)
        full[ctx.i * rows:(ctx.i + 1) * rows] = g
        dist.all_reduce(full, group=ctx.group)
        return full, None, None, None


def slice_rows(x: torch.Tensor, i: int, n: int, group) -> torch.Tensor:
    """Row block ``i`` of ``n`` of ``x`` (which every rank of ``group``
    holds); the gradient of ``x`` is every rank's block's, all-reduced."""
    return _SliceRows.apply(x, i, n, group)


class _MeanAcross(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.n = group_size(group)
        y = x.detach().clone()
        dist.all_reduce(y, group=group)
        return y / ctx.n

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g / (ctx.n * ctx.n), None


def mean_across(x: torch.Tensor, group) -> torch.Tensor:
    """``jax.lax.pmean`` over ``group`` as an output replicated over it:
    the forward's mean, and each rank's ``x`` gets the mean of the
    cotangents over ``n``."""
    return _MeanAcross.apply(x, group)


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.detach().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``; each rank's ``x`` gets the sum of
    the ranks' cotangents (``jax.lax.psum``'s transpose)."""
    return _AllSum.apply(x, group)


# ---------------------------------------------------------------------------
# tensor parallelism over a model group (module docstring)
# ---------------------------------------------------------------------------

class _EnterSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g32 = g.to(torch.float32, copy=True).contiguous()
        dist.all_reduce(g32, group=ctx.group)
        return g32.to(g.dtype), None


def enter_split(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` (alike on every rank of ``group``) as the input of this
    rank's split products; its gradient is the ranks' partial ones,
    all-reduced in f32 and cast back to their type once."""
    if not torch.is_grad_enabled():
        return x
    return _EnterSplit.apply(x, group)


def leave_split(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of the split products' partial sums ``x``,
    on every rank; the cotangent of the sum is each partial's."""
    if not torch.is_grad_enabled():
        return sum_across_(x.clone(), group)
    return _SumAcross.apply(x, group)


def seq_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' blocks of the sequence along ``dim`` concatenated, as
    the input of split products; the partial cotangents are
    reduce-scattered (in f32) back to each rank's block."""
    if not torch.is_grad_enabled():
        return _all_gather(x, dim, group)
    return _GatherDim.apply(x, dim, group, None, 1.0)


class _SeqScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


def seq_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum over ``group`` of the
    partial sums ``x`` (a reduce-scatter in ``x``'s type); the blocks'
    cotangents are all-gathered."""
    if not torch.is_grad_enabled():
        return _reduce_scatter(x, dim, group)
    return _SeqScatter.apply(x, dim, group)


class _GatherSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        ctx.i, ctx.n = dist.get_rank(group), group_size(group)
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return torch.chunk(g, ctx.n, dim=ctx.dim)[ctx.i].contiguous(), \
            None, None


def gather_split(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' blocks of equal shape concatenated along ``dim``, a
    value every rank then uses alike; the gradient of this rank's block
    is its block of the (whole, equal) cotangent."""
    if not torch.is_grad_enabled():
        return _all_gather(x, dim, group)
    return _GatherSplit.apply(x, dim, group)


class _SplitOf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        n = group_size(group)
        return torch.chunk(x, n, dim=dim)[dist.get_rank(group)].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


def split_of(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block along ``dim`` of ``x`` (alike on every rank of
    ``group``), in the group's rank order; the gradient of ``x`` is the
    blocks' cotangents all-gathered."""
    if not torch.is_grad_enabled():
        return torch.chunk(x, group_size(group), dim=dim)[
            dist.get_rank(group)].contiguous()
    return _SplitOf.apply(x, dim, group)


# ---------------------------------------------------------------------------
# the fold of a sequence-sharded decode (no gradient)
# ---------------------------------------------------------------------------

def fold_seq(out: torch.Tensor, lse: torch.Tensor, group) -> torch.Tensor:
    """Each rank's attention over its block of the keys, ``out`` (..., D)
    f32 and ``lse`` (...) f32 (its rows' logsumexp; -inf for a rank that
    holds no key, whose ``out`` is 0), folded into the attention over
    every key: one all-gather of (out, lse) over ``group``, then in f32 in
    the group's rank order ``M = max_j lse_j`` and ``sum_j e^(lse_j - M)
    out_j / sum_j e^(lse_j - M)``, the same on every rank.  Returns f32:
    the caller rounds once.  A rank with lse -inf weighs exactly 0.
    Serving only: refuses grad."""
    if out.dtype != torch.float32 or lse.dtype != torch.float32:
        raise ValueError(f"fold_seq folds f32 partials, got {out.dtype} and "
                         f"{lse.dtype}")
    if torch.is_grad_enabled() and (out.requires_grad or lse.requires_grad):
        raise RuntimeError("fold_seq has no backward: call it with grad off "
                           "(decode is serving)")
    packed = torch.cat([out, lse[..., None]], dim=-1)
    parts = gather_rows(packed[None], group)
    outs, lses = parts[..., :-1], parts[..., -1]
    M = torch.amax(lses, dim=0)
    num = torch.zeros_like(out)
    den = torch.zeros_like(lse)
    for j in range(parts.shape[0]):
        w = torch.exp(lses[j] - M)
        num = num + w[..., None] * outs[j]
        den = den + w
    return num / den[..., None]
