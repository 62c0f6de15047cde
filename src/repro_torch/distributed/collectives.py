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
autograd; ``reduce_grads_`` sums gradients over a group in place, one
flat all-reduce a dtype.
"""
from __future__ import annotations

from typing import Dict, Iterable

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


@torch.no_grad()
def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` (the same shape on each), concatenated along
    dim 0 in the group's rank order; detached."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.detach().contiguous(), group=group)
    return torch.cat(parts, dim=0)


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
