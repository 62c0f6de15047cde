"""Plain PyTorch version of the fused queue-gather + I2I-union pass: the
spec the CUDA kernel is held against, vectorised over the request batch
so it also serves the store's retrieve path.

  1. U2U2I seeds: read each request's cluster ring newest-first, drop
     entries past the fill, older than ``cutoff`` (f32 compare) or
     ``-1``, dedup keeping the newest copy, keep the first ``n_recent``.
  2. U2I2I union: round-robin over the seeds' ``i2i`` rows by rank
     (rank 0 of every seed, then rank 1, ...); a seed past the table
     end gathers nothing; skip ``-1``, any seed and any earlier
     candidate; keep the first ``k``.
"""
from __future__ import annotations

from typing import Tuple

import torch


def dup_of_earlier(vals: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """True where a valid entry repeats the value of an earlier valid
    entry of its row (keep-first dedup).  A stable sort puts equal
    values in position order, so every copy but the first follows an
    equal neighbour."""
    W = vals.shape[1]
    pos = torch.arange(W, device=vals.device)
    # invalid entries get keys no value can equal
    key = torch.where(valid, vals.to(torch.int64), -2 - pos)
    sk, order = torch.sort(key, dim=1, stable=True)
    dup = torch.zeros_like(valid)
    dup[:, 1:] = sk[:, 1:] == sk[:, :-1]
    return torch.zeros_like(valid).scatter_(1, order, dup)


def select_first(cand: torch.Tensor, valid: torch.Tensor, k: int
                 ) -> torch.Tensor:
    """First ``k`` valid candidates per row, in row order, ``-1``
    padded."""
    pos = torch.cumsum(valid.to(torch.int64), dim=1) - 1
    take = valid & (pos < k)
    out = torch.full((cand.shape[0], k + 1), -1, dtype=cand.dtype,
                     device=cand.device)
    # entries not taken all write -1 into the spare column k
    out.scatter_(1, torch.where(take, pos, k),
                 torch.where(take, cand, torch.full_like(cand, -1)))
    return out[:, :k]


def ring_window(items: torch.Tensor, times: torch.Tensor,
                cursor: torch.Tensor, clusters: torch.Tensor, cutoff: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Newest-first ring window ``(B, Q)`` of each request's cluster plus
    its validity mask (fill, recency cutoff, ``-1``).  A cluster id
    outside ``[0, C)`` gives an all-invalid row."""
    C, Q = items.shape
    known = (clusters >= 0) & (clusters < C)
    cl = torch.where(known, clusters, torch.zeros_like(clusters)).long()
    total = cursor[cl].long()
    age = torch.arange(Q, device=items.device)[None, :]
    slot = torch.remainder(total[:, None] - 1 - age, Q)     # floor-mod
    it = items[cl[:, None], slot]
    ts = times[cl[:, None], slot]
    cut = torch.tensor(float(cutoff), dtype=torch.float32,
                       device=items.device)
    valid = ((age < total.clamp(max=Q)[:, None]) & (it >= 0)
             & (ts >= cut) & known[:, None])
    return it, valid


def union_topk(seeds: torch.Tensor, i2i: torch.Tensor, k: int
               ) -> torch.Tensor:
    """U2I2I union of each row's seeds ``(B, R)`` (``-1`` = none):
    rank-major round-robin over their ``i2i`` rows, seeds and
    duplicates masked, first ``k``."""
    B, R = seeds.shape
    n, K = i2i.shape
    has = seeds >= 0
    seeded = has & (seeds < n)
    if n:
        rows = i2i[seeds.clamp(0, n - 1).long()]            # (B, R, K)
    else:
        rows = torch.full((B, R, K), -1, dtype=i2i.dtype, device=i2i.device)
    cand = torch.where(seeded[:, :, None], rows, torch.full_like(rows, -1))
    flat = cand.transpose(1, 2).reshape(B, R * K)           # rank-major
    seen = ((flat[:, :, None] == seeds[:, None, :])
            & has[:, None, :]).any(dim=2)
    valid = (flat >= 0) & ~seen
    valid = valid & ~dup_of_earlier(flat, valid)
    return select_first(flat, valid, k)


def queue_gather_ref(items: torch.Tensor, times: torch.Tensor,
                     cursor: torch.Tensor, clusters: torch.Tensor,
                     i2i: torch.Tensor, *, cutoff: float, n_recent: int,
                     k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """items/times (C, Q), cursor (C,) total writes, clusters (B,),
    i2i (N, K).  Returns (seeds (B, n_recent), union (B, k)), both
    ``-1``-padded, in ``items``' integer type."""
    it, valid = ring_window(items, times, cursor, clusters, cutoff)
    valid = valid & ~dup_of_earlier(it, valid)
    seeds = select_first(it, valid, n_recent)
    return seeds, union_topk(seeds, i2i.to(items.dtype), k)
