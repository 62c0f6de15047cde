"""Negative sampling (paper §4.3), as ``repro/core/negatives.py``:
in-batch + out-of-batch rolling pool + multi-head negative augmentation,
``n_neg`` negatives per positive, of the positive's destination type.

The pool is device-resident state, one FIFO ring of recent destination
embeddings per node type.  Its write pointer and fill level are plain
integers: they are a function of the batch sizes alone, so the host
knows them without reading the device.

``jax.random`` draws cannot be reproduced in torch, so every random
index ``sample_negatives`` uses is drawn up front by
``negative_draws`` (from a ``torch.Generator``) or passed in by the
caller (the parity tests pass the JAX draws).

``shard_block`` keeps a row's in-batch, fallback and augmentation rows
inside its block of that many rows (the reference's shard-local
negatives): with data-parallel training each rank holds one block of
the batch, so its negatives never cross ranks.  The rule is the
reference's: row ``i`` takes ``(i // blk) * blk + (i + off) % blk``
with ``off`` drawn in ``[1, max(blk, 2))``, where ``blk`` is
``shard_block`` if ``0 < shard_block <= B`` and it divides ``B``, else
``B`` (one block: the whole batch).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch


@dataclasses.dataclass
class NegPoolState:
    user: torch.Tensor     # (P, d)
    item: torch.Tensor     # (P, d)
    user_ptr: int = 0
    item_ptr: int = 0
    user_fill: int = 0
    item_fill: int = 0


def init_pool(pool_size: int, d: int, dtype: torch.dtype = torch.float32,
              device=None) -> NegPoolState:
    return NegPoolState(
        torch.zeros((pool_size, d), dtype=dtype, device=device),
        torch.zeros((pool_size, d), dtype=dtype, device=device))


@torch.no_grad()
def _push(buf: torch.Tensor, ptr: int, fill: int, emb: torch.Tensor):
    """Write ``emb`` at ``(ptr + i) % P`` in place.  Where the batch wraps
    the ring, the later row wins (as a sequential scatter): only the last
    ``P`` rows are written, to distinct slots."""
    P, B = buf.shape[0], emb.shape[0]
    keep = min(B, P)
    idx = (ptr + torch.arange(B - keep, B, device=buf.device)) % P
    buf[idx] = emb[B - keep:].detach().to(buf.dtype)
    return (ptr + B) % P, min(fill + B, P)


def update_pool(state: NegPoolState, user_emb: Optional[torch.Tensor],
                item_emb: Optional[torch.Tensor]) -> NegPoolState:
    """Push each type's endpoint embeddings (in place); ``None`` leaves
    that type's ring untouched."""
    if user_emb is not None:
        state.user_ptr, state.user_fill = _push(
            state.user, state.user_ptr, state.user_fill, user_emb)
    if item_emb is not None:
        state.item_ptr, state.item_fill = _push(
            state.item, state.item_ptr, state.item_fill, item_emb)
    return state


def split_counts(n_neg: int, n_pool: int, n_heads: int):
    """(n_inb, n_pool, n_aug): in-batch, pool and head-augmentation
    negatives per positive."""
    n_aug = max(n_neg // 8, 1) if n_heads > 1 else 0
    n_pool = min(n_pool, n_neg - n_aug)
    return n_neg - n_pool - n_aug, n_pool, n_aug


def block_size(B: int, shard_block: int = 0) -> int:
    """The in-batch block: ``shard_block`` where it is in ``(0, B]`` and
    divides ``B``, else the whole batch."""
    return shard_block if 0 < shard_block <= B and B % shard_block == 0 \
        else B


def shard_block_for(B: int, dp: int) -> int:
    """The reference's in-batch block of a global step over ``dp`` data
    ranks (``repro/core/trainer.py::_forward_losses``'s ``blk``): ``B //
    dp`` where ``dp > 1`` divides ``B``, else 0 (whole-batch negatives)."""
    return B // dp if dp > 1 and B % dp == 0 else 0


def negative_draws(B: int, n_heads: int, n_neg: int, n_pool: int,
                   pool_fill: int, *, generator: torch.Generator,
                   device=None, shard_block: int = 0
                   ) -> Dict[str, torch.Tensor]:
    """Every random index ``sample_negatives`` needs, as int64 tensors:

    ``inb`` (B, n_inb) and ``fallback`` (B, n_pool) and ``aug_off``
    (B, n_aug) row offsets in [1, max(blk, 2)) (``blk``:
    ``block_size(B, shard_block)``); ``pool`` (B, n_pool) pool rows in
    [0, max(pool_fill, 1)); ``aug_head`` (B, n_aug) heads in
    [0, n_heads)."""
    n_inb, n_pool, n_aug = split_counts(n_neg, n_pool, n_heads)
    hi = max(block_size(B, shard_block), 2)

    def r(lo, high, n):
        return torch.randint(lo, high, (B, n), generator=generator,
                             device=device)
    return dict(inb=r(1, hi, n_inb), pool=r(0, max(pool_fill, 1), n_pool),
                fallback=r(1, hi, n_pool), aug_off=r(1, hi, n_aug),
                aug_head=r(0, n_heads, n_aug))


def sample_negatives(dst_primary: torch.Tensor, dst_heads: torch.Tensor,
                     pool: torch.Tensor, pool_fill: int, n_neg: int,
                     n_pool: int, *,
                     draws: Optional[Dict[str, torch.Tensor]] = None,
                     generator: Optional[torch.Generator] = None,
                     shard_block: int = 0,
                     rows: Optional[slice] = None) -> torch.Tensor:
    """The (B, n_neg, d) negative bank for each positive edge, in
    ``dst_primary``'s type: (1) in-batch negatives, other rows' dst
    primaries; (2) rows of the rolling pool (in-batch rows while the pool
    is empty); (3) single heads of other in-batch dst nodes.  In-batch
    rows stay inside a row's block of ``block_size(B, shard_block)``
    rows.  ``draws`` defaults to ``negative_draws`` from ``generator``
    (with the same ``shard_block``).  ``rows``: the banks of those rows
    of the batch only (a data rank's rows under whole-batch negatives),
    ``dst_primary`` and ``dst_heads`` being the whole batch's and
    ``draws`` those rows' own."""
    B, d = dst_primary.shape
    H = dst_heads.shape[1]
    dev = dst_primary.device
    blk = block_size(B, shard_block)
    if draws is None:
        if rows is not None:
            raise ValueError("the banks of some rows need those rows' "
                             "draws")
        draws = negative_draws(B, H, n_neg, n_pool, pool_fill,
                               generator=generator, device=dev,
                               shard_block=shard_block)
    rows = rows or slice(0, B)
    i = torch.arange(rows.start, rows.stop, device=dev)[:, None]

    def other_rows(off):   # row i -> its block's base + (i + off) % blk
        if blk == B:
            return (i + off.to(dev)) % B
        return (i // blk) * blk + (i + off.to(dev)) % blk

    parts = [dst_primary[other_rows(draws["inb"])]]
    if pool_fill > 0:
        parts.append(pool[draws["pool"].to(dev)].to(dst_primary.dtype))
    else:
        parts.append(dst_primary[other_rows(draws["fallback"])])
    if draws["aug_off"].shape[1]:
        parts.append(dst_heads[other_rows(draws["aug_off"]),
                               draws["aug_head"].to(dev)])
    return torch.cat(parts, dim=1)
