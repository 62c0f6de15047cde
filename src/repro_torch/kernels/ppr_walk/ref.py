"""Plain PyTorch PPR walk + first-occurrence visit counts: the readable
spec the CUDA kernel is held against, vectorised over walkers.

Semantics of ``repro/kernels/ppr_walk/ref.py::ppr_walk_ref``:

  1. inverse-CDF transition: the next column is the count of cumulative
     entries strictly below the step draw, clamped to the last column
     with positive mass (an f32 cumsum can top out below 1.0; the draw
     must never land on a trailing ``-1`` pad);
  2. a walker on a dangling row (no mass) or on a ``-1`` entry stays;
  3. a restart draw below ``float32(restart)`` sends the walker home;
  4. the trace is walker-major (walker w's step t at column
     ``w * walk_len + t``), and each distinct node's visit count sits at
     its first occurrence in the row, 0 elsewhere.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def last_valid_cols(cum: torch.Tensor) -> torch.Tensor:
    """(N,) int32: per row, the last column carrying positive transition
    mass (0 for dangling rows)."""
    inc = torch.empty(cum.shape, dtype=torch.bool, device=cum.device)
    inc[:, 0] = cum[:, 0] > 0
    inc[:, 1:] = cum[:, 1:] > cum[:, :-1]
    cols = torch.arange(cum.shape[1], device=cum.device, dtype=torch.int32)
    return torch.where(inc, cols, 0).amax(dim=1).to(torch.int32)


def first_occurrence_counts(visited: torch.Tensor) -> torch.Tensor:
    """(n, S) ids -> (n, S) counts: each distinct id's multiplicity in its
    row at its first occurrence, 0 elsewhere.  A stable sort keeps equal
    ids in trace order, so a run's first element is the id's first
    occurrence."""
    srt, order = torch.sort(visited, dim=1, stable=True)
    newrun = torch.ones_like(srt, dtype=torch.bool)
    newrun[:, 1:] = srt[:, 1:] != srt[:, :-1]
    run_id = newrun.to(torch.int64).cumsum(dim=1) - 1
    lens = torch.zeros_like(run_id).scatter_add_(
        1, run_id, torch.ones_like(run_id))
    at_start = torch.where(newrun, lens.gather(1, run_id), 0)
    counts = torch.empty_like(at_start)
    counts.scatter_(1, order, at_start)
    return counts.to(visited.dtype)


def ppr_walk_ref(nbrs: torch.Tensor, cum: torch.Tensor,
                 starts: torch.Tensor, uniforms: torch.Tensor, *,
                 restart: float, last: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """nbrs (N, D2) int, cum (N, D2) f32, starts (n,) int, uniforms
    (n, n_walks, 2*walk_len) f32 (column 2t: step draw, 2t+1: restart
    draw); ``last`` optionally precomputed ``last_valid_cols(cum)``.

    Returns (visited, counts), each (n, n_walks*walk_len) int32."""
    n, n_walks, two_l = uniforms.shape
    walk_len = two_l // 2
    if last is None:
        last = last_valid_cols(cum)
    last = last.to(torch.int64)
    home = starts.to(torch.int64).repeat_interleave(n_walks)
    u = uniforms.to(torch.float32).reshape(n * n_walks, two_l)
    r32 = torch.tensor(restart, dtype=torch.float32)
    pos = home
    trace = []
    for t in range(walk_len):
        c = cum[pos]                                   # (m, D2)
        col = (c < u[:, 2 * t, None]).sum(dim=1)
        col = torch.minimum(col, last[pos])
        nxt = nbrs[pos, col].to(torch.int64)
        dead = (nxt < 0) | (c[:, -1] <= 0)
        nxt = torch.where(dead, pos, nxt)
        pos = torch.where(u[:, 2 * t + 1] < r32, home, nxt)
        trace.append(pos)
    visited = torch.stack(trace, dim=1).reshape(n, n_walks * walk_len)
    visited = visited.to(torch.int32)
    return visited, first_occurrence_counts(visited)
