"""Offline evaluation protocols (paper §5.2), as
``repro/core/evaluation.py``: the same host numpy, so the same inputs
give bitwise the same numbers in both packages.  The publication gate
(``lifecycle/publish.py::evaluate_snapshot``) is built on these.

User embeddings (§5.2.1 / Table 2): for each sampled user, retrieve the
top-K nearest users by cosine; predicted items = the next-day
engagements of those neighbor users; Recall@K against the user's own
next-day engagements (the U2U2I retrieval quality).

Item embeddings (§5.2.2 / Table 3): strict temporal split — rank all
items against item i from a day-(N+1) co-engagement edge (i, j);
Recall@K = fraction of edges with j ranked in the top K.

Learned index (§5.2.3 / Table 4): Hitrate@K — whether the positive edge
similarity ranks in the top K against sampled negatives, for original
vs RQ-reconstructed embeddings.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.graph_builder import EngagementLog
from repro_torch.data.synthetic import SyntheticWorld


def _topk_neighbors(emb: np.ndarray, queries: np.ndarray, k: int,
                    chunk: int = 1024) -> np.ndarray:
    e = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-8)
    out = np.empty((len(queries), k), np.int64)
    for lo in range(0, len(queries), chunk):
        hi = min(len(queries), lo + chunk)
        sims = e[queries[lo:hi]] @ e.T
        sims[np.arange(hi - lo), queries[lo:hi]] = -np.inf
        kk = min(k, e.shape[0] - 1)
        top = np.argpartition(-sims, kk - 1, axis=1)[:, :kk]
        rows = np.arange(hi - lo)[:, None]
        o = np.argsort(-sims[rows, top], axis=1, kind="stable")
        out[lo:hi, :kk] = top[rows, o]
    return out


def _user_day1_items(log: EngagementLog,
                     n_users: Optional[int] = None) -> list:
    """Per-user next-day item sets; ``n_users`` may exceed the log's
    user space (hour-level refreshes mint users after the eval window —
    they simply have empty ground truth)."""
    items = [set() for _ in range(max(log.n_users, n_users or 0))]
    for u, i in zip(log.user_id, log.item_id):
        items[u].add(int(i))
    return items


def user_recall(user_emb: np.ndarray, world: SyntheticWorld, *,
                ks: Sequence[int] = (5, 10, 50, 100),
                n_queries: int = 500, seed: int = 0) -> Dict[int, float]:
    """U2U2I Recall@K via top-K neighbor users' next-day engagements."""
    day1 = _user_day1_items(world.day1, len(user_emb))
    rng = np.random.default_rng(seed)
    active = np.flatnonzero([len(s) > 0 for s in day1])
    if len(active) == 0:
        return {k: 0.0 for k in ks}
    queries = rng.choice(active, min(n_queries, len(active)), replace=False)
    kmax = max(ks)
    nbrs = _topk_neighbors(user_emb, queries, kmax)
    out = {}
    for k in ks:
        recs = []
        for qi, u in enumerate(queries):
            truth = day1[u]
            pred = set()
            for v in nbrs[qi, :k]:
                pred |= day1[v]
            recs.append(len(pred & truth) / max(len(truth), 1))
        out[k] = float(np.mean(recs))
    return out


def day1_co_pairs(log: EngagementLog, *, n_edges: int = 500,
                  seed: int = 0) -> np.ndarray:
    """Sampled next-day I-I co-engagement pairs ``(n, 2)`` — the §5.2.2
    evaluation unit, shared by the offline ``item_recall`` protocol and
    the publication gate's index-side variant (identical sampling, so
    the two numbers are directly comparable)."""
    rng = np.random.default_rng(seed)
    order = np.argsort(log.user_id, kind="stable")
    u, it = log.user_id[order], log.item_id[order]
    starts = np.flatnonzero(np.r_[True, u[1:] != u[:-1]])
    ends = np.r_[starts[1:], len(u)]
    pairs = []
    for s, e in zip(starts, ends):
        its = np.unique(it[s:e])
        if len(its) >= 2:
            a = rng.choice(its, min(len(its), 4), replace=False)
            for x in range(len(a) - 1):
                pairs.append((a[x], a[x + 1]))
    if not pairs:
        return np.zeros((0, 2), np.int64)
    pairs = np.asarray(pairs)
    idx = rng.choice(len(pairs), min(n_edges, len(pairs)), replace=False)
    return pairs[idx]


def item_recall(item_emb: np.ndarray, world: SyntheticWorld, *,
                ks: Sequence[int] = (5, 10, 50, 100),
                n_edges: int = 500, seed: int = 0) -> Dict[int, float]:
    """Next-day I-I co-engagement ranking recall (temporal split)."""
    pairs = day1_co_pairs(world.day1, n_edges=n_edges, seed=seed)
    if not len(pairs):
        return {k: 0.0 for k in ks}
    e = item_emb / np.maximum(
        np.linalg.norm(item_emb, axis=1, keepdims=True), 1e-8)
    sims = e[pairs[:, 0]] @ e.T
    sims[np.arange(len(pairs)), pairs[:, 0]] = -np.inf
    ranks = (sims > sims[np.arange(len(pairs)), pairs[:, 1]][:, None]
             ).sum(axis=1)
    return {k: float(np.mean(ranks < k)) for k in ks}


def index_hitrate(emb: np.ndarray, recon: np.ndarray,
                  pos_pairs: np.ndarray, *, n_neg: int = 100,
                  ks: Sequence[int] = (1, 5, 10), seed: int = 0,
                  neg_range: Optional[Tuple[int, int]] = None
                  ) -> Tuple[Dict[int, float], Dict[int, float]]:
    """Hitrate@K for original and reconstructed embeddings on the same
    positive pairs + shared sampled negatives.  ``neg_range`` restricts
    negatives to the dst node type (paper: same type as n_j)."""
    rng = np.random.default_rng(seed)
    lo, hi = neg_range if neg_range is not None else (0, len(emb))
    neg = rng.integers(lo, hi, (len(pos_pairs), n_neg))

    def hr(e):
        e = e / np.maximum(np.linalg.norm(e, axis=1, keepdims=True), 1e-8)
        s_pos = np.sum(e[pos_pairs[:, 0]] * e[pos_pairs[:, 1]], axis=1)
        s_neg = np.einsum("nd,nkd->nk", e[pos_pairs[:, 0]], e[neg])
        # ties count half a rank (quantized/reconstructed embeddings can
        # collide exactly; strict '>' would otherwise inflate hitrate)
        rank = ((s_neg > s_pos[:, None] + 1e-7).sum(axis=1)
                + 0.5 * (np.abs(s_neg - s_pos[:, None]) <= 1e-7
                         ).sum(axis=1))
        return {k: float(np.mean(rank < k)) for k in ks}

    return hr(emb), hr(recon)
