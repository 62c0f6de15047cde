"""Publisher: materialise an ``IndexSnapshot`` from fresh embeddings and
gate it, as ``repro/lifecycle/publish.py`` (``encode_corpus``,
``build_snapshot``, ``snapshot_health`` and the recall gate).

Every user and item embedding is pushed through the RQ codebooks
(``rq_assign_corpus``: the ``rq_assign`` kernel on a card), the flat
cluster ids are inverted into member lists, and the I2I KNN table is
rebuilt from the item embeddings.

The gate (``evaluate_snapshot``) is host numpy, the reference's own
code: cluster-routed retrieval must keep ``min_ratio`` of exact-KNN
recall on held-out engagements.  It reads host copies of the
embeddings (``host_embeddings``): a bf16 tensor becomes float64, which
is what numpy makes of the reference's ``ml_dtypes.bfloat16`` arrays in
every gate expression (each first divides by an ``np.linalg.norm``,
which computes in float64), so both packages compute the same numbers.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import RankGraph2Config
from repro_torch.core import evaluation as E
from repro_torch.core.rq_index import codes_utilization, layer_books
from repro_torch.core.serving import build_i2i_knn
from repro_torch.kernels.rq_assign.ops import flat_codes, rq_assign_corpus
from repro_torch.lifecycle.snapshot import IndexSnapshot, derive_members


@torch.inference_mode()
def encode_corpus(rq_params, emb: torch.Tensor,
                  codebook_sizes: Sequence[int], *, chunk: int = 65536
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Encode a full corpus through the codebooks, on ``emb``'s device.

    Returns ``(codes (N, L) int32, flat (N,) int64, recon (N, d) f32)``.
    """
    books = layer_books(rq_params, len(codebook_sizes))
    codes, recon = rq_assign_corpus(emb, books, chunk=chunk)
    return codes, flat_codes(codes, codebook_sizes), recon


def build_snapshot(version: int, user_emb: torch.Tensor,
                   item_emb: torch.Tensor, rq_params,
                   cfg: RankGraph2Config, *, i2i_k: int = 20,
                   chunk: int = 65536,
                   metrics: Optional[Dict[str, float]] = None,
                   want_user_recon: bool = False):
    """One immutable snapshot from the current embeddings + codebooks.

    ``want_user_recon=True`` also returns the user-corpus RQ
    reconstruction (a tensor on the embeddings' device) from the same
    encode pass as ``(snap, recon)``."""
    sizes = cfg.rq.codebook_sizes
    u_codes, u_flat, u_recon = encode_corpus(rq_params, user_emb, sizes,
                                             chunk=chunk)
    i_codes, _, _ = encode_corpus(rq_params, item_emb, sizes, chunk=chunk)
    u_flat = u_flat.cpu().numpy()
    ptr, ids = derive_members(u_flat, int(np.prod(sizes)))
    i2i = build_i2i_knn(item_emb, k=i2i_k)
    coarse = rq_params["codebooks"]["layer0"].detach().to(torch.float32)
    snap = IndexSnapshot(
        user_codes=u_codes.cpu().numpy(), item_codes=i_codes.cpu().numpy(),
        user_clusters=u_flat, member_ptr=ptr, member_ids=ids,
        coarse_codebook=coarse.cpu().numpy(), i2i=i2i.cpu().numpy(),
        version=int(version), n_users=len(user_emb),
        n_items=len(item_emb), codebook_sizes=tuple(sizes),
        gate_metrics=tuple(sorted((str(k), float(v))
                                  for k, v in (metrics or {}).items())))
    return (snap, u_recon) if want_user_recon else snap


def snapshot_health(snap: IndexSnapshot) -> Dict[str, float]:
    """Index-health metrics needing no eval world: per-layer utilisation
    of the published user+item assignments, the normalised entropy of
    the layer-0 member-list sizes (``coarse_list_balance``: 1 = flat,
    -> 0 at collapse) and the heaviest list's share of the users."""
    all_codes = np.concatenate([snap.user_codes, snap.item_codes], axis=0)
    util = codes_utilization(all_codes, snap.codebook_sizes)
    out = {f"util_layer{l}": float(u) for l, u in enumerate(util)}
    out["codebook_util_min"] = float(min(util)) if util else 0.0
    k0 = snap.codebook_sizes[0]
    stride = max(snap.n_clusters // k0, 1)
    ptr = snap.member_ptr
    sizes0 = (ptr[stride * np.arange(1, k0 + 1)]
              - ptr[stride * np.arange(k0)]).astype(np.float64)
    tot = float(sizes0.sum())
    if tot <= 0 or k0 <= 1:
        out["coarse_list_balance"] = 0.0 if k0 > 1 else 1.0
        out["coarse_list_max_share"] = 0.0 if tot <= 0 else 1.0
        return out
    p = sizes0 / tot
    nz = p[p > 0]
    out["coarse_list_balance"] = float(-np.sum(nz * np.log(nz))
                                       / np.log(k0))
    out["coarse_list_max_share"] = float(p.max())
    return out


# ---------------------------------------------------------------------------
# recall gate: cluster-routed retrieval vs exact KNN (host numpy)
# ---------------------------------------------------------------------------

def host_embeddings(emb) -> np.ndarray:
    """The host copy the gate reads: f32 stays f32; a 16-bit float
    tensor becomes float64, exactly (the reference hands numpy
    ``ml_dtypes.bfloat16`` arrays, which its ``np.linalg.norm`` turns to
    float64 before any arithmetic)."""
    if isinstance(emb, torch.Tensor):
        emb = emb.detach()
        wide = emb.dtype in (torch.bfloat16, torch.float16)
        return emb.to("cpu", torch.float64 if wide else torch.float32
                      ).numpy()
    return np.asarray(emb)


def cluster_neighbor_users(snap: IndexSnapshot, user_emb: np.ndarray,
                           queries: np.ndarray, k: int, *,
                           n_probe_factor: int = 4) -> np.ndarray:
    """Top-k neighbour *users* per query via the published index:
    multi-probe the coarse (layer-0) cells nearest the query embedding
    until ~``n_probe_factor * k`` candidates are gathered, then rank the
    candidates by cosine.  Returns ``(len(queries), k)`` user ids,
    ``-1``-padded."""
    e = user_emb / np.maximum(
        np.linalg.norm(user_emb, axis=1, keepdims=True), 1e-8)
    q = e[queries]
    C = snap.coarse_codebook
    # coarse routing: distance of the query embedding to layer-0 cells
    d2 = (np.sum(q * q, axis=1, keepdims=True) - 2.0 * q @ C.T
          + np.sum(C * C, axis=1)[None, :])
    probe_order = np.argsort(d2, axis=1, kind="stable")
    out = np.full((len(queries), k), -1, np.int64)
    want = n_probe_factor * k
    for qi in range(len(queries)):
        cand: list = []
        for k0 in probe_order[qi]:
            members = snap.coarse_members(int(k0))
            if len(members):
                cand.append(members)
            if sum(len(c) for c in cand) >= want:
                break
        if not cand:
            continue
        cm = np.concatenate(cand)
        cm = cm[cm != queries[qi]]               # self-exclusion
        if not len(cm):
            continue
        sims = e[cm] @ e[queries[qi]]
        kk = min(k, len(cm))
        top = np.argpartition(-sims, kk - 1)[:kk]
        top = top[np.argsort(-sims[top], kind="stable")]
        out[qi, :kk] = cm[top]
    return out


def cluster_user_recall(snap: IndexSnapshot, user_emb: np.ndarray,
                        world, *, ks: Sequence[int] = (100,),
                        n_queries: int = 500, seed: int = 0,
                        n_probe_factor: int = 4) -> Dict[int, float]:
    """``evaluation.user_recall`` with the exact KNN replaced by the
    published cluster index (same query sampling, same next-day ground
    truth)."""
    day1 = E._user_day1_items(world.day1, len(user_emb))
    rng = np.random.default_rng(seed)
    active = np.flatnonzero([len(s) > 0 for s in day1])
    if len(active) == 0:
        return {k: 0.0 for k in ks}
    queries = rng.choice(active, min(n_queries, len(active)),
                         replace=False)
    kmax = max(ks)
    nbrs = cluster_neighbor_users(snap, user_emb, queries, kmax,
                                  n_probe_factor=n_probe_factor)
    out = {}
    for k in ks:
        recs = []
        for qi, u in enumerate(queries):
            truth = day1[u]
            pred = set()
            for v in nbrs[qi, :k]:
                if v >= 0:
                    pred |= day1[v]
            recs.append(len(pred & truth) / max(len(truth), 1))
        out[k] = float(np.mean(recs))
    return out


def i2i_item_recall(snap: IndexSnapshot, world, *, n_edges: int = 500,
                    seed: int = 0) -> float:
    """§5.2.2 item-ranking recall through the published index: the
    share of sampled next-day co-engagement pairs ``(i, j)`` with ``j``
    in the snapshot's I2I row of ``i``."""
    pairs = E.day1_co_pairs(world.day1, n_edges=n_edges, seed=seed)
    if not len(pairs):
        return 0.0
    n = snap.i2i.shape[0]
    pairs = pairs[(pairs[:, 0] < n) & (pairs[:, 1] < n)]
    if not len(pairs):
        return 0.0
    hits = (snap.i2i[pairs[:, 0]] == pairs[:, 1][:, None]).any(axis=1)
    return float(hits.mean())


def evaluate_snapshot(snap: IndexSnapshot, user_emb, user_recon, world, *,
                      recall_k: int = 100, n_queries: int = 500,
                      seed: int = 0, n_probe_factor: int = 4,
                      hitrate_pairs: Optional[np.ndarray] = None,
                      item_emb=None) -> Dict[str, float]:
    """The publication gate: cluster-index recall vs exact-KNN recall on
    the same next-day engagements, the §5.2.2 item recall through the
    I2I table vs exact ranking (when ``item_emb`` is given), the
    utilisation and list balance of the published codes, and the
    §5.2.3 index hitrate (original vs RQ-reconstructed embeddings) when
    positive pairs are given.  Embeddings may be arrays or tensors on
    any device; the gate reads ``host_embeddings`` of each.

    ``recall_ratio`` / ``item_recall_ratio`` / ``codebook_util_min``
    are the numbers the swap gate thresholds."""
    user_emb = host_embeddings(user_emb)
    exact = E.user_recall(user_emb, world, ks=(recall_k,),
                          n_queries=n_queries, seed=seed)[recall_k]
    routed = cluster_user_recall(snap, user_emb, world, ks=(recall_k,),
                                 n_queries=n_queries, seed=seed,
                                 n_probe_factor=n_probe_factor)[recall_k]
    out = dict(recall_exact=float(exact), recall_index=float(routed),
               recall_ratio=float(routed / max(exact, 1e-12)),
               recall_k=float(recall_k))
    # item side: exact ranking at the I2I table's own width
    if item_emb is not None:
        k_i2i = int(snap.i2i.shape[1])
        exact_i = E.item_recall(host_embeddings(item_emb), world,
                                ks=(k_i2i,), n_edges=n_queries,
                                seed=seed)[k_i2i]
        routed_i = i2i_item_recall(snap, world, n_edges=n_queries,
                                   seed=seed)
        out["item_recall_exact"] = float(exact_i)
        out["item_recall_index"] = float(routed_i)
        out["item_recall_ratio"] = float(routed_i / max(exact_i, 1e-12))
        out["item_recall_k"] = float(k_i2i)
    out.update(snapshot_health(snap))
    if hitrate_pairs is not None and len(hitrate_pairs):
        hr_orig, hr_recon = E.index_hitrate(
            user_emb, host_embeddings(user_recon), hitrate_pairs, ks=(10,),
            seed=seed)
        out["hitrate10_orig"] = hr_orig[10]
        out["hitrate10_recon"] = hr_recon[10]
    return out
