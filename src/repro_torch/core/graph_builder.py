"""RankGraph-2 graph construction (paper §4.2), a numpy copy of
``repro/core/graph_builder.py``: engagement log -> heterogeneous
co-engagement graph with U-I / U-U / I-I edges (Eq. 1-2), popularity
bias correction on I-I edges (Eq. 3), per-node top-K edge subsampling,
Group 1 / Group 2 split, and the padded adjacency that feeds PPR.

Construction runs on the host, exactly as in the JAX package, and its
output is bitwise equal to it: the same edges, in the same order, with
the same weights.  So does the hour-level refresh: ``build_graph(...,
keep_state=True)`` keeps the pre-subsample aggregates in a
``RefreshState``, and ``refresh_graph`` splices a trailing window's
delta into them, re-deriving only the co-engagement pairs it reaches;
the result equals a from-scratch build on the merged window, bit for
bit.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple

import numpy as np

# engagement type -> business-value weight (paper: "predefined values
# that reflect business value")
DEFAULT_EVENT_WEIGHTS = {0: 1.0, 1: 2.0, 2: 3.0, 3: 5.0}  # click/like/share/buy


@dataclasses.dataclass
class EngagementLog:
    """Columnar interaction log D = {(user, item, interaction, ts)}."""
    user_id: np.ndarray      # int64 [n]
    item_id: np.ndarray      # int64 [n]
    event_type: np.ndarray   # int32 [n]
    timestamp: np.ndarray    # float64 [n] (seconds)
    n_users: int
    n_items: int

    def window(self, t_end: float, horizon_s: float) -> "EngagementLog":
        m = (self.timestamp <= t_end) & (self.timestamp > t_end - horizon_s)
        return EngagementLog(self.user_id[m], self.item_id[m],
                             self.event_type[m], self.timestamp[m],
                             self.n_users, self.n_items)


@dataclasses.dataclass
class EdgeSet:
    """Directed weighted edges of one type."""
    src: np.ndarray
    dst: np.ndarray
    weight: np.ndarray

    def __len__(self) -> int:
        return len(self.src)


@dataclasses.dataclass
class HubDraws:
    """Per-anchor hub-subsample offsets actually drawn by a build
    (``_co_engagement``): one row of ``hub_cap`` sorted offsets (-1 =
    deduped slot) per anchor whose degree exceeded ``hub_cap``.

    Draws are a pure function of ``(seed, tag, anchor id, degree)`` via
    ``hub_uniforms`` — persisting them lets an incremental refresh skip
    regeneration for untouched hub anchors, and regeneration for touched
    anchors reproduces exactly the offsets a from-scratch rebuild on the
    merged window would draw (the refresh-vs-rebuild bitwise guarantee
    holds *even when* ``hub_cap`` triggers)."""
    anchor_ids: np.ndarray       # (n_hub,) ascending anchor node ids
    offsets: np.ndarray          # (n_hub, hub_cap) int64, -1 = dropped dup
    lens: np.ndarray             # (n_hub,) anchor degree at draw time


def _empty_hub_draws(cap: int) -> HubDraws:
    return HubDraws(np.zeros(0, np.int64), np.zeros((0, cap), np.int64),
                    np.zeros(0, np.int64))


@dataclasses.dataclass
class RefreshState:
    """Pre-subsample construction aggregates retained for hour-level
    incremental refresh (``refresh_graph``).  At production scale these
    live in the offline store alongside the log, not in RAM."""
    ui_full: EdgeSet             # aggregated per-(u, i) weights, pre-top-K
    uu_raw: EdgeSet              # canonical (lo < hi) co-pairs, pre-subsample
    ii_raw: EdgeSet              # canonical co-pairs, pre-Eq.3 correction
    params: Dict                 # build knobs a refresh must reuse
    hub_draws: Optional[Dict[str, HubDraws]] = None  # per-anchor offsets


@dataclasses.dataclass
class HeteroGraph:
    n_users: int
    n_items: int
    ui: EdgeSet                  # user -> item
    uu: EdgeSet                  # user -> user (both directions present)
    ii: EdgeSet                  # item -> item (both directions present)
    group1_users: np.ndarray     # bool [n_users]: has same-type neighbors
    group1_items: np.ndarray     # bool [n_items]
    build_seconds: float = 0.0
    refresh: Optional[RefreshState] = None

    @property
    def n_edges(self) -> int:
        return len(self.ui) + len(self.uu) + len(self.ii)


# ---------------------------------------------------------------------------
# U-I edges
# ---------------------------------------------------------------------------

def build_ui_edges(log: EngagementLog,
                   event_weights: Optional[Dict[int, float]] = None
                   ) -> EdgeSet:
    """Aggregate engagement events into weighted U-I edges."""
    ew = event_weights or DEFAULT_EVENT_WEIGHTS
    wtab = np.zeros(max(ew) + 1, np.float64)
    for k, v in ew.items():
        wtab[k] = v
    et = log.event_type
    # unknown / out-of-range event types carry no business value: weight 0.
    # (clipping instead would alias them onto the boundary buckets — a
    # corrupt type id would silently count as a max-weight "buy").
    known = (et >= 0) & (et < len(wtab))
    w = np.where(known, wtab[np.clip(et, 0, len(wtab) - 1)], 0.0)
    key = log.user_id.astype(np.int64) * log.n_items + log.item_id
    uniq, inv = np.unique(key, return_inverse=True)
    agg = np.zeros(len(uniq), np.float64)
    np.add.at(agg, inv, w)
    keep = agg > 0           # all-zero-weight pairs are not engagements
    uniq, agg = uniq[keep], agg[keep]
    # weights stay float64: the refresh merge re-accumulates them, and a
    # premature f32 rounding would double-round vs a from-scratch build
    return EdgeSet(src=(uniq // log.n_items).astype(np.int64),
                   dst=(uniq % log.n_items).astype(np.int64),
                   weight=agg)


# ---------------------------------------------------------------------------
# co-engagement edges (Eq. 1 / Eq. 2)
# ---------------------------------------------------------------------------

HUB_BLOCK = 4096     # anchors per hub-subsample RNG block (keyed stream)


def hub_uniforms(seed: int, tag: str, anchor_ids: np.ndarray,
                 cap: int) -> np.ndarray:
    """(len(anchor_ids), cap) f32 uniforms for hub subsampling, keyed by
    *anchor node id* in fixed ``HUB_BLOCK``-sized blocks (mirroring
    ``ppr.walk_uniforms``) — not by stream position.  An incremental
    refresh that re-expands only the delta-reachable anchors therefore
    regenerates exactly the draws a from-scratch rebuild on the merged
    window would consume for them.  ``tag`` separates the U-U and I-I
    streams (their anchor id spaces overlap)."""
    anchor_ids = np.asarray(anchor_ids, np.int64)
    out = np.empty((len(anchor_ids), cap), np.float64)
    blocks = anchor_ids // HUB_BLOCK
    for b in np.unique(blocks):
        rng = np.random.default_rng((seed, tag.encode(), int(b)))
        blk = rng.random((HUB_BLOCK, cap))
        m = blocks == b
        out[m] = blk[anchor_ids[m] - b * HUB_BLOCK]
    return out


def _hub_offsets(seed: int, tag: str, hub_ids: np.ndarray,
                 hub_lens: np.ndarray, cap: int,
                 prev: Optional[HubDraws]) -> np.ndarray:
    """Sorted, per-row-deduped subsample offsets for hub anchors: a draw
    with replacement can emit the same engager slot — and hence the same
    (src, dst) pair — several times from one anchor, inflating wsum and
    letting a single common anchor satisfy ``cnt >= min_common`` (Eq.
    1/2 count *distinct* common anchors).  Duplicate picks are dropped
    (-1), shrinking the sample slightly — this is a subsample step
    anyway.  Rows persisted in ``prev`` with an unchanged degree are
    reused verbatim; the rest regenerate from the keyed stream (same
    result, just not free)."""
    offs = np.empty((len(hub_ids), cap), np.int64)
    need = np.ones(len(hub_ids), bool)
    if prev is not None and len(prev.anchor_ids):
        pos = np.searchsorted(prev.anchor_ids, hub_ids)
        pos = np.minimum(pos, len(prev.anchor_ids) - 1)
        hit = (prev.anchor_ids[pos] == hub_ids) & (prev.lens[pos] == hub_lens)
        offs[hit] = prev.offsets[pos[hit]]
        need = ~hit
    if need.any():
        u = hub_uniforms(seed, tag, hub_ids[need], cap)
        o = (u * hub_lens[need][:, None]).astype(np.int64)
        o.sort(axis=1)
        dup = np.zeros_like(o, bool)
        dup[:, 1:] = o[:, 1:] == o[:, :-1]
        o[dup] = -1
        offs[need] = o
    return offs


def _co_engagement(anchor: np.ndarray, other: np.ndarray, w: np.ndarray,
                   n_other: int, min_common: int, hub_cap: int,
                   seed: int, tag: str,
                   prev_draws: Optional[HubDraws] = None
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, HubDraws]:
    """Pairs of ``other`` nodes co-engaged via the same ``anchor`` node.

    For U-U edges: anchor=item, other=user.  For I-I: anchor=user,
    other=item.  ``hub_cap`` caps the fan-out per anchor (the paper's
    defence against hundreds-of-trillions of raw pairs: popular anchors
    contribute a bounded sample of pairs; with bias correction +
    top-K subsampling this preserves retrieval-relevant structure).
    Hub draws come from the anchor-keyed ``hub_uniforms`` stream
    (reusing ``prev_draws`` rows where the degree is unchanged), so the
    output is a pure function of the aggregated input — independent of
    whether it is reached by a full build or an incremental refresh.

    Returns (src, dst, weight, draws) with *undirected* co-edges,
    weight = ln(sum_e w_src,e * w_dst,e) and |common| >= min_common.
    """
    order = np.argsort(anchor, kind="stable")
    a, o, ww = anchor[order], other[order], w[order]
    # segment boundaries per anchor
    starts = np.flatnonzero(np.r_[True, a[1:] != a[:-1]])
    ends = np.r_[starts[1:], len(a)]
    lens = ends - starts
    keep = lens >= 2
    starts, ends, lens = starts[keep], ends[keep], lens[keep]
    cap = hub_cap
    if len(starts) == 0:
        z = np.zeros(0)
        return (z.astype(np.int64), z.astype(np.int64),
                z.astype(np.float32), _empty_hub_draws(cap))
    # pad each anchor's engagers to a (n_anchor, cap) matrix (random subset
    # for anchors above cap)
    nseg = len(starts)
    mat = np.full((nseg, cap), -1, np.int64)
    wmat = np.zeros((nseg, cap), np.float64)
    clens = np.minimum(lens, cap)
    # vectorized gather: column j of row r takes element starts[r]+pick[r,j]
    pick = np.arange(cap)[None, :].repeat(nseg, 0)
    big = lens > cap
    if big.any():
        hub_ids = a[starts[big]]
        offs = _hub_offsets(seed, tag, hub_ids, lens[big], cap, prev_draws)
        pick[big] = offs
        draws = HubDraws(hub_ids, offs, lens[big].copy())
    else:
        draws = _empty_hub_draws(cap)
    valid = (pick >= 0) & (pick < lens[:, None])
    idx = np.clip(starts[:, None] + pick, 0, len(a) - 1)
    mat = np.where(valid, o[idx], -1)
    wmat = np.where(valid, ww[idx], 0.0)
    # all within-row pairs
    iu, ju = np.triu_indices(cap, k=1)
    s = mat[:, iu].ravel()
    d = mat[:, ju].ravel()
    pw = (wmat[:, iu] * wmat[:, ju]).ravel()
    m = (s >= 0) & (d >= 0) & (s != d)
    s, d, pw = s[m], d[m], pw[m]
    # canonical order for undirected aggregation
    lo = np.minimum(s, d)
    hi = np.maximum(s, d)
    key = lo * n_other + hi
    uniq, inv, cnt = np.unique(key, return_inverse=True, return_counts=True)
    wsum = np.zeros(len(uniq), np.float64)
    np.add.at(wsum, inv, pw)
    ok = cnt >= min_common
    uniq, wsum = uniq[ok], wsum[ok]
    lo = (uniq // n_other).astype(np.int64)
    hi = (uniq % n_other).astype(np.int64)
    wlog = np.log(np.maximum(wsum, 1e-12)).astype(np.float32)
    # Eq.1/2: w = ln(sum w*w); clamp at small positive so weights stay usable
    wlog = np.maximum(wlog, 1e-3)
    return lo, hi, wlog, draws


def _mirror(e: EdgeSet) -> EdgeSet:
    """Materialize both directions of a canonical undirected edge set."""
    return EdgeSet(np.r_[e.src, e.dst], np.r_[e.dst, e.src],
                   np.r_[e.weight, e.weight])


def build_uu_edges(ui: EdgeSet, n_users: int, *, min_common: int = 2,
                   hub_cap: int = 32, seed: int = 0) -> EdgeSet:
    lo, hi, w, _ = _co_engagement(ui.dst, ui.src, ui.weight, n_users,
                                  min_common, hub_cap, seed, "uu")
    # undirected: materialize both directions
    return _mirror(EdgeSet(lo, hi, w))


def build_ii_edges(ui: EdgeSet, n_items: int, *, min_common: int = 2,
                   hub_cap: int = 32, seed: int = 0) -> EdgeSet:
    lo, hi, w, _ = _co_engagement(ui.src, ui.dst, ui.weight, n_items,
                                  min_common, hub_cap, seed, "ii")
    return _mirror(EdgeSet(lo, hi, w))


# ---------------------------------------------------------------------------
# popularity bias correction (Eq. 3)
# ---------------------------------------------------------------------------

def popularity_bias_correction(edges: EdgeSet, n_nodes: int,
                               alpha: float = 0.3) -> EdgeSet:
    """w'_{i,j} = w_{i,j} * (w_{j,i} / sum_k w_{j,k})**alpha.

    After correction (i,j) and (j,i) carry different weights; the input
    must already contain both directions.
    """
    deg_w = np.zeros(n_nodes, np.float64)
    np.add.at(deg_w, edges.src, edges.weight.astype(np.float64))
    # w_{j,i}: weight of the reverse edge == weight of (i,j) pre-correction
    # (undirected input), so ratio uses this edge's own weight with the
    # *destination's* out-mass.
    ratio = edges.weight / np.maximum(deg_w[edges.dst], 1e-12)
    w = edges.weight * np.power(np.clip(ratio, 1e-12, 1.0), alpha)
    return EdgeSet(edges.src, edges.dst, w.astype(np.float32))


# ---------------------------------------------------------------------------
# subsampling
# ---------------------------------------------------------------------------

def topk_per_node(edges: EdgeSet, n_nodes: int, k_cap: int) -> EdgeSet:
    """Keep each source node's top-k_cap edges by weight."""
    if len(edges) == 0:
        return edges
    # sort by (src, -weight, dst): the dst tiebreak makes the cut
    # independent of input edge order (incremental refresh produces the
    # same edge *set* as a full rebuild but in a different order)
    order = np.lexsort((edges.dst, -edges.weight, edges.src))
    s, d, w = edges.src[order], edges.dst[order], edges.weight[order]
    starts = np.flatnonzero(np.r_[True, s[1:] != s[:-1]])
    seg_id = np.cumsum(np.r_[True, s[1:] != s[:-1]]) - 1
    rank = np.arange(len(s)) - starts[seg_id]
    keep = rank < k_cap
    return EdgeSet(s[keep], d[keep], w[keep])


def retain_users_by_value(ui: EdgeSet, n_users: int, budget: int) -> np.ndarray:
    """Paper: 'retain ~0.1B nodes prioritized by business value'.

    Business value proxy = total engagement weight.  Returns a bool mask
    of retained users (used for U-U construction only; *all* users stay
    in U-I edges, per the paper).
    """
    val = np.zeros(n_users, np.float64)
    np.add.at(val, ui.src, ui.weight.astype(np.float64))
    if budget >= n_users:
        return np.ones(n_users, bool)
    thresh = np.partition(val, n_users - budget)[n_users - budget]
    mask = val >= thresh
    # ties may overshoot; trim deterministically
    if mask.sum() > budget:
        idx = np.flatnonzero(mask)
        mask = np.zeros(n_users, bool)
        mask[idx[np.argsort(-val[idx], kind="stable")[:budget]]] = True
    return mask


def filter_edges(edges: EdgeSet, keep_src: np.ndarray,
                 keep_dst: np.ndarray) -> EdgeSet:
    m = keep_src[edges.src] & keep_dst[edges.dst]
    return EdgeSet(edges.src[m], edges.dst[m], edges.weight[m])


# ---------------------------------------------------------------------------
# full pipeline
# ---------------------------------------------------------------------------

def _finalize_graph(n_users: int, n_items: int, ui_full: EdgeSet,
                    uu_raw: EdgeSet, ii_raw: EdgeSet, *, alpha_pop: float,
                    k_cap: int, state_params: Dict, keep_state: bool,
                    started: float,
                    hub_draws: Optional[Dict[str, HubDraws]] = None
                    ) -> HeteroGraph:
    """Shared tail of full build and incremental refresh: Eq.3 correction,
    top-K_CAP subsampling, group split, state retention."""
    uu = _mirror(uu_raw)
    ii = popularity_bias_correction(_mirror(ii_raw), n_items,
                                    alpha=alpha_pop)
    # the published graph carries f32 weights; rounding happens HERE
    # (once, from the exact f64 aggregate) in both build and refresh
    ui_f32 = EdgeSet(ui_full.src, ui_full.dst,
                     ui_full.weight.astype(np.float32))
    ui_s = topk_per_node(ui_f32, n_users, k_cap)
    uu_s = topk_per_node(uu, n_users, k_cap)
    ii_s = topk_per_node(ii, n_items, k_cap)

    g1u = np.zeros(n_users, bool)
    g1u[uu_s.src] = True
    g1i = np.zeros(n_items, bool)
    g1i[ii_s.src] = True

    state = (RefreshState(ui_full, uu_raw, ii_raw, dict(state_params),
                          hub_draws=hub_draws)
             if keep_state else None)
    return HeteroGraph(n_users, n_items, ui_s, uu_s, ii_s,
                       group1_users=g1u, group1_items=g1i,
                       # seconds since ``started`` (a perf_counter reading)
                       build_seconds=time.perf_counter() - started,
                       refresh=state)


def build_graph(log: EngagementLog, *,
                alpha_pop: float = 0.3,
                c_u: int = 2, c_i: int = 2,
                k_cap: int = 64,
                hub_cap: int = 32,
                user_budget: Optional[int] = None,
                event_weights: Optional[Dict[int, float]] = None,
                seed: int = 0,
                keep_state: bool = False) -> HeteroGraph:
    """End-to-end construction (paper Figure 2A).

    ``keep_state`` retains the pre-subsample aggregates on the returned
    graph so ``refresh_graph`` can splice in an hour-level delta later
    (opt-in: the raw co-pair sets can dwarf the subsampled graph).
    """
    started = time.perf_counter()
    ui = build_ui_edges(log, event_weights)

    # (1) user retention by business value for the U-U side
    keep_u = retain_users_by_value(ui, log.n_users,
                                   user_budget or log.n_users)
    ui_for_uu = filter_edges(ui, keep_u, np.ones(log.n_items, bool))

    lo, hi, w, uu_draws = _co_engagement(ui_for_uu.dst, ui_for_uu.src,
                                         ui_for_uu.weight, log.n_users,
                                         c_u, hub_cap, seed, "uu")
    uu_raw = EdgeSet(lo, hi, w)
    lo, hi, w, ii_draws = _co_engagement(ui.src, ui.dst, ui.weight,
                                         log.n_items, c_i, hub_cap,
                                         seed, "ii")
    ii_raw = EdgeSet(lo, hi, w)
    params = dict(alpha_pop=alpha_pop, c_u=c_u, c_i=c_i, k_cap=k_cap,
                  hub_cap=hub_cap, user_budget=user_budget,
                  event_weights=event_weights, seed=seed)
    return _finalize_graph(log.n_users, log.n_items, ui, uu_raw,
                           ii_raw, alpha_pop=alpha_pop, k_cap=k_cap,
                           state_params=params,
                           keep_state=keep_state, started=started,
                           hub_draws={"uu": uu_draws,
                                      "ii": ii_draws})


# ---------------------------------------------------------------------------
# padded adjacency (feeds PPR + training data)
# ---------------------------------------------------------------------------

def padded_adjacency(edges: EdgeSet, n_src: int, max_deg: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """(n_src, max_deg) neighbor ids (-1 pad) + weights, top-weight order."""
    nbrs = np.full((n_src, max_deg), -1, np.int64)
    wts = np.zeros((n_src, max_deg), np.float32)
    if len(edges) == 0:
        return nbrs, wts
    # dst tiebreak: row content independent of input edge order
    order = np.lexsort((edges.dst, -edges.weight, edges.src))
    s, d, w = edges.src[order], edges.dst[order], edges.weight[order]
    starts = np.flatnonzero(np.r_[True, s[1:] != s[:-1]])
    seg_id = np.cumsum(np.r_[True, s[1:] != s[:-1]]) - 1
    rank = np.arange(len(s)) - starts[seg_id]
    keep = rank < max_deg
    nbrs[s[keep], rank[keep]] = d[keep]
    wts[s[keep], rank[keep]] = w[keep]
    return nbrs, wts


# ---------------------------------------------------------------------------
# hour-level incremental refresh (paper §4.2 "hourly rebuild", done as a
# delta splice instead of a from-scratch batch job)
# ---------------------------------------------------------------------------

def merge_edge_aggregates(a: EdgeSet, b: EdgeSet, n_dst: int) -> EdgeSet:
    """Sum two per-(src, dst) aggregated edge sets; canonical key order.
    Weights accumulate in float64 end-to-end (see ``build_ui_edges``)."""
    key = np.concatenate([a.src.astype(np.int64) * n_dst + a.dst,
                          b.src.astype(np.int64) * n_dst + b.dst])
    w = np.concatenate([a.weight, b.weight]).astype(np.float64)
    uniq, inv = np.unique(key, return_inverse=True)
    agg = np.zeros(len(uniq), np.float64)
    np.add.at(agg, inv, w)
    keep = agg > 0
    uniq, agg = uniq[keep], agg[keep]
    return EdgeSet((uniq // n_dst).astype(np.int64),
                   (uniq % n_dst).astype(np.int64),
                   agg)


def _canonical_pair_order(e: EdgeSet, n_other: int) -> EdgeSet:
    """Sort canonical (lo < hi) pairs by packed key — the order
    ``_co_engagement`` emits, so refreshed raws are bitwise comparable
    (and bitwise *accumulable*, e.g. in Eq. 3) to a full rebuild's."""
    order = np.argsort(e.src.astype(np.int64) * n_other + e.dst,
                       kind="stable")
    return EdgeSet(e.src[order], e.dst[order], e.weight[order])


def _merge_hub_draws(prev: Optional[HubDraws], new: HubDraws,
                     recomputed: np.ndarray, cap: int) -> HubDraws:
    """Carry forward persisted hub draws: rows for anchors outside the
    recomputed set survive from ``prev``; recomputed anchors take their
    fresh rows from ``new`` (which already reused matching prev rows)."""
    if prev is None or len(prev.anchor_ids) == 0:
        return new
    keep = ~np.isin(prev.anchor_ids, recomputed)
    ids = np.concatenate([prev.anchor_ids[keep], new.anchor_ids])
    offs = np.concatenate([prev.offsets[keep], new.offsets]) \
        if len(ids) else np.zeros((0, cap), np.int64)
    lens = np.concatenate([prev.lens[keep], new.lens])
    order = np.argsort(ids, kind="stable")
    return HubDraws(ids[order], offs[order], lens[order])


def _recompute_touching_pairs(anchor: np.ndarray, other: np.ndarray,
                              w: np.ndarray, touched_other: np.ndarray,
                              n_other: int, min_common: int, hub_cap: int,
                              seed: int, tag: str,
                              prev_draws: Optional[HubDraws]
                              ) -> Tuple[np.ndarray, ...]:
    """Re-derive all co-engagement pairs with >= 1 touched endpoint.

    Every anchor adjacent to a touched ``other`` node is re-expanded in
    full (a touched pair's common anchors are all adjacent to its touched
    endpoint, so the recomputed weights/counts are complete); pairs whose
    endpoints are both untouched are discarded — their old values stand.

    Returns ``(lo, hi, w, draws, recomputed_anchor_ids)``.
    """
    if len(anchor):
        a_mask = np.zeros(int(anchor.max()) + 1, bool)
        a_mask[anchor[touched_other[other]]] = True
        sel = a_mask[anchor]
        recomputed = np.flatnonzero(a_mask)
    else:
        sel = np.zeros(0, bool)
        recomputed = np.zeros(0, np.int64)
    lo, hi, pw, draws = _co_engagement(anchor[sel], other[sel], w[sel],
                                       n_other, min_common, hub_cap,
                                       seed, tag, prev_draws)
    touching = touched_other[lo] | touched_other[hi]
    return lo[touching], hi[touching], pw[touching], draws, recomputed


def _hub_resample_members(old_ui: EdgeSet, new_ui: EdgeSet,
                          anchor_of, other_of, n_anchor: int,
                          cap: int) -> np.ndarray:
    """Other-side members of anchors whose *degree* changed past the hub
    cap.  A hub anchor's subsample draw is keyed by (anchor id, degree)
    — a degree change redraws it, which can add or drop co-pairs between
    endpoints the delta never touched.  Marking every member of such an
    anchor as touched routes all its pairs through the full
    re-expansion, preserving refresh == rebuild bitwise."""
    old_deg = np.bincount(anchor_of(old_ui), minlength=n_anchor)
    new_deg = np.bincount(anchor_of(new_ui), minlength=n_anchor)
    changed = ((old_deg != new_deg)
               & (np.maximum(old_deg, new_deg) > cap))
    if not changed.any():
        return np.zeros(0, np.int64)
    sel_old = changed[anchor_of(old_ui)]
    sel_new = changed[anchor_of(new_ui)]
    return np.union1d(other_of(old_ui)[sel_old], other_of(new_ui)[sel_new])


def refresh_graph(g: HeteroGraph, delta_log: EngagementLog
                  ) -> Tuple[HeteroGraph, Dict[str, np.ndarray]]:
    """Splice a trailing-window delta into an existing graph (paper's
    hour-level item-coverage path: no from-scratch rebuild).

    Only co-engagement pairs reachable from the delta are re-derived;
    the cheap O(E) tails (Eq. 3 correction, top-K subsampling) run in
    full.  Every retained edge matches a from-scratch build on the
    merged window bit-for-bit — including when ``hub_cap`` triggers:
    hub-subsample offsets are keyed by (anchor id, degree)
    (``hub_uniforms``) and persisted per anchor in ``RefreshState``, so
    untouched anchors reuse their draws and re-expanded anchors
    regenerate exactly the draws a full rebuild would consume.  Both id
    spaces may grow (``delta_log.n_users >= g.n_users``,
    ``delta_log.n_items >= g.n_items``); grown tails count as touched.

    Returns ``(new_graph, report)`` with ``report['touched_users'] /
    ['touched_items']`` — the nodes whose edge sets may have changed.
    """
    st = g.refresh
    if st is None:
        raise ValueError("graph was built without keep_state=True; "
                         "no refresh aggregates retained")
    p = st.params
    if p.get("user_budget"):
        raise ValueError("incremental refresh with a user retention "
                         "budget is not supported (retention is a "
                         "global decision; re-run build_graph)")
    if delta_log.n_users < g.n_users:
        raise ValueError("user space may only grow")
    if delta_log.n_items < g.n_items:
        raise ValueError("item space may only grow")
    started = time.perf_counter()
    nu, ni = delta_log.n_users, delta_log.n_items
    seed = p.get("seed", 0)
    cap = p["hub_cap"]
    draws = st.hub_draws or {}

    # 1) merge the delta's aggregated U-I engagements
    d_ui = build_ui_edges(delta_log, p.get("event_weights"))
    ui_full = merge_edge_aggregates(st.ui_full, d_ui, ni)
    touched_u = np.unique(delta_log.user_id)
    touched_i = np.unique(delta_log.item_id)
    if nu > g.n_users:       # grown tail = brand-new users
        touched_u = np.union1d(touched_u, np.arange(g.n_users, nu))
    if ni > g.n_items:       # grown tail = brand-new items
        touched_i = np.union1d(touched_i, np.arange(g.n_items, ni))
    # degree-changed hub anchors redraw their subsample: their
    # members' co-pairs must be recomputed even if the delta never
    # touched them
    touched_u = np.union1d(touched_u, _hub_resample_members(
        st.ui_full, ui_full, lambda e: e.dst, lambda e: e.src, ni,
        cap))
    touched_i = np.union1d(touched_i, _hub_resample_members(
        st.ui_full, ui_full, lambda e: e.src, lambda e: e.dst, nu,
        cap))
    um = np.zeros(nu, bool)
    um[touched_u] = True
    im = np.zeros(ni, bool)
    im[touched_i] = True

    # 2) re-derive co-engagement pairs touching the delta
    lo, hi, w, uu_new, uu_rec = _recompute_touching_pairs(
        ui_full.dst, ui_full.src, ui_full.weight, um, nu,
        p["c_u"], cap, seed, "uu", draws.get("uu"))
    keep = ~(um[st.uu_raw.src] | um[st.uu_raw.dst])
    uu_raw = _canonical_pair_order(
        EdgeSet(np.r_[st.uu_raw.src[keep], lo],
                np.r_[st.uu_raw.dst[keep], hi],
                np.r_[st.uu_raw.weight[keep], w]), nu)
    uu_draws = _merge_hub_draws(draws.get("uu"), uu_new, uu_rec, cap)

    lo, hi, w, ii_new, ii_rec = _recompute_touching_pairs(
        ui_full.src, ui_full.dst, ui_full.weight, im, ni,
        p["c_i"], cap, seed, "ii", draws.get("ii"))
    keep = ~(im[st.ii_raw.src] | im[st.ii_raw.dst])
    ii_raw = _canonical_pair_order(
        EdgeSet(np.r_[st.ii_raw.src[keep], lo],
                np.r_[st.ii_raw.dst[keep], hi],
                np.r_[st.ii_raw.weight[keep], w]), ni)
    ii_draws = _merge_hub_draws(draws.get("ii"), ii_new, ii_rec, cap)

    # 3) cheap O(E) tails in full (Eq. 3, top-K, groups)
    g_new = _finalize_graph(nu, ni, ui_full, uu_raw, ii_raw,
                            alpha_pop=p["alpha_pop"],
                            k_cap=p["k_cap"], state_params=p,
                            keep_state=True, started=started,
                            hub_draws={"uu": uu_draws,
                                       "ii": ii_draws})
    report = dict(touched_users=touched_u, touched_items=touched_i)
    return g_new, report
