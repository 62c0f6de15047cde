"""Personalized-PageRank neighbour pre-computation (paper §4.2), as
``repro/core/ppr.py``.

Monte-Carlo approximation: R walks of length L with restart 0.15 from
every node over the subsampled heterogeneous graph, in a padded,
type-balanced adjacency (``build_padded_hetero_adj``, host numpy).  Two
backends with bit-identical output, selected by ``backend=``:

  * ``numpy``   the chunked vectorised host walker and host top-k (a
                copy of the JAX package's reference backend);
  * ``device``  the ``ppr_walk`` op on the adjacency's device (the CUDA
                kernel on a card, its plain version on the CPU), fused
                with first-occurrence visit counting, then top-k on the
                same device — the counterpart of the JAX ``pallas``
                backend.

Both consume the same host-made uniform stream (``walk_uniforms``,
keyed by node id in ``U_BLOCK`` blocks), so their traces are exactly
equal, and an incremental refresh that re-walks only the affected nodes
(``refresh_ppr_neighbors``) reproduces the traces a full rebuild would
walk for them.

Group-2 handling (nodes without same-type neighbours) lives in
``group2_neighbors``: KNN over previous-run Group-1 embeddings, host
numpy as in the reference (a device product would round differently
and flip near-tie neighbours).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.graph_builder import (EdgeSet, HeteroGraph,
                                            padded_adjacency)
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.ppr_walk.ops import ppr_walk
from repro_torch.kernels.ppr_walk.ppr_walk import WalkLayout, walk_layout
from repro_torch.kernels.ppr_walk.ref import last_valid_cols as _last_dev


@dataclasses.dataclass
class PaddedHeteroAdj:
    """Per-node fixed-width neighbour tables in a unified id space.

    Global ids: users are [0, n_users), items are [n_users, n_users+n_items).
    ``nbrs`` (n, D) int64 (-1 pad), ``cum`` (n, D) float32 cumulative
    transition probabilities (type-balanced), row-normalized.
    """
    nbrs: np.ndarray
    cum: np.ndarray
    n_users: int
    n_items: int

    @property
    def n_nodes(self) -> int:
        return self.n_users + self.n_items


def build_padded_hetero_adj(g: HeteroGraph, max_deg_per_type: int = 32
                            ) -> PaddedHeteroAdj:
    nu, ni = g.n_users, g.n_items
    D = max_deg_per_type
    # per-type padded adjacencies
    uu_n, uu_w = padded_adjacency(g.uu, nu, D)
    ii_n, ii_w = padded_adjacency(g.ii, ni, D)
    ui_n, ui_w = padded_adjacency(g.ui, nu, D)
    # reverse U-I (item -> engaging users), built from the same edges
    iu = EdgeSet(g.ui.dst, g.ui.src, g.ui.weight)
    iu_n, iu_w = padded_adjacency(iu, ni, D)

    n = nu + ni
    nbrs = np.full((n, 2 * D), -1, np.int64)
    probs = np.zeros((n, 2 * D), np.float64)

    def _fill(rows_off, block, nb, wt, id_off):
        nbrs[rows_off:rows_off + len(nb), block * D:(block + 1) * D] = \
            np.where(nb >= 0, nb + id_off, -1)
        probs[rows_off:rows_off + len(nb), block * D:(block + 1) * D] = wt

    # users: block0 = U-U (user ids), block1 = U-I (item ids)
    _fill(0, 0, uu_n, uu_w, 0)
    _fill(0, 1, ui_n, ui_w, nu)
    # items: block0 = I-I (item ids), block1 = I-U (user ids)
    _fill(nu, 0, ii_n, ii_w, nu)
    _fill(nu, 1, iu_n, iu_w, 0)

    # type-balanced normalization: each present type gets equal mass
    for blk in (0, 1):
        sl = slice(blk * D, (blk + 1) * D)
        tot = probs[:, sl].sum(axis=1, keepdims=True)
        probs[:, sl] = np.where(tot > 0, probs[:, sl] / np.maximum(tot, 1e-12),
                                0.0)
    ntypes = ((probs[:, :D].sum(1) > 0).astype(np.float64)
              + (probs[:, D:].sum(1) > 0).astype(np.float64))
    ntypes = np.maximum(ntypes, 1.0)
    probs /= ntypes[:, None]
    # rows with no out-edges: self-loop semantics handled at walk time
    cum = np.cumsum(probs, axis=1).astype(np.float32)
    return PaddedHeteroAdj(nbrs, cum, nu, ni)


# ---------------------------------------------------------------------------
# shared uniform stream (all backends)
# ---------------------------------------------------------------------------

U_BLOCK = 4096       # starts per RNG block — the refresh regeneration unit


def walk_uniforms(seed: int, ids: np.ndarray, n_walks: int, walk_len: int,
                  n_users: int = 0) -> np.ndarray:
    """f32 uniforms for the given start node ids: (len(ids), n_walks,
    2*walk_len); column 2t drives step t's transition draw, column 2t+1
    its restart draw.

    The stream is keyed by *node id within its type* — users by user id,
    items by item-local id (global id minus ``n_users``) — in fixed
    ``U_BLOCK``-sized blocks, not by position in ``ids`` or by chunk
    layout.  A refresh that re-walks an arbitrary subset of nodes
    therefore regenerates exactly the draws a full run over ``arange(n)``
    would have consumed for them, and growth of *either* id space leaves
    every pre-existing node's draws unchanged (user growth shifts item
    global ids, but not their item-local stream keys).
    """
    ids = np.asarray(ids, np.int64)
    out = np.empty((len(ids), n_walks, 2 * walk_len), np.float32)
    side = (ids >= n_users).astype(np.int64)       # 0 = user, 1 = item
    local = ids - side * n_users
    blocks = local // U_BLOCK
    for s, b in {(int(s), int(b)) for s, b in zip(side, blocks)}:
        m = (side == s) & (blocks == b)
        rng = np.random.default_rng((seed, s, b))
        blk = rng.random((U_BLOCK, n_walks, 2 * walk_len),
                         dtype=np.float32)
        out[m] = blk[local[m] - b * U_BLOCK]
    return out


def last_valid_cols(cum: np.ndarray) -> np.ndarray:
    """Per row, the last column carrying positive transition mass (0 for
    dangling rows — the dead-row check stops those walkers anyway)."""
    inc = np.empty(cum.shape, bool)
    inc[:, 0] = cum[:, 0] > 0
    inc[:, 1:] = cum[:, 1:] > cum[:, :-1]
    return np.where(inc, np.arange(cum.shape[1])[None, :], 0).max(axis=1)


# ---------------------------------------------------------------------------
# numpy Monte-Carlo walker
# ---------------------------------------------------------------------------

def _step(nbrs: np.ndarray, cum: np.ndarray, last: np.ndarray,
          pos: np.ndarray, u: np.ndarray) -> np.ndarray:
    c = cum[pos]                                   # (m, D2)
    col = (c < u[:, None]).sum(axis=1)
    # f32 rounding can leave cum[-1] slightly below 1.0; an overflowing
    # draw must land on the last *valid* neighbor column, not a trailing
    # -1 pad (which would silently stall the walker at `pos` and bias
    # visit counts toward the start node).
    col = np.minimum(col, last[pos])
    nxt = nbrs[pos, col]
    dead = (nxt < 0) | (c[:, -1] <= 0)             # dangling -> stay
    return np.where(dead, pos, nxt)


def _walk_numpy(adj: PaddedHeteroAdj, starts: np.ndarray, *, n_walks: int,
                walk_len: int, restart: float, seed: int,
                chunk: int) -> np.ndarray:
    last = last_valid_cols(adj.cum)
    r32 = np.float32(restart)
    n_start = len(starts)
    S = n_walks * walk_len
    visited = np.empty((n_start, S), np.int64)
    step_rows = max(1, chunk // n_walks)
    for lo in range(0, n_start, step_rows):
        hi = min(n_start, lo + step_rows)
        home = np.repeat(starts[lo:hi], n_walks)
        u = walk_uniforms(seed, starts[lo:hi], n_walks, walk_len,
                          adj.n_users).reshape(len(home), 2 * walk_len)
        pos = home.copy()
        block = np.empty((len(home), walk_len), np.int64)
        for t in range(walk_len):
            pos = _step(adj.nbrs, adj.cum, last, pos, u[:, 2 * t])
            pos = np.where(u[:, 2 * t + 1] < r32, home, pos)
            block[:, t] = pos
        visited[lo:hi] = block.reshape(hi - lo, S)
    return visited


# ---------------------------------------------------------------------------
# device walker: the ppr_walk op, chunk by chunk
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DeviceAdj:
    """A ``PaddedHeteroAdj`` on a device: int32 ids, f32 cum, the per-row
    last positive column the walk clamps to, and the kernel's
    ``walk_layout`` of them, built once for every chunk's walk."""
    nbrs: torch.Tensor
    cum: torch.Tensor
    last: torch.Tensor
    layout: WalkLayout
    n_users: int
    n_items: int

    @property
    def n_nodes(self) -> int:
        return self.n_users + self.n_items


def adjacency_to_device(adj: PaddedHeteroAdj, device=None) -> DeviceAdj:
    dev = resolve_device(device)
    nbrs = torch.as_tensor(adj.nbrs.astype(np.int32)).to(dev)
    cum = torch.as_tensor(np.asarray(adj.cum, np.float32)).to(dev)
    last = _last_dev(cum)
    return DeviceAdj(nbrs, cum, last, walk_layout(nbrs, cum, last),
                     adj.n_users, adj.n_items)


def _walk_device(adj: DeviceAdj, starts: np.ndarray, *, n_walks: int,
                 walk_len: int, restart: float, seed: int,
                 chunk: int = 1 << 18
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused walk + first-occurrence counts through the ``ppr_walk`` op,
    ``chunk`` walkers at a time.  The uniforms are made on the host (the
    cross-backend contract) and copied to the device once per chunk.
    Returns (visited, counts), each (n, S) int32 on the adjacency's
    device."""
    dev = adj.nbrs.device
    starts = np.asarray(starts, np.int64)
    n = len(starts)
    S = n_walks * walk_len
    visited = torch.empty((n, S), dtype=torch.int32, device=dev)
    counts = torch.empty((n, S), dtype=torch.int32, device=dev)
    step_rows = max(1, chunk // n_walks)
    for lo in range(0, n, step_rows):
        hi = min(n, lo + step_rows)
        u = torch.from_numpy(walk_uniforms(seed, starts[lo:hi], n_walks,
                                           walk_len, adj.n_users)).to(dev)
        st = torch.from_numpy(starts[lo:hi].astype(np.int32)).to(dev)
        visited[lo:hi], counts[lo:hi] = ppr_walk(
            adj.nbrs, adj.cum, st, u, restart=restart, last=adj.last,
            layout=adj.layout)
    return visited, counts


BACKENDS = ("numpy", "device")


def ppr_visit_counts(adj: PaddedHeteroAdj, starts: np.ndarray, *,
                     n_walks: int = 64, walk_len: int = 5,
                     restart: float = 0.15, seed: int = 0,
                     chunk: int = 1 << 18, backend: str = "numpy",
                     device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (visited, starts): (n_starts, n_walks*walk_len) int64 node
    ids per start, on the host.  Memory-chunked over starts; both
    backends are bit-identical (shared uniform stream, see
    ``walk_uniforms``); ``device`` walks on ``device`` (CUDA unless given
    ``"cpu"``)."""
    starts = np.asarray(starts, np.int64)
    if backend == "numpy":
        visited = _walk_numpy(adj, starts, n_walks=n_walks,
                              walk_len=walk_len, restart=restart,
                              seed=seed, chunk=chunk)
    elif backend == "device":
        vis, _ = _walk_device(adjacency_to_device(adj, device), starts,
                              n_walks=n_walks, walk_len=walk_len,
                              restart=restart, seed=seed, chunk=chunk)
        visited = vis.cpu().numpy().astype(np.int64)
    else:
        raise ValueError(f"unknown backend {backend!r}; want {BACKENDS}")
    return visited, starts


# ---------------------------------------------------------------------------
# visit counting + top-k (host numpy, and the device counterpart)
# ---------------------------------------------------------------------------

def _run_length_counts(srt: np.ndarray) -> np.ndarray:
    """Per-row run-length counts over row-sorted visit lists: the count
    of each run at its first position, 0 elsewhere.  Fully vectorized
    (suffix-min of run-start indices), no per-column Python loop."""
    n, S = srt.shape
    newrun = np.ones_like(srt, bool)
    newrun[:, 1:] = srt[:, 1:] != srt[:, :-1]
    idx = np.arange(S)[None, :]
    # index of this-or-next run start at each position (suffix minimum)
    run_idx = np.where(newrun, idx, S)
    nxt_incl = np.minimum.accumulate(run_idx[:, ::-1], axis=1)[:, ::-1]
    # next run start strictly after j = suffix min over k > j
    nxt = np.concatenate([nxt_incl[:, 1:], np.full((n, 1), S)], axis=1)
    return np.where(newrun, nxt - idx, 0)


def _topk_from_counts(vals: np.ndarray, counts: np.ndarray,
                      starts: np.ndarray, k: int, type_boundary: int,
                      hub_alpha: float, glob: Optional[np.ndarray]
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k selection given per-position visit counts (count at the
    first occurrence of each distinct node, 0 elsewhere).  Ties break by
    node id, so the result is independent of visit order — the fused
    device counts (visit order) and the host run-length counts (sorted
    order) select identical neighbors."""
    n, S = vals.shape
    scores = counts.astype(np.float64)
    scores[vals == starts[:, None]] = 0.0          # drop self visits
    if hub_alpha > 0.0:
        if glob is None:
            glob = np.bincount(vals.reshape(-1),
                               weights=counts.reshape(-1).astype(
                                   np.float64))
        scores = scores / np.maximum(glob[vals], 1.0) ** hub_alpha

    def _top(side_mask):
        c = np.where(side_mask, scores, 0.0)
        kk = min(k, S)
        order = np.lexsort((vals, -c), axis=-1)[:, :kk]
        rows = np.arange(n)[:, None]
        top_c = c[rows, order]
        out = np.where(top_c > 0, vals[rows, order], -1)
        if kk < k:
            out = np.pad(out, ((0, 0), (0, k - kk)), constant_values=-1)
        return out

    users = _top(vals < type_boundary)
    items = _top(vals >= type_boundary)
    return users, items


def _topk_from_counts_device(vals: torch.Tensor, counts: torch.Tensor,
                             starts: torch.Tensor, k: int,
                             type_boundary: int, hub_alpha: float,
                             glob: np.ndarray
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_topk_from_counts`` on the tensors' device, bitwise equal to it.

    Scores stay float64 as on the host.  The per-node hub factor
    ``max(glob, 1) ** hub_alpha`` is taken with numpy on the host, as the
    host path takes it (a device ``pow`` can round differently by an
    ulp and flip a near-tie); the division is IEEE on both sides.
    ``np.lexsort((vals, -c))`` is two stable sorts: by node id, then by
    ``-c``.  Returns (users, items), each (n, k) int64, -1 padded."""
    n, S = vals.shape
    vals = vals.to(torch.int64)
    scores = counts.to(torch.float64)
    scores = torch.where(vals == starts.to(torch.int64)[:, None], 0.0,
                         scores)
    if hub_alpha > 0.0:
        den = torch.from_numpy(np.maximum(glob, 1.0) ** hub_alpha)
        scores = scores / den.to(vals.device)[vals]
    by_id = torch.sort(vals, dim=1, stable=True).indices
    kk = min(k, S)

    def _top(side_mask):
        c = torch.where(side_mask, scores, 0.0).gather(1, by_id)
        order = torch.sort(-c, dim=1, stable=True).indices[:, :kk]
        top_c = c.gather(1, order)
        top_v = vals.gather(1, by_id.gather(1, order))
        out = torch.where(top_c > 0, top_v, -1)
        if kk < k:
            out = torch.nn.functional.pad(out, (0, k - kk), value=-1)
        return out

    return _top(vals < type_boundary), _top(vals >= type_boundary)


def global_visit_mass(visited: np.ndarray, n_nodes: int) -> np.ndarray:
    """Total visit count per node across all starts (hub correction)."""
    return np.bincount(visited.reshape(-1), minlength=n_nodes
                       ).astype(np.float64)


def topk_by_count(visited: np.ndarray, starts: np.ndarray, k: int,
                  type_boundary: int, n_users: int,
                  hub_alpha: float = 0.0,
                  glob: Optional[np.ndarray] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k most-visited user and item neighbors per start node.

    Vectorized run-length counting over row-sorted visit lists.
    Returns (user_nbrs, item_nbrs): (n, k) global-id arrays, -1 padded.
    ``type_boundary`` == n_users splits the unified id space.

    ``hub_alpha`` > 0 ranks by *relative* PPR: per-start visit counts
    divided by each node's global visit mass**alpha (personalized score
    relative to global PageRank).  ``glob`` overrides the global mass.
    """
    srt = np.sort(visited, axis=1)
    counts = _run_length_counts(srt)
    if hub_alpha > 0.0 and glob is None:
        glob = global_visit_mass(visited, int(visited.max()) + 1)
    return _topk_from_counts(srt, counts, starts, k, type_boundary,
                             hub_alpha, glob)


# ---------------------------------------------------------------------------
# precompute + incremental refresh
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PPRState:
    """Everything ``refresh_ppr_neighbors`` needs to splice new walks
    into an existing run: the visit traces, the adjacency snapshot the
    traces were walked on (for change detection), the user/item split of
    its unified id space (user growth shifts item global ids — the
    remap pass needs the old boundary), and the walk knobs.  All of it
    lives on the host, whichever backend walked."""
    visited: np.ndarray          # (n_nodes, n_walks*walk_len) int64
    nbrs: np.ndarray             # padded adjacency at build time
    cum: np.ndarray
    n_walks: int
    walk_len: int
    restart: float
    seed: int
    max_deg_per_type: int
    hub_alpha: float
    k_imp: int
    backend: str
    n_users: int = 0             # unified-id boundary at build time


def precompute_ppr_neighbors(g: HeteroGraph, *, k_imp: int = 50,
                             n_walks: int = 64, walk_len: int = 5,
                             restart: float = 0.15, seed: int = 0,
                             max_deg_per_type: int = 32,
                             hub_alpha: float = 0.5,
                             backend: str = "numpy",
                             return_state: bool = False, device=None):
    """(user_nbrs, item_nbrs): (n_users+n_items, k_imp) int64 global ids,
    -1 pad; identical for every ``backend``.  ``backend="device"`` walks
    and ranks on ``device`` (CUDA unless given ``"cpu"``).
    ``return_state`` additionally returns the ``PPRState``."""
    adj = build_padded_hetero_adj(g, max_deg_per_type)
    starts = np.arange(adj.n_nodes, dtype=np.int64)
    if backend == "device":
        dadj = adjacency_to_device(adj, device)
        vis, cnt = _walk_device(dadj, starts, n_walks=n_walks,
                                walk_len=walk_len, restart=restart,
                                seed=seed)
        dev = vis.device
        glob = torch.bincount(vis.reshape(-1).to(torch.int64),
                              minlength=adj.n_nodes
                              ).to(torch.float64).cpu().numpy()
        u, i = _topk_from_counts_device(
            vis, cnt, torch.from_numpy(starts).to(dev), k_imp, g.n_users,
            hub_alpha, glob)
        users, items = u.cpu().numpy(), i.cpu().numpy()
        visited = vis.cpu().numpy().astype(np.int64) if return_state \
            else None
    elif backend == "numpy":
        visited = _walk_numpy(adj, starts, n_walks=n_walks,
                              walk_len=walk_len, restart=restart, seed=seed,
                              chunk=1 << 18)
        users, items = topk_by_count(
            visited, starts, k_imp, g.n_users, g.n_users,
            hub_alpha=hub_alpha,
            glob=global_visit_mass(visited, adj.n_nodes))
    else:
        raise ValueError(f"unknown backend {backend!r}; want {BACKENDS}")
    if return_state:
        state = PPRState(visited, adj.nbrs, adj.cum, n_walks, walk_len,
                         restart, seed, max_deg_per_type, hub_alpha,
                         k_imp, backend, n_users=g.n_users)
        return users, items, state
    return users, items


def _expand_affected(nbrs: np.ndarray, changed: np.ndarray, hops: int
                     ) -> np.ndarray:
    """Nodes whose visit trace can differ: anything that reaches a
    changed adjacency row within ``hops`` steps (reverse BFS).  A walk
    diverges only after stepping *from* a changed row, and the identical
    prefix up to that row exists in the new adjacency, so BFS over the
    new adjacency is sufficient."""
    n, _ = nbrs.shape
    src = np.repeat(np.arange(n), nbrs.shape[1])
    dst = nbrs.reshape(-1)
    m = dst >= 0
    src, dst = src[m], dst[m]
    affected = changed.copy()
    frontier = changed
    for _ in range(max(0, hops)):
        newf = np.zeros(n, bool)
        newf[src[frontier[dst]]] = True
        newf &= ~affected
        if not newf.any():
            break
        affected |= newf
        frontier = newf
    return affected


def refresh_ppr_neighbors(g_new: HeteroGraph, user_nbrs: np.ndarray,
                          item_nbrs: np.ndarray, state: PPRState, *,
                          backend: Optional[str] = None, device=None
                          ) -> Tuple[np.ndarray, np.ndarray, PPRState,
                                     np.ndarray]:
    """Splice an incremental graph refresh into existing PPR tables.

    Re-walks only the nodes whose ``walk_len``-hop neighborhoods saw an
    adjacency change (plus brand-new user/item rows), regenerates
    exactly the uniform draws a full run would have used for them, and
    re-ranks those rows against the spliced global visit mass — so every
    affected row is bit-identical to a from-scratch
    ``precompute_ppr_neighbors`` on the refreshed graph, and every
    unaffected row is left untouched (modulo the unified-id remap).

    Either id space may have grown.  Item growth appends rows; *user*
    growth shifts every item's global id by the number of new users, so
    carried-over rows first go through a remap pass: row ``r`` of the
    old layout moves to ``r + shift`` when ``r`` was an item row, and
    every item id stored *inside* a trace or neighbor table shifts the
    same way (-1 pads and user ids are fixed points).  The type-keyed
    uniform stream (``walk_uniforms``) makes the old traces valid
    verbatim after the remap.

    ``backend="device"`` walks the affected ids with the ``ppr_walk`` op
    and ranks them on ``device`` (CUDA unless given ``"cpu"``); the
    adjacency, the change detection, the spliced traces and their global
    mass stay on the host.  Returns (user_nbrs, item_nbrs, new_state,
    affected_ids) — ids in the *new* unified space.
    """
    backend = backend or state.backend
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; want {BACKENDS}")
    adj = build_padded_hetero_adj(g_new, state.max_deg_per_type)
    n_old = state.nbrs.shape[0]
    n_new = adj.n_nodes
    nu = g_new.n_users
    old_nu = state.n_users
    shift = nu - old_nu
    S = state.n_walks * state.walk_len

    # remap pass: old row positions + stored ids in the new unified space
    old_pos = np.arange(n_old)
    if shift:
        old_pos = np.where(old_pos >= old_nu, old_pos + shift, old_pos)

    def _remap(a: np.ndarray) -> np.ndarray:
        if not shift:
            return a
        return np.where(a >= old_nu, a + shift, a)   # -1 pads: fixed points

    changed = np.ones(n_new, bool)                 # inserted rows: changed
    changed[old_pos] = (np.any(adj.nbrs[old_pos] != _remap(state.nbrs),
                               axis=1)
                        | np.any(adj.cum[old_pos] != state.cum, axis=1))
    affected = _expand_affected(adj.nbrs, changed, state.walk_len - 1)
    ids = np.flatnonzero(affected)

    walk = dict(n_walks=state.n_walks, walk_len=state.walk_len,
                restart=state.restart, seed=state.seed)
    visited = np.empty((n_new, S), np.int64)
    visited[old_pos] = _remap(state.visited)
    if len(ids):
        if backend == "device":
            vis_dev, cnt_dev = _walk_device(
                adjacency_to_device(adj, device), ids, **walk)
            vis_new = vis_dev.cpu().numpy().astype(np.int64)
        else:
            vis_new, _ = ppr_visit_counts(adj, ids, backend="numpy", **walk)
        visited[ids] = vis_new

    glob = global_visit_mass(visited, n_new)
    u_rows = np.full((n_new, state.k_imp), -1, np.int64)
    i_rows = np.full((n_new, state.k_imp), -1, np.int64)
    u_rows[old_pos] = _remap(user_nbrs)
    i_rows[old_pos] = _remap(item_nbrs)
    if len(ids):
        if backend == "device":
            u_new, i_new = _topk_from_counts_device(
                vis_dev, cnt_dev, torch.from_numpy(ids).to(vis_dev.device),
                state.k_imp, nu, state.hub_alpha, glob)
            u_new, i_new = u_new.cpu().numpy(), i_new.cpu().numpy()
        else:
            u_new, i_new = topk_by_count(vis_new, ids, state.k_imp, nu,
                                         nu, hub_alpha=state.hub_alpha,
                                         glob=glob)
        u_rows[ids] = u_new
        i_rows[ids] = i_new

    new_state = dataclasses.replace(state, visited=visited,
                                    nbrs=adj.nbrs, cum=adj.cum,
                                    backend=backend, n_users=nu)
    return u_rows, i_rows, new_state, ids


# ---------------------------------------------------------------------------
# Group 2 fallback (paper: KNN over previous Group-1 embeddings)
# ---------------------------------------------------------------------------

def group2_neighbors(prev_emb: np.ndarray, group1_ids: np.ndarray,
                     group2_ids: np.ndarray, k: int,
                     chunk: int = 4096) -> np.ndarray:
    """Same-type neighbors for Group-2 nodes = KNN (cosine) over Group-1
    embeddings from the previous training run (refreshed daily)."""
    if len(group1_ids) == 0 or len(group2_ids) == 0:
        return np.full((len(group2_ids), k), -1, np.int64)
    e1 = prev_emb[group1_ids]
    e1 = e1 / np.maximum(np.linalg.norm(e1, axis=1, keepdims=True), 1e-8)
    out = np.empty((len(group2_ids), k), np.int64)
    kk = min(k, len(group1_ids))
    for lo in range(0, len(group2_ids), chunk):
        hi = min(len(group2_ids), lo + chunk)
        q = prev_emb[group2_ids[lo:hi]]
        q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-8)
        sims = q @ e1.T
        top = np.argpartition(-sims, kk - 1, axis=1)[:, :kk]
        rows = np.arange(hi - lo)[:, None]
        o = np.argsort(-sims[rows, top], axis=1, kind="stable")
        sel = group1_ids[top[rows, o]]
        if kk < k:
            sel = np.pad(sel, ((0, 0), (0, k - kk)), constant_values=-1)
        out[lo:hi] = sel
    return out
