"""Edge-centric training data (paper §4.2 'Data format'), as
``repro/data/edge_dataset.py``: the PPR neighbour tables
(``build_neighbor_tables``), training batches in the three formats of
``BATCH_FORMATS`` (``sample_batch``; ``expand_batch`` re-lays a dedup
batch out per endpoint), the batch stream (``iter_batches``, and
``Prefetcher``, which makes it in a background thread) and the
inference-side gather (``node_inference_batch``).

Feature and neighbour tables live on the dataset's device (the role of
the JAX ``FeatureStore``) and every feature gather runs there: at
production size a host gather would move tens of GB of neighbour
features per corpus pass.  The random draws stay on the host, in numpy,
so they are bit-identical to the JAX package's: batch t of run ``seed``
is ``np.random.default_rng((seed, t))`` consumed in the same order (the
dedup formats: edge draws per type, then per node type a user- and an
item-neighbour draw; ``legacy``: per edge type the edge draw, then the
source and the destination side's neighbour draws), and an inference
gather re-makes ``np.random.default_rng(seed)`` per call.  A
``dedup_ids`` batch ships int32 ids, maps and f32 masks to the device;
the ``dedup`` and ``legacy`` formats gather their f32 features there.

Tables can keep the PPR state that powers the hour-level
``incremental_refresh`` (graph splice, re-walk of the affected nodes,
Group-2 KNN fill), which matches a from-scratch build on the merged
window on every affected row.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import ppr as ppr_mod
from repro_torch.core.graph_builder import HeteroGraph, refresh_graph
from repro_torch.kernels.common import resolve_device


@dataclasses.dataclass
class NeighborTables:
    """Pre-computed K_IMP neighbours per node, unified global id space
    (users [0, n_users), items [n_users, n_users+n_items)), -1 pad."""
    user_nbrs: np.ndarray    # (n_nodes, k_imp) global ids
    item_nbrs: np.ndarray    # (n_nodes, k_imp)
    n_users: int
    n_items: int
    ppr: Optional[ppr_mod.PPRState] = None   # refresh splice state


def _fill_group2(g: HeteroGraph, user_nbrs: np.ndarray,
                 item_nbrs: np.ndarray, prev_emb: np.ndarray, k_imp: int,
                 only: Optional[np.ndarray] = None) -> None:
    """Group-2 fallback: same-type neighbors via previous-run KNN
    (in-place; ``only`` restricts to a node-id subset, e.g. the nodes an
    incremental refresh actually touched)."""
    nu = g.n_users
    g2u = np.flatnonzero(~g.group1_users)
    g1u = np.flatnonzero(g.group1_users)
    g2i = np.flatnonzero(~g.group1_items)
    g1i = np.flatnonzero(g.group1_items)
    if only is not None:
        g2u = g2u[np.isin(g2u, only)]
        g2i = g2i[np.isin(g2i + nu, only)]
    if len(g2u) and len(g1u):
        knn = ppr_mod.group2_neighbors(prev_emb[:nu], g1u, g2u, k_imp)
        user_nbrs[g2u] = np.where(knn >= 0, knn, user_nbrs[g2u])
    if len(g2i) and len(g1i):
        knn = ppr_mod.group2_neighbors(prev_emb[nu:], g1i, g2i, k_imp)
        item_nbrs[nu + g2i] = np.where(knn >= 0, nu + knn,
                                       item_nbrs[nu + g2i])


def build_neighbor_tables(g: HeteroGraph, *, k_imp: int = 50,
                          n_walks: int = 64, walk_len: int = 5,
                          restart: float = 0.15, seed: int = 0,
                          prev_emb: Optional[np.ndarray] = None,
                          backend: str = "device", device=None,
                          keep_state: bool = False) -> NeighborTables:
    """PPR tables over the whole graph + Group-2 fallback (paper §4.2).
    ``backend`` selects the walker (``numpy`` on the host, ``device``:
    the ``ppr_walk`` op on ``device``); both give identical tables.
    ``prev_emb`` (previous-run embeddings, [users; items]) fills the
    same-type rows of Group-2 nodes by KNN; ``keep_state`` retains the
    visit traces that power ``incremental_refresh`` (opt-in:
    (n_nodes, n_walks*walk_len) int64 plus an adjacency snapshot)."""
    out = ppr_mod.precompute_ppr_neighbors(
        g, k_imp=k_imp, n_walks=n_walks, walk_len=walk_len,
        restart=restart, seed=seed, backend=backend,
        return_state=keep_state, device=device)
    user_nbrs, item_nbrs = out[:2]
    state = out[2] if keep_state else None
    if prev_emb is not None:
        _fill_group2(g, user_nbrs, item_nbrs, prev_emb, k_imp)
    return NeighborTables(user_nbrs, item_nbrs, g.n_users, g.n_items,
                          ppr=state)


def incremental_refresh(g: HeteroGraph, tables: NeighborTables,
                        new_log_window, *,
                        prev_emb: Optional[np.ndarray] = None,
                        backend: Optional[str] = None, device=None
                        ) -> Tuple[HeteroGraph, NeighborTables, Dict]:
    """Hour-level lifecycle refresh (paper §4.2): splice a trailing log
    window into an existing graph + PPR tables without a full rebuild.

    Edges are re-derived only for co-engagement pairs reachable from the
    delta (``graph_builder.refresh_graph``); walks re-run only for nodes
    whose walk-length neighborhood changed, and new nodes — *both* id
    spaces may grow — are spliced into the padded adjacencies and
    tables (``ppr.refresh_ppr_neighbors``, on ``device`` with the
    ``device`` backend; user growth additionally remaps the unified id
    space, shifting item global ids).  Fresh nodes that still lack
    same-type neighbors route through the Group-2 KNN fallback when
    ``prev_emb`` (previous-run embeddings sized for the *new* space,
    [users; items]) is given.

    Affected rows match a from-scratch build on the merged window
    bit-for-bit — including when ``hub_cap`` triggers: hub-subsample
    draws are keyed per anchor and persisted in ``RefreshState`` (see
    ``refresh_graph``).  Unaffected rows are left untouched (modulo the
    id remap).  Returns ``(new_graph, new_tables, report)``; the report
    carries ``touched_users``, ``touched_items``, ``affected_nodes``,
    ``refresh_seconds`` and its split ``seconds`` (``refresh_graph``,
    ``ppr_refresh``, ``group2_fill``; host clock, each piece ends on the
    host).
    """
    if tables.ppr is None:
        raise ValueError("tables were built without keep_state=True; "
                         "no refresh state retained")
    t0 = time.perf_counter()
    g_new, report = refresh_graph(g, new_log_window)
    t1 = time.perf_counter()
    user_nbrs, item_nbrs, state, affected = \
        ppr_mod.refresh_ppr_neighbors(
            g_new, tables.user_nbrs, tables.item_nbrs, tables.ppr,
            backend=backend, device=device)
    t2 = time.perf_counter()
    if prev_emb is not None and len(affected):
        _fill_group2(g_new, user_nbrs, item_nbrs, prev_emb,
                     tables.ppr.k_imp, only=affected)
    t3 = time.perf_counter()
    report["affected_nodes"] = affected
    report["refresh_seconds"] = t3 - t0
    report["seconds"] = {"refresh_graph": t1 - t0, "ppr_refresh": t2 - t1,
                         "group2_fill": t3 - t2}
    return (g_new,
            NeighborTables(user_nbrs, item_nbrs, g_new.n_users,
                           g_new.n_items, ppr=state),
            report)


EDGE_KEYS = ("uu", "ui", "ii")

# batch formats (see sample_batch):
#   legacy    — per (edge_type, side) feature tensors, every endpoint
#               occurrence gathered (and encoded) again;
#   dedup     — a packed unique-node sub-batch per node type (features +
#               pack-relative sampled-neighbour indices) plus int32 gather
#               maps per (edge_type, side): each node is encoded once;
#   dedup_ids — the same packs, id-only: the train step gathers the
#               features from a FeatureStore.
BATCH_FORMATS = ("legacy", "dedup", "dedup_ids")

# edge type -> (src, dst) node-type names
_ET_SIDES = {"uu": ("user", "user"), "ui": ("user", "item"),
             "ii": ("item", "item")}


# pack sizes are bucketed to this multiple: the JAX package's default
# ``pad_multiple``, so the packs equal its batches row for row
PAD_MULTIPLE = 64


def _round_up(n: int) -> int:
    """n rounded up to a multiple of PAD_MULTIPLE (at least one)."""
    return max(PAD_MULTIPLE, -(-n // PAD_MULTIPLE) * PAD_MULTIPLE)


class EdgeDataset:
    """The JAX ``EdgeDataset``: features and neighbour tables on
    ``device``; ``g`` (the graph whose edges are sampled) is needed for
    training batches only.  Its batches are ``dedup_ids`` unless
    ``sample_batch`` is asked for another format."""

    def __init__(self, tables: NeighborTables, user_feat, item_feat, *,
                 k_train: int = 10, device=None,
                 g: Optional[HeteroGraph] = None):
        dev = resolve_device(device)
        self.device = dev
        self.g = g
        self.tables = tables
        self.k_train = int(k_train)
        self._cumw_cache: Dict[str, np.ndarray] = {}
        self.k_imp = int(tables.user_nbrs.shape[1])
        self.user_feat = torch.as_tensor(user_feat, dtype=torch.float32).to(dev)
        self.item_feat = torch.as_tensor(item_feat, dtype=torch.float32).to(dev)
        # ids < 2^31: int32 halves the tables' device memory
        self.user_nbrs = torch.as_tensor(
            np.asarray(tables.user_nbrs, np.int32)).to(dev)
        self.item_nbrs = torch.as_tensor(
            np.asarray(tables.item_nbrs, np.int32)).to(dev)

    def _gather_side(self, gids: np.ndarray, rng: np.random.Generator
                     ) -> Dict[str, torch.Tensor]:
        """Features + sampled neighbour features for global node ids
        (all of one node type)."""
        nu, ni = self.tables.n_users, self.tables.n_items
        dev = self.device
        g = torch.as_tensor(np.asarray(gids, np.int64)).to(dev)
        if (gids < nu).all():
            feat = self.user_feat[g]
        else:
            feat = self.item_feat[g - nu]
        k = self.k_train
        cols = torch.as_tensor(rng.integers(0, self.k_imp, (len(gids), k))
                               ).to(dev)
        unbr = self.user_nbrs[g[:, None], cols].long()
        cols = torch.as_tensor(rng.integers(0, self.k_imp, (len(gids), k))
                               ).to(dev)
        inbr = self.item_nbrs[g[:, None], cols].long()
        umask = unbr >= 0
        imask = inbr >= nu
        unbr_feat = self.user_feat[unbr.clamp(0, nu - 1)] * umask[..., None]
        inbr_feat = (self.item_feat[(inbr - nu).clamp(0, ni - 1)]
                     * imask[..., None])
        return dict(feat=feat, unbr_feat=unbr_feat,
                    unbr_mask=umask.to(torch.float32),
                    inbr_feat=inbr_feat,
                    inbr_mask=imask.to(torch.float32))

    def node_inference_batch(self, gids: np.ndarray, seed: int = 0
                             ) -> Dict[str, torch.Tensor]:
        """Inference-side gather for embedding generation."""
        return self._gather_side(np.asarray(gids),
                                 np.random.default_rng(seed))

    # ------------------------------------------------------------------
    # training batches
    # ------------------------------------------------------------------

    def _cumw(self, et: str) -> np.ndarray:
        if et not in self._cumw_cache:
            es = getattr(self.g, et)
            w = np.maximum(es.weight.astype(np.float64), 1e-9)
            self._cumw_cache[et] = np.cumsum(w) / w.sum()
        return self._cumw_cache[et]

    def _draw_edges(self, rng: np.random.Generator, et: str, n: int
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Draw n (src_gid, dst_gid, weight) samples of one edge type,
        each edge with probability proportional to its Eq. 1/2 weight
        (weight == relevance)."""
        nu = self.tables.n_users
        es = getattr(self.g, et)
        if len(es) == 0:   # degenerate graphs: self-pairs as fallback
            src = rng.integers(0, nu, n)
            dst = src.copy()
            w = np.ones(n, np.float32)
        else:
            idx = np.minimum(np.searchsorted(self._cumw(et), rng.random(n)),
                             len(es) - 1)
            src, dst, w = es.src[idx], es.dst[idx], es.weight[idx]
        if et == "uu":
            sg, dg = src, dst
        elif et == "ui":
            sg, dg = src, dst + nu
        else:  # ii
            sg, dg = src + nu, dst + nu
        return sg, dg, w.astype(np.float32)

    def _put(self, tree):
        """Every numpy array of a (nested) batch as a tensor on the
        dataset's device; tensors stay as they are."""
        return {k: self._put(v) if isinstance(v, dict)
                else v if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in tree.items()}

    def sample_batch(self, step: int, seed: int, per_type: Dict[str, int],
                     format: str = "dedup_ids") -> Dict[str, Dict]:
        """Batch ``step`` of run ``seed``: the JAX ``sample_batch(step,
        seed, per_type, format=)`` made with numpy, then every array as a
        tensor on the dataset's device (ids and maps int32, masks, weights
        and features float32).  ``format`` is one of ``BATCH_FORMATS``.
        ``legacy``
        keeps the reference's rng order (per edge type the edge draw, then
        the source and the destination side's neighbour draws):
        ``{et: {"src", "dst": side, "weight", "src_ids", "dst_ids"}}``, a
        side as ``node_inference_batch``'s.  ``dedup`` and ``dedup_ids``:
        ``{"nodes": {"user", "item": pack}, "edges": {et: maps}}``, a
        ``dedup`` pack with its rows' features (``feat``), a ``dedup_ids``
        pack with their ids."""
        if format not in BATCH_FORMATS:
            raise ValueError(f"unknown batch format {format!r}")
        if self.g is None:
            raise ValueError("training batches need the graph: "
                             "EdgeDataset(..., g=graph)")
        rng = np.random.default_rng((seed, step))
        if format == "legacy":
            batch: Dict[str, Dict] = {}
            for et in EDGE_KEYS:
                n = per_type.get(et, 0)
                if n == 0:
                    continue
                sg, dg, w = self._draw_edges(rng, et, n)
                batch[et] = dict(src=self._gather_side(sg, rng),
                                 dst=self._gather_side(dg, rng),
                                 weight=w, src_ids=sg.astype(np.int32),
                                 dst_ids=dg.astype(np.int32))
            return self._put(batch)
        edges = {et: self._draw_edges(rng, et, n) for et in EDGE_KEYS
                 if (n := per_type.get(et, 0))}
        return self._put(self._dedup_batch(rng, edges,
                                           id_only=format == "dedup_ids"))

    def expand_batch(self, batch: Dict[str, Dict]) -> Dict[str, Dict]:
        """A dedup (or ``dedup_ids``) batch in the legacy per-endpoint
        layout, on the same neighbour draws (the dedup forward on
        ``batch`` and the legacy forward on the expansion give the same
        losses); a legacy batch comes back as it is."""
        if "nodes" not in batch:
            return batch
        feats = {}
        for t, table in (("user", self.user_feat), ("item", self.item_feat)):
            side = batch["nodes"][t]
            feats[t] = side["feat"] if "feat" in side                 else table[side["ids"].long()]
        out: Dict[str, Dict] = {}
        for et, e in batch["edges"].items():
            st, dt = _ET_SIDES[et]
            sub = {}
            for side_name, t, m in (("src", st, e["src_map"]),
                                    ("dst", dt, e["dst_map"])):
                nd = batch["nodes"][t]
                m = m.long()
                umask, imask = nd["unbr_mask"][m], nd["inbr_mask"][m]
                sub[side_name] = dict(
                    feat=feats[t][m],
                    unbr_feat=feats["user"][nd["unbr_idx"].long()[m]]
                    * umask[..., None],
                    unbr_mask=umask,
                    inbr_feat=feats["item"][nd["inbr_idx"].long()[m]]
                    * imask[..., None],
                    inbr_mask=imask)
            out[et] = dict(weight=e["weight"], src_ids=e["src_ids"],
                           dst_ids=e["dst_ids"], **sub)
        return out

    def iter_batches(self, seed: int, per_type: Dict[str, int],
                     start_step: int = 0) -> Iterator[Dict]:
        """``sample_batch(step, seed, per_type)`` (``dedup_ids``) for step
        ``start_step``, ``start_step + 1``, ... without end."""
        step = start_step
        while True:
            yield self.sample_batch(step, seed, per_type)
            step += 1

    def _dedup_batch(self, rng: np.random.Generator, edges: Dict[str, Tuple],
                     id_only: bool = True) -> Dict[str, Dict]:
        """Packed unique-node batch: every node referenced by any
        endpoint or sampled neighbour appears exactly once per node type.

        Pack layout per type: ``[endpoint uniques (E, sorted) | pad to
        E_pad | neighbour-only extras (sorted) | pad to U_pad]``, sizes
        bucketed to ``PAD_MULTIPLE``.  Endpoint rows [0, E) are the only
        ones aggregated; extras exist only to be feature-encoded and
        gathered as neighbours.  ``ids`` are type-local feature rows
        (``id_only``), else ``feat`` their features, gathered on the
        device.
        """
        nu, ni = self.tables.n_users, self.tables.n_items
        k_imp = self.tables.user_nbrs.shape[1]
        k = self.k_train

        ep = {"user": [], "item": []}
        for et, (sg, dg, w) in edges.items():
            st, dt = _ET_SIDES[et]
            ep[st].append(sg)
            ep[dt].append(dg)

        uniq: Dict[str, np.ndarray] = {}
        nbr_gids: Dict[str, Dict[str, np.ndarray]] = {}
        for t in ("user", "item"):
            u = (np.unique(np.concatenate(ep[t])) if ep[t]
                 else np.zeros(0, np.int64))
            uniq[t] = u
            # one neighbour draw per unique endpoint node
            cols = rng.integers(0, k_imp, (len(u), k))
            unbr = self.tables.user_nbrs[u[:, None], cols] if len(u) else \
                np.zeros((0, k), np.int64)
            cols = rng.integers(0, k_imp, (len(u), k))
            inbr = self.tables.item_nbrs[u[:, None], cols] if len(u) else \
                np.zeros((0, k), np.int64)
            nbr_gids[t] = dict(
                unbr=np.clip(unbr, 0, nu - 1), umask=unbr >= 0,
                inbr=np.clip(inbr, nu, nu + ni - 1), imask=inbr >= nu)

        # neighbour-only extras per pack (valid neighbours not already
        # endpoint uniques of that type)
        extras, e_pad = {}, {}
        for t, key_m in (("user", "umask"), ("item", "imask")):
            key_g = "unbr" if t == "user" else "inbr"
            valid = [nbr_gids[s][key_g][nbr_gids[s][key_m]]
                     for s in ("user", "item")]
            allv = np.unique(np.concatenate(valid))
            extras[t] = np.setdiff1d(allv, uniq[t], assume_unique=True)
            e_pad[t] = _round_up(len(uniq[t]))

        def pack_index(t: str, gids: np.ndarray, mask: np.ndarray
                       ) -> np.ndarray:
            """Pack-relative index of global ids (masked entries -> 0)."""
            u, ex = uniq[t], extras[t]
            if len(u) == 0:   # a type with no endpoints: extras only
                idx = e_pad[t] + np.searchsorted(ex, gids)
            else:
                pos = np.minimum(np.searchsorted(u, gids), len(u) - 1)
                idx = np.where(u[pos] == gids, pos,
                               e_pad[t] + np.searchsorted(ex, gids))
            return np.where(mask, idx, 0).astype(np.int32)

        sides: Dict[str, Dict[str, np.ndarray]] = {}
        for t in ("user", "item"):
            E, Ep = len(uniq[t]), e_pad[t]
            u_pad = _round_up(Ep + len(extras[t]))
            local = np.zeros(u_pad, np.int64)
            off, hi = (0, nu - 1) if t == "user" else (nu, ni - 1)
            local[:E] = np.clip(uniq[t] - off, 0, hi)
            local[Ep:Ep + len(extras[t])] = np.clip(extras[t] - off, 0, hi)
            n = nbr_gids[t]
            unbr_idx = np.zeros((Ep, k), np.int32)
            inbr_idx = np.zeros((Ep, k), np.int32)
            umask = np.zeros((Ep, k), np.float32)
            imask = np.zeros((Ep, k), np.float32)
            unbr_idx[:E] = pack_index("user", n["unbr"], n["umask"])
            inbr_idx[:E] = pack_index("item", n["inbr"], n["imask"])
            umask[:E] = n["umask"].astype(np.float32)
            imask[:E] = n["imask"].astype(np.float32)
            sides[t] = dict(unbr_idx=unbr_idx, unbr_mask=umask,
                            inbr_idx=inbr_idx, inbr_mask=imask)
            if id_only:
                sides[t]["ids"] = local.astype(np.int32)
            else:
                table = self.user_feat if t == "user" else self.item_feat
                sides[t]["feat"] = table[torch.from_numpy(local).to(
                    self.device)]

        out_edges = {}
        for et, (sg, dg, w) in edges.items():
            st, dt = _ET_SIDES[et]
            out_edges[et] = dict(
                src_map=np.searchsorted(uniq[st], sg).astype(np.int32),
                dst_map=np.searchsorted(uniq[dt], dg).astype(np.int32),
                weight=w,
                src_ids=sg.astype(np.int32), dst_ids=dg.astype(np.int32))
        return {"nodes": sides, "edges": out_edges}


class Prefetcher:
    """Host-side pipeline overlap: the batches of ``it`` are made in a
    background thread (at most ``depth`` ahead) while the device runs the
    step; ``close`` stops it after the batch in hand."""

    def __init__(self, it: Iterator, depth: int = 2):
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def work():
            for item in it:
                if self._stop.is_set():
                    return
                self.q.put(item)

        self.t = threading.Thread(target=work, daemon=True)
        self.t.start()

    def __iter__(self):
        return self

    def __next__(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
