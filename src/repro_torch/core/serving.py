"""KNN-free serving (paper §4.4), as ``repro/core/serving.py``.

U2U2I: each user carries a flat cluster id from the co-learned RQ
index; each cluster keeps a recency-filtered ring of items engaged by
its recently active members.  Serving reads the target user's cluster
ring (a lookup) instead of running online KNN over the active pool.
U2I2I: the I2I KNN table is computed offline; serving unions the
similar-item lists of the user's recent items.

``ClusterQueueStore`` keeps its rings as tensors on one device, in
direct mode (every ingest batch is scattered straight into the ring;
the JAX package's ``delta_cap`` mode and its ``ShardedQueueStore`` are
``ROADMAP.md`` queue 1 item 5, and asking for them raises).
``serve_batch`` with an I2I table answers the whole request batch with
the fused ``queue_gather`` op: the CUDA kernel on a card, its plain
version on the CPU.  The store reports the JAX store's ``serving.*``
counters, gauges and latency histogram to its telemetry.

Design notes (as in the JAX package):

* **MVCC.**  ``_state`` is a dict of tensors that are never written
  after they are published.  ``ingest`` builds new ring tensors (copy,
  then ``index_put_``) and rebinds ``_state`` under ``write_lock``; a
  reader takes one reference and works on that consistent snapshot.
* **Dedup at ingest.**  The ring is kept duplicate-free per
  ``(cluster, item)``: ingest tombstones the prior ring occurrence of
  each incoming item, so retrieve needs no dedup.  Cursor arithmetic
  still advances for every event, so slot ages match the JAX store
  bit for bit.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device
from repro_torch.obs import get_telemetry
from repro_torch.kernels.queue_gather.ops import queue_gather
from repro_torch.kernels.queue_gather.ref import (ring_window, select_first,
                                                  union_topk)


def _candidate_window(st: Dict[str, torch.Tensor], cl: torch.Tensor,
                      cutoff: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Newest-first candidate window + validity mask for one row per
    cluster id; ``cl < 0`` rows are fully invalid."""
    return ring_window(st["items"], st["times"], st["total"], cl, cutoff)


# first ``k`` valid candidates per row, ``-1`` padded
_select_topk = select_first
# rank-major round-robin U2I2I union, seeds and duplicates masked
_union_topk = union_topk


class ClusterQueueStore:
    """Real-time per-cluster item rings with recency filtering, resident
    on ``device``.

    Layout: ``_state`` holds dense ``(n_clusters, queue_len)``
    item (int32) / time (float32, relative to the first ingested event)
    rings plus a per-cluster write counter ``total`` (int32; write
    position = ``total % queue_len``).  ``_cursor_host`` mirrors
    ``total`` on the host, so ingest prep never waits for the device.
    Writers rebind ``_state`` under ``write_lock`` (an RLock: the swap
    server's ring drain wraps ``ingest`` in the same lock); readers take
    no lock.  ``ring_seen`` is the swap server's ``EventRing`` watermark.
    ``delta_cap`` must be 0 (direct mode).
    """

    def __init__(self, user_clusters: np.ndarray, *, queue_len: int = 256,
                 recency_s: float = 900.0,
                 n_clusters: Optional[int] = None, telemetry=None,
                 delta_cap: int = 0, device=None):
        if delta_cap:
            raise NotImplementedError(
                "delta_cap > 0 (the delta-run ingest) is not ported yet: "
                "ROADMAP.md queue 1 item 5")
        self.tel = telemetry if telemetry is not None else get_telemetry()
        self.device = resolve_device(device)
        self.user_clusters = np.asarray(user_clusters, np.int64)
        self.queue_len = int(queue_len)
        self.recency_s = float(recency_s)
        if n_clusters is None:
            n_clusters = max(int(self.user_clusters.max()) + 1, 1) \
                if self.user_clusters.size else 1
        self.n_clusters = max(int(n_clusters), 1)
        C, Q, dev = self.n_clusters, self.queue_len, self.device
        self._state = dict(
            items=torch.full((C, Q), -1, dtype=torch.int32, device=dev),
            # float32 relative to the first-seen event (absolute epoch
            # seconds lose ~100 s of precision in f32)
            times=torch.full((C, Q), -np.inf, dtype=torch.float32,
                             device=dev),
            total=torch.zeros((C,), dtype=torch.int32, device=dev))
        self._cursor_host = np.zeros(C, np.int64)
        self.epoch: Optional[float] = None
        self.write_lock = threading.RLock()
        self.ring_seen = 0     # EventRing watermark (maintained by swap)
        self._i2i_cache: Optional[Tuple[int, torch.Tensor]] = None

    # -- cluster assignment lookup ------------------------------------------

    def clusters_of(self, user_ids: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Cluster ids for a batch of users plus a known-user mask.

        Users outside the assignment table (minted after the snapshot
        this store serves) and users whose entry is negative map to
        cluster 0 with ``known=False``; callers mask their rows out."""
        user_ids = np.asarray(user_ids, np.int64).ravel()
        known = (user_ids >= 0) & (user_ids < self.user_clusters.shape[0])
        cl = self.user_clusters[np.where(known, user_ids, 0)]
        known = known & (cl >= 0)
        return np.where(known, cl, 0), known

    # -- ingestion ----------------------------------------------------------

    def ingest(self, user_ids: np.ndarray, item_ids: np.ndarray,
               timestamps: np.ndarray) -> None:
        """Stream a batch of engagement events into their users' cluster
        rings, oldest to newest, so ring order is time order within the
        batch.  Events of users unknown to this snapshot's assignment
        table are dropped.  Readers keep the previous ``_state`` until
        the rebind lands."""
        user_ids = np.asarray(user_ids, np.int64).ravel()
        item_ids = np.asarray(item_ids, np.int64).ravel()
        ts64 = np.asarray(timestamps, np.float64).ravel()
        cl_all, known = self.clusters_of(user_ids)
        if not known.all():
            # post-snapshot users are shed, not errored, and counted
            if self.tel.enabled:
                self.tel.counter("serving.unknown_user_events",
                                 float((~known).sum()))
            cl_all, item_ids, ts64 = cl_all[known], item_ids[known], \
                ts64[known]
        if cl_all.size == 0:
            return
        with self.write_lock:
            if self.epoch is None:
                self.epoch = float(ts64.min())
            rel = (ts64 - self.epoch).astype(np.float32)
            order = np.argsort(rel, kind="stable")
            cl = cl_all.astype(np.int32)[order]
            self._direct_ingest(cl, item_ids.astype(np.int32)[order],
                                rel[order])
        tel = self.tel
        if tel.enabled:
            tel.counter("serving.ingest_events", float(cl.size))
            fill = np.minimum(self._cursor_host[np.unique(cl)],
                              self.queue_len)
            tel.gauge("serving.queue_depth_max", float(fill.max()))
            tel.gauge("serving.queue_depth_mean", float(fill.mean()))

    def _direct_ingest(self, cl: np.ndarray, it: np.ndarray,
                       rel: np.ndarray) -> None:
        """Host-side batch prep (slot assignment, in-batch last-writer-
        wins), then new ring tensors: tombstone prior ring occurrences
        of incoming items, scatter the surviving writes, advance the
        cursors.  Reentrant under ``ingest``'s lock."""
        with self.write_lock:
            E = cl.size
            Q, dev = self.queue_len, self.device
            # per-event sequence index within its cluster: a stable sort
            # by cluster keeps time order inside each group
            o = np.argsort(cl, kind="stable")
            sc = cl[o]
            start = np.zeros(E, np.int64)
            if E > 1:
                idx = np.arange(1, E)
                start[1:] = np.where(sc[1:] == sc[:-1], 0, idx)
                np.maximum.accumulate(start, out=start)
            rank = np.arange(E) - start
            seq = np.empty(E, np.int64)
            seq[o] = self._cursor_host[sc] + rank
            slot = (seq % Q).astype(np.int64)
            # slot LWW (in-batch ring wrap): last event per (cl, slot)
            skey = cl.astype(np.int64) * Q + slot
            _, li = np.unique(skey[::-1], return_index=True)
            keep = np.zeros(E, bool)
            keep[E - 1 - li] = True
            # in-batch item LWW: an earlier duplicate of (cl, item) becomes
            # a tombstone so the ring stays duplicate-free
            ikey = cl.astype(np.int64) << 32 | it.astype(np.int64)
            _, li2 = np.unique(ikey[::-1], return_index=True)
            w_item = np.full(E, -1, np.int32)
            last = E - 1 - li2
            w_item[last] = it[last]
            ucl, cnt = np.unique(cl, return_counts=True)

            def dev_t(a):
                return torch.as_tensor(a).to(dev)

            st = self._state
            t_cl = dev_t(cl.astype(np.int64))
            raw = dev_t(it)
            m = (st["items"][t_cl] == raw[:, None]) & (raw >= 0)[:, None]
            has = m.any(dim=1)
            q_hit = torch.argmax(m.to(torch.int32), dim=1)  # first hit
            items = st["items"].clone()
            items[t_cl[has], q_hit[has]] = -1
            w_cl, w_slot = dev_t(cl[keep].astype(np.int64)), dev_t(slot[keep])
            items[w_cl, w_slot] = dev_t(w_item[keep])
            times = st["times"].clone()
            times[w_cl, w_slot] = dev_t(rel[keep])
            total = st["total"].clone()
            total[dev_t(ucl.astype(np.int64))] += dev_t(cnt.astype(np.int32))
            self._state = dict(items=items, times=times, total=total)
            self._cursor_host[ucl] += cnt

    # -- retrieval ----------------------------------------------------------

    def rel_cutoff(self, now: float) -> float:
        """Recency cutoff in the store's internal (epoch-relative) time."""
        return now - self.recency_s - (self.epoch or 0.0)

    def _unique_clusters(self, user_ids: np.ndarray
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Dedup a request batch down to its unique cluster rows (most of
        a batch shares clusters; rows broadcast back through the
        inverse).  Unknown users get cluster -1, an invalid row.  The
        counterpart of the JAX ``_padded_clusters``, without the padding
        that only kept jit traces stable."""
        cl, known = self.clusters_of(user_ids)
        cl = np.where(known, cl, -1)
        ucl, inv = np.unique(cl, return_inverse=True)
        return ucl, inv, known

    def _observe(self, t0: float, known: np.ndarray) -> None:
        """One request batch's telemetry: latency, count, unknown users."""
        tel = self.tel
        tel.observe("serving.retrieve_latency_s", tel.clock.perf() - t0)
        tel.counter("serving.retrieve_requests")
        if not known.all():
            tel.counter("serving.unknown_user_requests",
                        float((~known).sum()))

    def retrieve_batch(self, user_ids: np.ndarray, now: float,
                       k: int) -> np.ndarray:
        """Batched U2U2I: ``(B,)`` user ids -> ``(B, k)`` item ids,
        newest-first, recency-filtered, ``-1``-padded."""
        t0 = self.tel.clock.perf() if self.tel.enabled else 0.0
        ucl, inv, known = self._unique_clusters(user_ids)
        st = self._state                 # one snapshot read
        cand, valid = _candidate_window(
            st, torch.as_tensor(ucl).to(self.device), self.rel_cutoff(now))
        out = _select_topk(cand, valid, int(k))
        res = out.cpu().numpy()[inv].astype(np.int64)
        if self.tel.enabled:
            self._observe(t0, known)
        return res

    def retrieve(self, user_id: int, now: float, k: int) -> List[int]:
        """Single-request U2U2I — a batch of one."""
        row = self.retrieve_batch(np.array([user_id]), now, k)[0]
        return [int(i) for i in row if i >= 0]

    def _i2i_device(self, i2i) -> torch.Tensor:
        """Device int32 copy of the I2I table, cached by identity (it is
        rebuilt only at embedding refresh: one transfer per swap)."""
        cached = self._i2i_cache
        if cached is not None and cached[0] == id(i2i):
            return cached[1]
        dev = torch.as_tensor(i2i).to(self.device, torch.int32)
        self._i2i_cache = (id(i2i), dev)
        return dev

    @property
    def items(self) -> np.ndarray:
        return self._state["items"].cpu().numpy()

    @property
    def times(self) -> np.ndarray:
        return self._state["times"].cpu().numpy()

    @property
    def cursor(self) -> np.ndarray:
        return self._cursor_host

    def serve_batch(self, user_ids: np.ndarray, now: float, *,
                    n_recent: int = 8, k: int = 32, i2i=None
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Full serving pass: U2U2I seeds ``(B, n_recent)`` plus, when an
        ``i2i`` table is given, the U2I2I round-robin union ``(B, k)``,
        both int64 and ``-1``-padded.  With a table the whole batch is
        one ``queue_gather`` call on the ring snapshot (the CUDA kernel
        on a card); unknown users get empty rows."""
        if i2i is None:
            seeds = self.retrieve_batch(user_ids, now, n_recent)
            return seeds, np.full((seeds.shape[0], k), -1, np.int64)
        t0 = self.tel.clock.perf() if self.tel.enabled else 0.0
        cl, known = self.clusters_of(user_ids)
        st = self._state
        s, u = queue_gather(
            st["items"], st["times"], st["total"],
            torch.as_tensor(np.where(known, cl, -1).astype(np.int32)
                            ).to(self.device),
            self._i2i_device(i2i), cutoff=self.rel_cutoff(now),
            n_recent=int(n_recent), k=int(k))
        seeds = s.cpu().numpy().astype(np.int64)
        union = u.cpu().numpy().astype(np.int64)
        if self.tel.enabled:
            self._observe(t0, known)
        return seeds, union

    # -- introspection ------------------------------------------------------

    def partitions(self) -> Tuple["ClusterQueueStore", ...]:
        """Uniform shard view: an unsharded store is its own single
        partition."""
        return (self,)

    def stats(self) -> Dict[str, float]:
        fill = np.minimum(self._cursor_host, self.queue_len)
        active = fill > 0
        return dict(n_shards=1,
                    n_clusters_active=int(active.sum()),
                    mean_queue=float(fill[active].mean())
                    if active.any() else 0.0,
                    delta_pending=0.0)


# ---------------------------------------------------------------------------
# offline I2I KNN (U2I2I)
# ---------------------------------------------------------------------------

@torch.inference_mode()
def build_i2i_knn(item_emb: torch.Tensor, k: int, *, chunk: int = 2048,
                  exclude_self: bool = True) -> torch.Tensor:
    """(n_items, k) int64 most-similar items by cosine, on
    ``item_emb``'s device, ``-1``-padded when fewer than k neighbours
    exist.  Embeddings are normalised by ``max(||x||, 1e-8)`` in f32 as
    in the JAX package.

    Ties: ``jax.lax.top_k`` puts the lower index first; ``torch.topk``
    promises no order among equal scores, so the two tables agree only
    where no two candidates of a row score the same."""
    e = item_emb.to(torch.float32)
    e = e / torch.clamp_min(torch.linalg.vector_norm(e, dim=1, keepdim=True),
                            1e-8)
    n = e.shape[0]
    kk = min(k, n - 1)
    if kk <= 0:      # 0- or 1-item corpus: no neighbours exist at all
        return torch.full((n, k), -1, dtype=torch.int64, device=e.device)
    out = torch.empty((n, k), dtype=torch.int64, device=e.device)
    out[:, kk:] = -1
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        sims = e[lo:hi] @ e.T                                # (c, n)
        if exclude_self:
            r = torch.arange(hi - lo, device=e.device)
            sims[r, lo + r] = -torch.inf
        out[lo:hi, :kk] = torch.topk(sims, kk, dim=1).indices
    return out


def u2i2i_retrieve_batch(i2i: torch.Tensor, recent_items: torch.Tensor,
                         k: int) -> torch.Tensor:
    """Batched U2I2I: union the similar-item lists of each row's recent
    items ``(B, R)`` (``-1`` = padding), round-robin across ranks, mask
    the seeds themselves, dedup; ``(B, k)`` ``-1``-padded.  Seeds past
    the table end contribute no neighbours but are still masked."""
    return _union_topk(recent_items.to(torch.int64), i2i.to(torch.int64),
                       int(k))
