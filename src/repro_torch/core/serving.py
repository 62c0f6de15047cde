"""KNN-free serving (paper §4.4), as ``repro/core/serving.py``.

U2U2I: each user carries a flat cluster id from the co-learned RQ
index; each cluster keeps a recency-filtered ring of items engaged by
its recently active members.  Serving reads the target user's cluster
ring (a lookup) instead of running online KNN over the active pool.
U2I2I: the I2I KNN table is computed offline; serving unions the
similar-item lists of the user's recent items.

``ClusterQueueStore`` keeps its rings as tensors on one device.
``serve_batch`` with an I2I table answers the whole request batch with
the fused ``queue_gather`` op: the CUDA kernel on a card, its plain
version on the CPU.  The store reports the JAX store's ``serving.*``
counters, gauges and latency histogram to its telemetry, tagged with
``shard_tag`` (``.shard{i}`` inside a sharded store).  The host engine
(``HostQueueStore``, in ``repro_torch.core.serving_host``) is the
bitwise oracle and the scale-out baseline; it is re-exported here.

Design notes (as in the JAX package):

* **MVCC.**  ``_state`` is a dict of tensors that are never written
  after they are published.  ``ingest`` builds new tensors for the keys
  it writes (copy, then ``index_put_``) and rebinds ``_state`` under
  ``write_lock``; a reader takes one reference and works on that
  consistent snapshot.
* **Dedup at ingest.**  The ring is kept duplicate-free per
  ``(cluster, item)``: ingest tombstones the prior ring occurrence of
  each incoming item, so retrieve needs no dedup.  Cursor arithmetic
  still advances for every event, so slot ages match the JAX store
  bit for bit.
* **Two write modes.** ``delta_cap=0`` (default) scatters every ingest
  batch straight into the ring.  ``delta_cap=D`` appends to a delta run
  of at most D events and folds it into the ring only when full (an
  LSM level of exactly one run); ``retrieve_batch`` scans
  delta-then-ring.  The append keeps the reference's ``(E, D)`` match
  matrix and the fold its ``(D, D)`` later-matrix: small at the
  reference's D of 512.  ``serve_batch`` with an I2I table folds first
  (the ``queue_gather`` kernel reads only the ring), as the JAX kernel
  path does.

``ShardedQueueStore`` partitions the cluster space into N contiguous
ranges behind the same API: ingest is sorted once by time and split by
shard, retrieve routes each request to its owning shard and merges.
``devices=`` (in place of the JAX package's ``mesh=``) places the
shards round-robin over the listed devices; several shards may share
one device.

``ServingCostModel`` quantifies the paper's 83% claim: bytes and FLOPs
per request for online KNN against cluster-lookup serving.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.serving_host import (  # noqa: F401  (re-exports)
    BufPool,
    HostQueueStore,
    ThreadLocalPools,
    dedup_topk_rows,
)
from repro_torch.kernels.common import resolve_device
from repro_torch.obs import get_telemetry
from repro_torch.kernels.queue_gather.ops import queue_gather
from repro_torch.kernels.queue_gather.ref import (ring_window, select_first,
                                                  union_topk)


def _candidate_window(st: Dict[str, torch.Tensor], cl: torch.Tensor,
                      cutoff: float, delta_cap: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Newest-first candidate window + validity mask for one row per
    cluster id; ``cl < 0`` rows are fully invalid.  With ``delta_cap``
    the delta run (newest first) is put before the ring window, so the
    window's order is arrival order; ring slots shadowed by a pending
    delta event, or evicted by the pending events, are invalid."""
    if not delta_cap:
        return ring_window(st["items"], st["times"], st["total"], cl, cutoff)
    Q = st["items"].shape[1]
    B, dev = cl.shape[0], cl.device
    known = cl >= 0
    cl0 = torch.where(known, cl, torch.zeros_like(cl)).long()
    total = st["total"][cl0].long()
    rtot = st["ring_total"][cl0].long()
    a = torch.arange(Q, device=dev)[None, :]
    slot = torch.remainder(rtot[:, None] - 1 - a, Q)
    r_item = st["items"][cl0[:, None], slot]
    r_ts = st["times"][cl0[:, None], slot]
    cut = torch.tensor(float(cutoff), dtype=torch.float32, device=dev)
    r_age = a + (total - rtot)[:, None]        # age incl. pending deltas
    r_valid = ((a < rtot.clamp(max=Q)[:, None]) & (r_item >= 0)
               & (r_ts >= cut) & known[:, None]
               & ~st["shadow"][cl0[:, None], slot] & (r_age < Q))
    d_cl = st["d_cl"].flip(0)[None, :]
    d_item = st["d_item"].flip(0)[None, :].expand(B, -1)
    d_ts = st["d_ts"].flip(0)[None, :]
    d_idx = st["d_idx"].flip(0)[None, :].long()
    d_sh = st["d_shadow"].flip(0)[None, :]
    mine = (d_cl == cl0[:, None]) & known[:, None]
    d_age = total[:, None] - 1 - d_idx
    d_valid = (mine & ~d_sh & (d_item >= 0) & (d_ts >= cut)
               & (d_age >= 0) & (d_age < Q))
    return (torch.cat([d_item, r_item], dim=1),
            torch.cat([d_valid, r_valid], dim=1))


# first ``k`` valid candidates per row, ``-1`` padded
_select_topk = select_first
# rank-major round-robin U2I2I union, seeds and duplicates masked
_union_topk = union_topk


def _cluster_ranks(cl: np.ndarray) -> np.ndarray:
    """Each event's rank among the batch's events of its cluster, in
    batch order (a stable sort by cluster keeps time order inside each
    group)."""
    E = cl.size
    o = np.argsort(cl, kind="stable")
    sc = cl[o]
    start = np.zeros(E, np.int64)
    if E > 1:
        idx = np.arange(1, E)
        start[1:] = np.where(sc[1:] == sc[:-1], 0, idx)
        np.maximum.accumulate(start, out=start)
    rank = np.empty(E, np.int64)
    rank[o] = np.arange(E) - start
    return rank


def _last_of_key(key: np.ndarray) -> np.ndarray:
    """Indices of the last occurrence of each distinct key."""
    _, li = np.unique(key[::-1], return_index=True)
    return key.size - 1 - li


class ClusterQueueStore:
    """Real-time per-cluster item rings with recency filtering, resident
    on ``device``.

    Layout: ``_state`` holds dense ``(n_clusters, queue_len)``
    item (int32) / time (float32, relative to the first ingested event)
    rings plus a per-cluster write counter ``total`` (int32; write
    position = ``total % queue_len``); ``delta_cap > 0`` adds a ring
    shadow bitmap, the ring's own write counter ``ring_total`` and a flat
    delta run (``d_cl``, ``d_item``, ``d_ts``, ``d_idx``, ``d_shadow``)
    that folds into the ring when full (``folds`` counts the folds of a
    non-empty run).  ``_cursor_host`` mirrors
    ``total`` on the host, so ingest prep never waits for the device.
    Writers rebind ``_state`` under ``write_lock`` (an RLock: the swap
    server's ring drain wraps ``ingest`` in the same lock); readers take
    no lock.  ``ring_seen`` is the swap server's ``EventRing`` watermark.
    """

    def __init__(self, user_clusters: np.ndarray, *, queue_len: int = 256,
                 recency_s: float = 900.0,
                 n_clusters: Optional[int] = None, telemetry=None,
                 delta_cap: int = 0, shard_tag: str = "", device=None):
        self.tel = telemetry if telemetry is not None else get_telemetry()
        self.device = resolve_device(device)
        self.user_clusters = np.asarray(user_clusters, np.int64)
        self.queue_len = int(queue_len)
        self.recency_s = float(recency_s)
        if n_clusters is None:
            n_clusters = max(int(self.user_clusters.max()) + 1, 1) \
                if self.user_clusters.size else 1
        self.n_clusters = max(int(n_clusters), 1)
        self.delta_cap = int(delta_cap)
        C, Q, D, dev = self.n_clusters, self.queue_len, self.delta_cap, \
            self.device
        state = dict(
            items=torch.full((C, Q), -1, dtype=torch.int32, device=dev),
            # float32 relative to the first-seen event (absolute epoch
            # seconds lose ~100 s of precision in f32)
            times=torch.full((C, Q), -np.inf, dtype=torch.float32,
                             device=dev),
            total=torch.zeros((C,), dtype=torch.int32, device=dev))
        if D > 0:
            state.update(
                shadow=torch.zeros((C, Q), dtype=torch.bool, device=dev),
                ring_total=torch.zeros((C,), dtype=torch.int32, device=dev),
                **self._empty_delta())
        self._state = state
        self._cursor_host = np.zeros(C, np.int64)
        self.d_count = 0               # filled delta slots (writer-only)
        self.folds = 0                 # folds of a non-empty delta run
        self.epoch: Optional[float] = None
        self.write_lock = threading.RLock()
        self.ring_seen = 0     # EventRing watermark (maintained by swap)
        self.shard_tag = shard_tag
        self._m_ingest = "serving.ingest_events" + shard_tag
        self._m_requests = "serving.retrieve_requests" + shard_tag
        self._m_latency = "serving.retrieve_latency_s" + shard_tag
        self._m_depth_max = "serving.queue_depth_max" + shard_tag
        self._m_depth_mean = "serving.queue_depth_mean" + shard_tag
        self._m_unknown_ev = "serving.unknown_user_events" + shard_tag
        self._m_unknown_rq = "serving.unknown_user_requests" + shard_tag
        self._i2i_cache: Optional[Tuple[int, torch.Tensor]] = None

    def _empty_delta(self) -> Dict[str, torch.Tensor]:
        D, C, dev = self.delta_cap, self.n_clusters, self.device
        return dict(
            d_cl=torch.full((D,), C, dtype=torch.int32, device=dev),
            d_item=torch.full((D,), -1, dtype=torch.int32, device=dev),
            d_ts=torch.full((D,), -np.inf, dtype=torch.float32, device=dev),
            d_idx=torch.zeros((D,), dtype=torch.int32, device=dev),
            d_shadow=torch.zeros((D,), dtype=torch.bool, device=dev))

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device)

    # -- cluster assignment lookup ------------------------------------------

    def clusters_of(self, user_ids: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Cluster ids for a batch of users plus a known-user mask.

        Users outside the assignment table (minted after the snapshot
        this store serves) and users whose entry is negative (clusters
        owned by another shard) map to cluster 0 with ``known=False``;
        callers mask their rows out."""
        user_ids = np.asarray(user_ids, np.int64).ravel()
        known = (user_ids >= 0) & (user_ids < self.user_clusters.shape[0])
        cl = self.user_clusters[np.where(known, user_ids, 0)]
        known = known & (cl >= 0)
        return np.where(known, cl, 0), known

    # -- ingestion ----------------------------------------------------------

    def ingest(self, user_ids: np.ndarray, item_ids: np.ndarray,
               timestamps: np.ndarray, *, _presorted: bool = False) -> None:
        """Stream a batch of engagement events into their users' cluster
        rings, oldest to newest, so ring order is time order within the
        batch.  Events of users unknown to this snapshot's assignment
        table are dropped.  Readers keep the previous ``_state`` until
        the rebind lands.  ``_presorted``: the batch is already in the
        stable order of its f32 relative times (the sharded router sorts
        once for all shards)."""
        user_ids = np.asarray(user_ids, np.int64).ravel()
        item_ids = np.asarray(item_ids, np.int64).ravel()
        ts64 = np.asarray(timestamps, np.float64).ravel()
        cl_all, known = self.clusters_of(user_ids)
        if not known.all():
            # post-snapshot users are shed, not errored, and counted
            if self.tel.enabled:
                self.tel.counter(self._m_unknown_ev, float((~known).sum()))
            cl_all, item_ids, ts64 = cl_all[known], item_ids[known], \
                ts64[known]
        if cl_all.size == 0:
            return
        with self.write_lock:
            if self.epoch is None:
                self.epoch = float(ts64.min())
            rel = (ts64 - self.epoch).astype(np.float32)
            cl = cl_all.astype(np.int32)
            it = item_ids.astype(np.int32)
            if not _presorted:
                order = np.argsort(rel, kind="stable")
                cl, it, rel = cl[order], it[order], rel[order]
            if self.delta_cap:
                n, done = cl.size, 0
                while done < n:
                    take = min(n - done, self.delta_cap - self.d_count)
                    if take == 0:
                        self._fold()
                        continue
                    self._append(cl[done:done + take],
                                 it[done:done + take],
                                 rel[done:done + take])
                    done += take
            else:
                self._direct_ingest(cl, it, rel)
        tel = self.tel
        if tel.enabled:
            tel.counter(self._m_ingest, float(cl.size))
            fill = np.minimum(self._cursor_host[np.unique(cl)],
                              self.queue_len)
            tel.gauge(self._m_depth_max, float(fill.max()))
            tel.gauge(self._m_depth_mean, float(fill.mean()))

    def _shadow_hits(self, t_cl: torch.Tensor, raw: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The first ring slot of each event's cluster that holds the
        event's item: (has a hit, its slot)."""
        m = (self._state["items"][t_cl] == raw[:, None]) & (raw >= 0)[:, None]
        return m.any(dim=1), torch.argmax(m.to(torch.int32), dim=1)

    def _direct_ingest(self, cl: np.ndarray, it: np.ndarray,
                       rel: np.ndarray) -> None:
        """Host-side batch prep (slot assignment, in-batch last-writer-
        wins), then new ring tensors: tombstone prior ring occurrences
        of incoming items, scatter the surviving writes, advance the
        cursors.  Reentrant under ``ingest``'s lock."""
        with self.write_lock:
            E = cl.size
            Q = self.queue_len
            seq = self._cursor_host[cl] + _cluster_ranks(cl)
            slot = (seq % Q).astype(np.int64)
            # slot LWW (in-batch ring wrap): last event per (cl, slot)
            keep = np.zeros(E, bool)
            keep[_last_of_key(cl.astype(np.int64) * Q + slot)] = True
            # in-batch item LWW: an earlier duplicate of (cl, item) becomes
            # a tombstone so the ring stays duplicate-free
            last = _last_of_key(cl.astype(np.int64) << 32
                                | it.astype(np.int64))
            w_item = np.full(E, -1, np.int32)
            w_item[last] = it[last]
            ucl, cnt = np.unique(cl, return_counts=True)

            st = self._state
            t_cl = self._dev(cl.astype(np.int64))
            has, q_hit = self._shadow_hits(t_cl, self._dev(it))
            items = st["items"].clone()
            items[t_cl[has], q_hit[has]] = -1
            w_cl = self._dev(cl[keep].astype(np.int64))
            w_slot = self._dev(slot[keep])
            items[w_cl, w_slot] = self._dev(w_item[keep])
            times = st["times"].clone()
            times[w_cl, w_slot] = self._dev(rel[keep])
            total = st["total"].clone()
            total[self._dev(ucl.astype(np.int64))] += \
                self._dev(cnt.astype(np.int32))
            self._state = dict(items=items, times=times, total=total)
            self._cursor_host[ucl] += cnt

    def _append(self, cl: np.ndarray, it: np.ndarray,
                rel: np.ndarray) -> None:
        """Delta mode: append ``E <= delta_cap - d_count`` events to the
        delta run, shadowing prior occurrences of their items in the ring
        (bitmap) and in the delta run (``d_shadow``).  Reentrant under
        ``ingest``'s lock."""
        with self.write_lock:
            E = cl.size
            d_idx = self._cursor_host[cl] + _cluster_ranks(cl)
            last = _last_of_key(cl.astype(np.int64) << 32
                                | it.astype(np.int64))
            w_item = np.full(E, -1, np.int32)
            w_item[last] = it[last]
            ucl, cnt = np.unique(cl, return_counts=True)

            st = self._state
            t_cl = self._dev(cl.astype(np.int64))
            raw = self._dev(it)
            has, q_hit = self._shadow_hits(t_cl, raw)
            shadow = st["shadow"].clone()
            shadow[t_cl[has], q_hit[has]] = True
            # (E, D) matches against the pending run: an earlier delta
            # copy of an incoming (cluster, item) is shadowed
            dm = ((st["d_cl"][None, :] == t_cl[:, None])
                  & (st["d_item"][None, :] == raw[:, None])
                  & (raw >= 0)[:, None])
            d_shadow = st["d_shadow"] | dm.any(dim=0)
            dst = slice(self.d_count, self.d_count + E)
            d_shadow[dst] = False
            new = dict(shadow=shadow, d_shadow=d_shadow)
            for key, val in (("d_cl", cl), ("d_item", w_item),
                             ("d_ts", rel),
                             ("d_idx", d_idx.astype(np.int32))):
                new[key] = st[key].clone()
                new[key][dst] = self._dev(val)
            total = st["total"].clone()
            total[self._dev(ucl.astype(np.int64))] += \
                self._dev(cnt.astype(np.int32))
            new["total"] = total
            self._state = {**st, **new}
            self.d_count += E
            self._cursor_host[ucl] += cnt

    def _fold(self) -> None:
        """Fold the pending delta run into the ring (no-op when empty):
        apply the shadow tombstones, write each delta event to its slot
        (slot last-writer-wins through a pairwise later-matrix), drop
        events already evicted, and reset the run.  Reentrant under
        ``ingest``'s lock."""
        with self.write_lock:
            if self.d_count == 0:
                return
            st = self._state
            C, Q = self.n_clusters, self.queue_len
            d_cl, d_idx = st["d_cl"].long(), st["d_idx"].long()
            live = d_cl < C
            slot = torch.where(live, d_idx % Q, torch.zeros_like(d_idx))
            later = ((d_cl[None, :] == d_cl[:, None])
                     & (slot[None, :] == slot[:, None])
                     & (d_idx[None, :] > d_idx[:, None]) & live[None, :])
            wins = live & ~later.any(dim=1)
            age = st["total"][d_cl.clamp(0, C - 1)].long() - 1 - d_idx
            write = wins & (age < Q)
            w_item = torch.where(st["d_shadow"], -1, st["d_item"])
            items = st["items"].masked_fill(st["shadow"], -1)
            times = st["times"].clone()
            row, col = d_cl[write], slot[write]
            items[row, col] = w_item[write]
            times[row, col] = st["d_ts"][write]
            self._state = dict(
                items=items, times=times, total=st["total"],
                shadow=torch.zeros_like(st["shadow"]),
                ring_total=st["total"], **self._empty_delta())
            self.d_count = 0
            self.folds += 1

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
        tel.observe(self._m_latency, tel.clock.perf() - t0)
        tel.counter(self._m_requests)
        if not known.all():
            tel.counter(self._m_unknown_rq, float((~known).sum()))

    def retrieve_batch(self, user_ids: np.ndarray, now: float,
                       k: int) -> np.ndarray:
        """Batched U2U2I: ``(B,)`` user ids -> ``(B, k)`` item ids,
        newest-first, recency-filtered, ``-1``-padded; in delta mode the
        pending run is read in place, ahead of the ring."""
        t0 = self.tel.clock.perf() if self.tel.enabled else 0.0
        ucl, inv, known = self._unique_clusters(user_ids)
        st = self._state                 # one snapshot read
        cand, valid = _candidate_window(st, self._dev(ucl),
                                        self.rel_cutoff(now), self.delta_cap)
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

    def _ring_state(self) -> Dict[str, torch.Tensor]:
        """A consistent ring snapshot with nothing pending: delta mode
        folds first, so the ring is complete."""
        if not self.delta_cap:
            return self._state
        with self.write_lock:
            self._fold()
            return self._state

    @property
    def items(self) -> np.ndarray:
        return self._ring_state()["items"].cpu().numpy()

    @property
    def times(self) -> np.ndarray:
        return self._ring_state()["times"].cpu().numpy()

    @property
    def cursor(self) -> np.ndarray:
        return self._cursor_host

    def serve_batch(self, user_ids: np.ndarray, now: float, *,
                    n_recent: int = 8, k: int = 32, i2i=None
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Full serving pass: U2U2I seeds ``(B, n_recent)`` plus, when an
        ``i2i`` table is given, the U2I2I round-robin union ``(B, k)``,
        both int64 and ``-1``-padded.  With a table the whole batch is
        one ``queue_gather`` call on the ring (the CUDA kernel on a
        card; delta mode folds first); unknown users get empty rows."""
        if i2i is None:
            seeds = self.retrieve_batch(user_ids, now, n_recent)
            return seeds, np.full((seeds.shape[0], k), -1, np.int64)
        t0 = self.tel.clock.perf() if self.tel.enabled else 0.0
        cl, known = self.clusters_of(user_ids)
        st = self._ring_state()
        s, u = queue_gather(
            st["items"], st["times"], st["total"],
            self._dev(np.where(known, cl, -1).astype(np.int32)),
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
                    delta_pending=float(self.d_count))


# ---------------------------------------------------------------------------
# sharded store: N contiguous cluster ranges behind one router
# ---------------------------------------------------------------------------

class ShardedQueueStore:
    """``ClusterQueueStore`` partitioned into ``n_shards`` contiguous
    cluster ranges behind the same API.

    Routing is by cluster id: ingest sorts the batch by time once, splits
    it by owning shard, and scatters; retrieve routes each request to its
    shard and merges rows back in request order.  Each shard holds a
    full-length user->cluster sub-table (out-of-range users map to
    ``-1`` = unknown), so a shard can never serve another shard's
    cluster.  The relative-time epoch is global — fixed from the first
    ingested batch and given to every shard before any shard sees an
    event — so timestamps, and therefore retrieve results, are bitwise
    identical to an unsharded store over the same stream.

    ``devices``: shard ``s`` lives on ``devices[s % len(devices)]``
    (the JAX package places shard states round-robin over
    ``mesh.devices``); ``None`` puts every shard on the default device
    (CUDA).  With ``delta_cap`` each shard's delta scans and fold
    matrices cover its own range.  Ingest work shrinks as 1/S only with
    one shard per device: shards that share a device fold as often
    between them as one store does (the stream over ``delta_cap``), and
    only each fold's copy is smaller.

    Telemetry: each shard reports under a ``.shard{i}`` suffix; the
    facade emits the untagged aggregate series.
    """

    def __init__(self, user_clusters: np.ndarray, *, n_shards: int,
                 queue_len: int = 256, recency_s: float = 900.0,
                 n_clusters: Optional[int] = None, delta_cap: int = 0,
                 telemetry=None, devices: Optional[Sequence] = None):
        self.tel = telemetry if telemetry is not None else get_telemetry()
        self.user_clusters = np.asarray(user_clusters, np.int64)
        if n_clusters is None:
            n_clusters = max(int(self.user_clusters.max()) + 1, 1) \
                if self.user_clusters.size else 1
        self.n_clusters = max(int(n_clusters), 1)
        self.n_shards = max(int(n_shards), 1)
        self.queue_len = int(queue_len)
        self.recency_s = float(recency_s)
        self.delta_cap = int(delta_cap)
        self.bounds = np.linspace(0, self.n_clusters,
                                  self.n_shards + 1).astype(np.int64)
        devices = list(devices) if devices else [None]
        shards = []
        spans = []
        uc = self.user_clusters
        for s in range(self.n_shards):
            lo, hi = int(self.bounds[s]), int(self.bounds[s + 1])
            sub = np.where((uc >= lo) & (uc < hi), uc - lo, -1)
            shards.append(ClusterQueueStore(
                sub, queue_len=self.queue_len, recency_s=self.recency_s,
                n_clusters=max(hi - lo, 1), telemetry=self.tel,
                delta_cap=self.delta_cap, shard_tag=f".shard{s}",
                device=devices[s % len(devices)]))
            spans.append((lo, hi))
        self.shards: Tuple[ClusterQueueStore, ...] = tuple(shards)
        self._spans = tuple(spans)
        self.epoch: Optional[float] = None
        self.write_lock = threading.RLock()
        self.ring_seen = 0     # EventRing watermark (maintained by swap)

    # -- routing ------------------------------------------------------------

    def clusters_of(self, user_ids: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Global cluster ids + known mask (same contract as the
        unsharded store)."""
        user_ids = np.asarray(user_ids, np.int64).ravel()
        known = (user_ids >= 0) & (user_ids < self.user_clusters.shape[0])
        cl = self.user_clusters[np.where(known, user_ids, 0)]
        known = known & (cl >= 0)
        return np.where(known, cl, 0), known

    def _shard_of(self, cl: np.ndarray, known: np.ndarray) -> np.ndarray:
        sid = np.searchsorted(self.bounds, cl, side="right") - 1
        return np.where(known, sid, -1)

    # -- ingestion ----------------------------------------------------------

    def ingest(self, user_ids: np.ndarray, item_ids: np.ndarray,
               timestamps: np.ndarray) -> None:
        """Sort the batch by time once, split by owning shard, scatter.
        Per-shard ingests skip their own sort (``_presorted``)."""
        user_ids = np.asarray(user_ids, np.int64).ravel()
        item_ids = np.asarray(item_ids, np.int64).ravel()
        ts64 = np.asarray(timestamps, np.float64).ravel()
        cl, known = self.clusters_of(user_ids)
        if not known.all():
            if self.tel.enabled:
                self.tel.counter("serving.unknown_user_events",
                                 float((~known).sum()))
            user_ids = user_ids[known]
            item_ids = item_ids[known]
            ts64 = ts64[known]
            cl = cl[known]
        if cl.size == 0:
            return
        with self.write_lock:
            if self.epoch is None:
                # fix the global epoch before ANY shard ingests so every
                # shard stores identical relative timestamps
                self.epoch = float(ts64.min())
                for sh in self.shards:
                    with sh.write_lock:
                        sh.epoch = self.epoch
            # sort by the same f32 relative key the unsharded store uses
            # (stable), so per-shard ring order is bitwise-identical
            rel = (ts64 - self.epoch).astype(np.float32)
            order = np.argsort(rel, kind="stable")
            user_ids, item_ids = user_ids[order], item_ids[order]
            ts64, cl = ts64[order], cl[order]
            sid = np.searchsorted(self.bounds, cl, side="right") - 1
            for s, sh in enumerate(self.shards):
                m = sid == s
                if m.any():
                    sh.ingest(user_ids[m], item_ids[m], ts64[m],
                              _presorted=True)
        tel = self.tel
        if tel.enabled:
            tel.counter("serving.ingest_events", float(cl.size))
            fill = np.minimum(self.cursor[np.unique(cl)], self.queue_len)
            tel.gauge("serving.queue_depth_max", float(fill.max()))
            tel.gauge("serving.queue_depth_mean", float(fill.mean()))

    # -- retrieval ----------------------------------------------------------

    def rel_cutoff(self, now: float) -> float:
        return now - self.recency_s - (self.epoch or 0.0)

    def retrieve_batch(self, user_ids: np.ndarray, now: float,
                       k: int) -> np.ndarray:
        """Route each request to its owning shard, gather, merge back in
        request order.  Unknown users get ``-1`` rows without touching
        any shard."""
        tel = self.tel
        t0 = tel.clock.perf() if tel.enabled else 0.0
        user_ids = np.asarray(user_ids, np.int64).ravel()
        cl, known = self.clusters_of(user_ids)
        sid = self._shard_of(cl, known)
        out = np.full((user_ids.size, int(k)), -1, np.int64)
        for s, sh in enumerate(self.shards):
            m = sid == s
            if m.any():
                out[m] = sh.retrieve_batch(user_ids[m], now, k)
        if tel.enabled:
            tel.observe("serving.retrieve_latency_s", tel.clock.perf() - t0)
            tel.counter("serving.retrieve_requests")
            if not known.all():
                tel.counter("serving.unknown_user_requests",
                            float((~known).sum()))
        return out

    def retrieve(self, user_id: int, now: float, k: int) -> List[int]:
        row = self.retrieve_batch(np.array([user_id]), now, k)[0]
        return [int(i) for i in row if i >= 0]

    def serve_batch(self, user_ids: np.ndarray, now: float, *,
                    n_recent: int = 8, k: int = 32, i2i=None
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Scatter the serve pass across shards (one ``queue_gather``
        call each) and merge both outputs."""
        user_ids = np.asarray(user_ids, np.int64).ravel()
        cl, known = self.clusters_of(user_ids)
        sid = self._shard_of(cl, known)
        seeds = np.full((user_ids.size, int(n_recent)), -1, np.int64)
        union = np.full((user_ids.size, int(k)), -1, np.int64)
        for s, sh in enumerate(self.shards):
            m = sid == s
            if m.any():
                s_out, u_out = sh.serve_batch(user_ids[m], now,
                                              n_recent=n_recent, k=k,
                                              i2i=i2i)
                seeds[m] = s_out
                union[m] = u_out
        return seeds, union

    # -- introspection ------------------------------------------------------

    @property
    def cursor(self) -> np.ndarray:
        """Global per-cluster write counts (shard ranges are contiguous,
        so shard cursors concatenate into the global table)."""
        return np.concatenate(
            [sh._cursor_host[:hi - lo]
             for sh, (lo, hi) in zip(self.shards, self._spans)])

    @property
    def items(self) -> np.ndarray:
        return np.concatenate(
            [sh.items[:hi - lo]
             for sh, (lo, hi) in zip(self.shards, self._spans)], axis=0)

    @property
    def times(self) -> np.ndarray:
        return np.concatenate(
            [sh.times[:hi - lo]
             for sh, (lo, hi) in zip(self.shards, self._spans)], axis=0)

    def partitions(self) -> Tuple[ClusterQueueStore, ...]:
        return self.shards

    def stats(self) -> Dict[str, float]:
        fill = np.minimum(self.cursor, self.queue_len)
        active = fill > 0
        out = dict(n_shards=self.n_shards,
                   n_clusters_active=int(active.sum()),
                   mean_queue=float(fill[active].mean())
                   if active.any() else 0.0,
                   delta_pending=float(sum(sh.d_count
                                           for sh in self.shards)))
        for s, sh in enumerate(self.shards):
            for key, v in sh.stats().items():
                if key != "n_shards":
                    out[f"shard{s}.{key}"] = v
        return out


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


def u2i2i_retrieve(i2i, recent_items: Sequence[int], k: int, *,
                   device=None) -> List[int]:
    """Single-request U2I2I — a batch of one, on ``device`` (``None``:
    CUDA); a table elsewhere is copied there."""
    recent = list(recent_items)
    if not recent:
        return []
    dev = resolve_device(device)
    i2i = torch.as_tensor(i2i).to(dev)
    row = u2i2i_retrieve_batch(
        i2i, torch.tensor([recent], dtype=torch.int64, device=dev), k)[0]
    return [int(i) for i in row.tolist() if i >= 0]


# ---------------------------------------------------------------------------
# serving cost model (the 83% claim)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ServingCostModel:
    """Per-request compute/memory cost of U2U2I serving strategies.

    Online KNN: every request scores the query user against the active
    pool (exact or IVF-style approximate with n_probe fraction scanned).
    Cluster index: assign-once per embedding refresh (amortized ~0) +
    O(1) queue read per request.  ``batch_size`` models the batched
    engine: per-launch fixed costs (cursor/metadata reads, dispatch) are
    amortized across the request batch.  ``n_shards`` models the sharded
    router: the single-dispatch retrieve becomes one dispatch per shard
    touched by the batch, so launch overheads scale with the shard
    count while per-request work does not.
    """
    d: int = 256
    active_pool: int = 5_000_000       # recently-active users (15 min)
    qps: float = 1e6
    n_probe_frac: float = 0.05         # ANN scans ~5% of the pool
    queue_read_items: int = 64
    rq_codes: Tuple[int, ...] = (5000, 50)
    batch_size: int = 1
    n_shards: int = 1
    launch_bytes: float = 64 * 1024.0  # per-launch metadata + dispatch
    launch_flops: float = 4 * 1024.0

    def _batch(self, batch_size: Optional[int]) -> int:
        return max(int(batch_size if batch_size is not None
                       else self.batch_size), 1)

    def knn_flops_per_req(self, exact: bool = False) -> float:
        frac = 1.0 if exact else self.n_probe_frac
        return 2.0 * self.d * self.active_pool * frac

    def knn_bytes_per_req(self, exact: bool = False) -> float:
        frac = 1.0 if exact else self.n_probe_frac
        return 4.0 * self.d * self.active_pool * frac

    def cluster_flops_per_req(self, batch_size: Optional[int] = None
                              ) -> float:
        # queue read: no dot products at request time; assignment cost is
        # amortized into the embedding-refresh batch job:
        assign = 2.0 * self.d * sum(self.rq_codes)      # per refresh
        refresh_period_s = 3 * 3600.0
        amortized = assign / max(self.qps * refresh_period_s /
                                 max(self.active_pool, 1), 1e-9)
        return amortized + (max(self.n_shards, 1) * self.launch_flops
                            / self._batch(batch_size))

    def cluster_bytes_per_req(self, batch_size: Optional[int] = None
                              ) -> float:
        # queue read + code read per request; launch cost (one dispatch
        # per shard) amortized over the batch served per dispatch
        return (8.0 * self.queue_read_items + 8.0
                + (max(self.n_shards, 1) * self.launch_bytes
                   / self._batch(batch_size)))

    def cost_reduction(self, batch_size: Optional[int] = None) -> float:
        """Fractional serving-cost reduction (bytes+flops weighted by a
        machine-cost proxy: memory-bandwidth bound at serving tier)."""
        knn = self.knn_bytes_per_req()
        cl = self.cluster_bytes_per_req(batch_size)
        return 1.0 - cl / max(knn, 1e-9)
