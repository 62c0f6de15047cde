"""Host (numpy) serving engine, as ``repro/core/serving_host.py``: the
seqlock store the device stores are held against.

This module holds the multithreaded *host* implementation of the
cluster-queue store: per-thread ``BufPool`` scratch, the composite-key
``dedup_topk_rows`` pass, and ``HostQueueStore``, the seqlock-guarded
``(n_clusters, queue_len)`` ring-buffer store whose readers run
lock-free against a concurrently ingesting writer.  It is numpy through
and through, bit for bit the JAX package's copy.

``repro_torch.core.serving`` serves from rings on a device
(``ClusterQueueStore``, ``ShardedQueueStore``); this module is

* the port's own **bitwise oracle** for them
  (``tests/test_torch_serving_scaleout.py``): they dedup at ingest, this
  store at retrieve, so a ``(cluster, item)`` re-ingested in a later
  batch with an older timestamp diverges iff the recency cutoff falls
  between the two stamps, and nothing else does;
* the **scale-out baseline** a host-only deployment would run.

Threading contract: one store serves N reader threads concurrently.
Request scratch comes from a per-thread ``BufPool`` registry, and the
retrieve path is lock-free: a per-cluster seqlock (generation counter,
odd while a write is in flight) lets readers run against a concurrently
ingesting store and retry the gather on the rare torn read.  Writers
serialize on the store's write lock.

Departure from the JAX copy: ``serve_batch`` has no ``use_kernel``
switch (the fused kernel runs on the device stores); the U2I2I union is
``u2i2i_host``, the JAX package's numpy ``u2i2i_retrieve_batch``.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs import get_telemetry

_OBS = get_telemetry()   # process singleton; configure() mutates in place


# ---------------------------------------------------------------------------
# batched row utilities (shared by U2U2I and U2I2I paths)
# ---------------------------------------------------------------------------

class BufPool:
    """Named scratch-buffer cache so the steady-state serving path runs
    allocation-free (fresh multi-MB temporaries each request batch cost
    more in page faults than the actual compute).

    Single-threaded by design — the buffers are reused in place, so one
    pool must never be shared across concurrent requests.  Concurrent
    callers go through ``ThreadLocalPools`` (one pool per thread) rather
    than holding a pool directly."""

    def __init__(self):
        self._bufs: Dict[str, np.ndarray] = {}

    def get(self, name: str, shape: Tuple[int, ...], dtype) -> np.ndarray:
        buf = self._bufs.get(name)
        if buf is None or buf.shape != shape or buf.dtype != dtype:
            buf = np.empty(shape, dtype)
            self._bufs[name] = buf
            if _OBS.enabled:   # steady state should stop allocating
                _OBS.counter("serving.pool_allocs")
        return buf


class ThreadLocalPools:
    """Per-thread ``BufPool`` registry: ``get()`` hands each thread its
    own pool, so N serving threads can share one immutable store without
    aliasing each other's ``rows``/``ts``/``key`` scratch.  Buffers die
    with their thread (``threading.local`` storage)."""

    def __init__(self):
        self._tls = threading.local()

    def get(self) -> BufPool:
        pool = getattr(self._tls, "pool", None)
        if pool is None:
            pool = self._tls.pool = BufPool()
        return pool


_POOLS = ThreadLocalPools()   # default pools for module-level entry points


def dedup_topk_rows(cand: np.ndarray, prio: np.ndarray, valid: np.ndarray,
                    k: int, prio_bound: int,
                    pool: Optional[BufPool] = None) -> np.ndarray:
    """Per row: among ``valid`` entries, dedup items keeping the
    lowest-priority occurrence, then emit the ``k`` lowest-priority
    survivors in priority order as ``(B, k)`` int64, ``-1``-padded.

    ``prio`` must be unique per row and ``< prio_bound`` wherever valid.
    One unstable composite-key sort (item * P + priority packs both the
    dedup grouping and the within-item winner into a single ordered
    pass) plus an O(Q) top-k partition — no stable sorts, no scatters,
    no allocations beyond the (B, k) result.
    """
    pool = pool if pool is not None else _POOLS.get()
    B, M = cand.shape
    pshift = max(int(prio_bound - 1).bit_length(), 1)  # P = 2^pshift
    P = 1 << pshift
    ishift = max(int(cand.max(initial=0)).bit_length(), 1)
    dt = np.int32 if pshift + ishift < 31 else np.int64
    big = np.iinfo(dt).max
    # pass 1: sort on (item, prio) — groups duplicates, winner first.
    # Value sorts throughout: the original column is never needed again,
    # so no argsort/gather round-trips; key assembly is in-place.
    key = pool.get("key", (B, M), dt)
    scrap = pool.get("scrap", (B, M), bool)
    np.left_shift(cand, pshift, out=key, dtype=dt)
    np.add(key, prio, out=key)
    np.logical_not(valid, out=scrap)
    np.copyto(key, big, where=scrap)
    key.sort(axis=1)
    item = pool.get("item", (B, M), dt)
    np.right_shift(key, pshift, out=item)
    alive = pool.get("alive", (B, M), bool)
    alive[:, 0] = True
    np.not_equal(item[:, 1:], item[:, :-1], out=alive[:, 1:])  # dedup
    # pass 2: re-pack winners as (prio, item) and select the k smallest
    np.not_equal(key, big, out=scrap)
    alive &= scrap
    key2 = pool.get("key2", (B, M), dt)
    np.bitwise_and(key, P - 1, out=key2)
    np.left_shift(key2, ishift, out=key2)
    np.bitwise_or(key2, item, out=key2)
    np.logical_not(alive, out=alive)
    np.copyto(key2, big, where=alive)
    kk = min(k, M)
    if kk < M:
        key2.partition(kk - 1, axis=1)
        key2 = key2[:, :kk]
    key2.sort(axis=1)
    out = np.where(key2 != big,
                   key2 & ((1 << ishift) - 1), -1).astype(np.int64)
    if out.shape[1] < k:
        out = np.pad(out, ((0, 0), (0, k - out.shape[1])),
                     constant_values=-1)
    return out


def u2i2i_host(i2i: np.ndarray, recent_items: np.ndarray,
               k: int) -> np.ndarray:
    """Batched U2I2I on the host: union the similar-item lists of each
    row's recent items ``(B, R)`` (``-1`` = padding), round-robin across
    ranks to preserve per-seed ordering, mask the seeds themselves,
    dedup, and return ``(B, k)`` ``-1``-padded candidates."""
    recent = np.asarray(recent_items, np.int64)
    B, R = recent.shape
    K = i2i.shape[1]
    nonneg = recent >= 0
    # seeds past the end of the table contribute no neighbors (queues see
    # brand-new items before the next offline I2I refresh covers them)
    seeded = nonneg & (recent < i2i.shape[0])
    cand = np.asarray(i2i, np.int32)[np.where(seeded, recent, 0)]  # (B,R,K)
    cand = np.where(seeded[:, :, None], cand, -1)
    flat = cand.reshape(B, R * K)                        # seed-major layout
    # round-robin emission priority of the seed per-request loop (rank 0
    # of every seed, then rank 1, ...) as a per-column key — no need to
    # physically transpose into rank-major order
    col = np.arange(R * K, dtype=np.int32)
    prio = (col % K) * R + col // K
    # every non-negative seed is masked from the union, including ones
    # the table does not cover (a candidate may still equal them)
    seen = (flat[:, :, None] ==
            np.where(nonneg, recent, -2)[:, None, :]).any(axis=2)
    valid = (flat >= 0) & ~seen
    return dedup_topk_rows(flat, prio[None, :], valid, k, R * K)


# ---------------------------------------------------------------------------
# host cluster-queue store (U2U2I) — the seqlock engine
# ---------------------------------------------------------------------------

class HostQueueStore:
    """Real-time per-cluster item queues with recency filtering — host
    arrays, seqlock readers.

    Flat ring-buffer layout: ``items``/``times`` are dense
    ``(n_clusters, queue_len)`` arrays and ``cursor[c]`` counts total
    writes into cluster ``c`` (write position = ``cursor % queue_len``,
    fill level = ``min(cursor, queue_len)``) — O(1) eviction, no Python
    containers anywhere on the serving path.

    Concurrency: writers serialize on ``write_lock`` (an RLock — the
    swap engine's ring drain wraps ``ingest`` in the same lock);
    readers are lock-free via a per-cluster seqlock, ``gen[c]``, which
    is odd exactly while a write to cluster ``c`` is in flight.  A
    reader gathers its rows, then re-checks the generations it started
    from and retries on mismatch; after ``_SEQLOCK_SPINS`` failed
    attempts it falls back to one gather under ``write_lock``.
    """

    _SEQLOCK_SPINS = 32

    def __init__(self, user_clusters: np.ndarray, *, queue_len: int = 256,
                 recency_s: float = 900.0, n_clusters: Optional[int] = None,
                 telemetry=None):
        self.tel = telemetry if telemetry is not None else get_telemetry()
        self.user_clusters = np.asarray(user_clusters, np.int64)
        self.queue_len = int(queue_len)
        self.recency_s = float(recency_s)
        if n_clusters is None:
            n_clusters = int(self.user_clusters.max()) + 1 \
                if self.user_clusters.size else 1
        self.n_clusters = int(n_clusters)
        self.items = np.full((self.n_clusters, self.queue_len), -1, np.int32)
        # timestamps are stored float32 relative to the first-seen event
        # (absolute unix-epoch seconds lose ~100s of precision in f32)
        self.times = np.full((self.n_clusters, self.queue_len), -np.inf,
                             np.float32)
        self.cursor = np.zeros(self.n_clusters, np.int64)
        self.epoch: Optional[float] = None
        self.pools = ThreadLocalPools()  # per-thread request scratch
        self.gen = np.zeros(self.n_clusters, np.int64)   # seqlock, odd=busy
        self.write_lock = threading.RLock()
        self.ring_seen = 0     # EventRing watermark (maintained by swap)

    # -- cluster assignment lookup ------------------------------------------

    def clusters_of(self, user_ids: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Cluster ids for a batch of users plus a known-user mask.

        Users outside the assignment table — ids minted *after* the
        snapshot this store serves was published (the id space grows at
        every lifecycle refresh) — map to cluster 0 with ``known=False``;
        callers must mask their rows out rather than crash or serve
        another user's cluster.
        """
        user_ids = np.asarray(user_ids, np.int64).ravel()
        known = (user_ids >= 0) & (user_ids < self.user_clusters.shape[0])
        cl = self.user_clusters[np.where(known, user_ids, 0)]
        known = known & (cl >= 0)       # -1 = unassigned (out-of-shard)
        return np.where(known, cl, 0), known

    # -- ingestion ----------------------------------------------------------

    def ingest(self, user_ids: np.ndarray, item_ids: np.ndarray,
               timestamps: np.ndarray) -> None:
        """Stream a batch of engagement events into their users' cluster
        ring buffers (vectorized; oldest-to-newest so the ring order is
        the time order within the batch).  Events from users unknown to
        this snapshot's assignment table are dropped (they enter queues
        once the next publication assigns them a cluster).

        Thread-safe vs concurrent writers (``write_lock``) and vs
        lock-free readers: all array writes happen inside the touched
        clusters' seqlock window (``gen`` odd), so a reader overlapping
        the scatter retries instead of returning a torn row."""
        user_ids = np.asarray(user_ids, np.int64).ravel()
        item_ids = np.asarray(item_ids, np.int64).ravel()
        ts64 = np.asarray(timestamps, np.float64).ravel()
        cl_all, known = self.clusters_of(user_ids)
        if not known.all():
            # graceful degradation: post-snapshot users are shed, not
            # errored — the drop is surfaced as a counter so staleness
            # between publications is observable
            if self.tel.enabled:
                self.tel.counter("serving.unknown_user_events",
                                 float((~known).sum()))
            cl_all = cl_all[known]
            item_ids = item_ids[known]
            ts64 = ts64[known]
        if cl_all.size == 0:
            return
        with self.write_lock:
            if self.epoch is None:
                self.epoch = float(ts64.min())
            ts = (ts64 - self.epoch).astype(np.float32)
            order = np.argsort(ts, kind="stable")
            cl = cl_all[order]
            it = item_ids[order]
            ts = ts[order]

            # per-cluster arrival rank (stable sort by cluster keeps
            # time order)
            by_cl = np.argsort(cl, kind="stable")
            cl_sorted = cl[by_cl]
            boundary = np.r_[True, cl_sorted[1:] != cl_sorted[:-1]]
            group_start = np.maximum.accumulate(
                np.where(boundary, np.arange(cl.size), 0))
            rank = np.empty(cl.size, np.int64)
            rank[by_cl] = np.arange(cl.size) - group_start

            slot = (self.cursor[cl] + rank) % self.queue_len
            # keep only the final write per (cluster, slot): with more
            # events than queue_len for one cluster in a single batch,
            # older events fall straight through the ring
            key = cl * self.queue_len + slot
            _, last = np.unique(key[::-1], return_index=True)
            last = cl.size - 1 - last
            uniq, counts = np.unique(cl, return_counts=True)
            self.gen[uniq] += 1                # enter: odd -> readers spin
            self.items[cl[last], slot[last]] = it[last]
            self.times[cl[last], slot[last]] = ts[last]
            self.cursor[uniq] += counts
            self.gen[uniq] += 1                # exit: even -> consistent
        tel = self.tel
        if tel.enabled:
            tel.counter("serving.ingest_events", float(cl.size))
            fill = np.minimum(self.cursor[uniq], self.queue_len)
            tel.gauge("serving.queue_depth_max", float(fill.max()))
            tel.gauge("serving.queue_depth_mean", float(fill.mean()))

    # -- retrieval ----------------------------------------------------------

    def rel_cutoff(self, now: float) -> float:
        """Recency cutoff in the store's internal (epoch-relative) time."""
        return now - self.recency_s - (self.epoch or 0.0)

    def _seqlock_read(self, cl: np.ndarray, fn):
        """Run ``fn()`` (which reads this store's arrays for clusters
        ``cl``) under the seqlock discipline: skip while any touched
        generation is odd, re-check the generations the read started
        from, and retry on mismatch (a writer scattered into one of our
        clusters mid-read).  Lock-free on the happy path; after
        ``_SEQLOCK_SPINS`` collisions, one run under ``write_lock``
        guarantees progress.

        Every collision (odd generation seen, or generation moved under
        the read) counts as a ``serving.seqlock_retries`` tick; taking
        the locked path counts as ``serving.seqlock_fallbacks``."""
        tel = self.tel
        retries = 0
        for _ in range(self._SEQLOCK_SPINS):
            g0 = self.gen[cl]            # fancy index -> private copy
            if (g0 & 1).any():           # a write is mid-flight: respin
                retries += 1
                continue
            out = fn()
            if np.array_equal(self.gen[cl], g0):
                if retries and tel.enabled:
                    tel.counter("serving.seqlock_retries", float(retries))
                return out
            retries += 1
        if tel.enabled:
            if retries:
                tel.counter("serving.seqlock_retries", float(retries))
            tel.counter("serving.seqlock_fallbacks")
        with self.write_lock:            # bounded fallback: quiesced read
            return fn()

    def _consistent_gather(self, cl: np.ndarray, pool: BufPool
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Seqlock gather of ``(items, times, cursor)`` rows for
        clusters ``cl`` into per-thread scratch."""
        B, Q = cl.shape[0], self.queue_len
        rows = pool.get("rows", (B, Q), np.int32)
        ts = pool.get("ts", (B, Q), np.float32)

        def gather():
            np.take(self.items, cl, axis=0, out=rows)
            np.take(self.times, cl, axis=0, out=ts)
            return rows, ts, self.cursor[cl]

        return self._seqlock_read(cl, gather)

    def retrieve_batch(self, user_ids: np.ndarray, now: float,
                       k: int) -> np.ndarray:
        """Batched U2U2I: ``(B,)`` user ids -> ``(B, k)`` item ids,
        newest-first, recency-filtered, deduped, ``-1``-padded.  One
        vectorized pass over the whole request batch.  Safe to call from
        many threads at once (per-thread scratch, seqlock-guarded
        gather)."""
        tel = self.tel
        t0 = tel.clock.perf() if tel.enabled else 0.0
        user_ids = np.asarray(user_ids, np.int64).ravel()
        Q = self.queue_len
        B = user_ids.shape[0]
        pool = self.pools.get()
        cl, known = self.clusters_of(user_ids)
        rows, ts, total = self._consistent_gather(cl, pool)
        head = (total % Q).astype(np.int32)
        slot = np.arange(Q, dtype=np.int32)[None, :]
        age = pool.get("age", (B, Q), np.int32)
        np.subtract(head[:, None], slot + 1, out=age)
        if Q & (Q - 1) == 0:                                 # pow2 fast path
            np.bitwise_and(age, Q - 1, out=age)              # newest = 0
        else:
            np.mod(age, Q, out=age)
        valid = pool.get("valid", (B, Q), bool)
        mask = pool.get("mask", (B, Q), bool)
        np.greater_equal(ts, np.float32(self.rel_cutoff(now)), out=valid)
        np.less(age, np.minimum(total, Q)[:, None], out=mask)
        valid &= mask
        np.greater_equal(rows, 0, out=mask)
        valid &= mask
        if not known.all():
            valid &= known[:, None]          # unknown users: empty rows
            if tel.enabled:
                tel.counter("serving.unknown_user_requests",
                            float((~known).sum()))
        out = dedup_topk_rows(rows, age, valid, k, Q, pool)
        if tel.enabled:
            tel.observe("serving.retrieve_latency_s",
                        tel.clock.perf() - t0)
            tel.counter("serving.retrieve_requests")
        return out

    def retrieve(self, user_id: int, now: float, k: int) -> List[int]:
        """Single-request U2U2I — a batch of one."""
        row = self.retrieve_batch(np.array([user_id]), now, k)[0]
        return [int(i) for i in row if i >= 0]

    def serve_batch(self, user_ids: np.ndarray, now: float, *,
                    n_recent: int = 8, k: int = 32,
                    i2i: Optional[np.ndarray] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Full serving pass: U2U2I seeds ``(B, n_recent)`` plus — when an
        ``i2i`` table is given — the U2I2I round-robin union ``(B, k)``."""
        seeds = self.retrieve_batch(user_ids, now, n_recent)
        if i2i is None:
            return seeds, np.full((seeds.shape[0], k), -1, np.int64)
        return seeds, u2i2i_host(np.asarray(i2i), seeds, k)

    def partitions(self) -> Tuple["HostQueueStore", ...]:
        """Shard polymorphism: a host store is its own single shard."""
        return (self,)

    def stats(self) -> Dict[str, float]:
        fill = np.minimum(self.cursor, self.queue_len)
        active = fill > 0
        return dict(n_shards=1, n_clusters_active=int(active.sum()),
                    mean_queue=float(fill[active].mean())
                    if active.any() else 0.0)
