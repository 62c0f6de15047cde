"""Atomic hot-swap of published index versions into live serving, as
``repro/lifecycle/swap.py``.  Each bundle's store is a
``ClusterQueueStore`` (or, with ``n_shards > 1``, a
``ShardedQueueStore`` whose shards all live there) resident on the
server's device (CUDA unless the caller passes ``device="cpu"``); its
``serve_batch`` runs the ``queue_gather`` kernel there, once a shard.

``SnapshotHandle`` is the double-buffer: two slots, each holding an
immutable ``ServingBundle`` (snapshot + its ``ClusterQueueStore`` + I2I
table), and one active-slot reference.  Every request path captures the
bundle reference exactly once at entry, so an in-flight
``retrieve_batch``/``serve_batch`` sees one version in full — never a
mix — and the flip itself is a single Python reference assignment
(atomic under the interpreter; the store/i2i/version triplet travels as
one object, so there is no window where a reader can pair version N's
queues with version N+1's I2I table).

Queue re-keying across versions: the store's ring buffers are keyed by
cluster id, and a user's cluster can change between snapshots, so queue
contents cannot be carried over by array copy.  Instead the engine
retains the recent raw event window in an ``EventRing`` and *replays*
it into the incoming snapshot's store before the flip — events land in
their users' *new* clusters by construction, and anything older than
the recency horizon (or past the ring capacity) is drained by
staleness, which the recency filter would have discarded anyway.

Concurrency contract (the multithreaded serving tier):

* **Writers** go through ``SwapServer.ingest`` only.  The ring is the
  single serialization point — ``EventRing.push`` reserves a contiguous
  slot range with an atomic cursor fetch-add and writes it outside any
  lock; a committed watermark advances over finished reservations so
  readers of the ring never observe a half-written range.  Events then
  reach the live store by *draining the ring* into it (``_drain_into``)
  under a per-store watermark (``store.ring_seen``), which makes
  application exactly-once per bundle no matter how many writer threads
  race: whoever drains first applies the events, later drains skip
  them.
* **Readers** (``retrieve_batch``/``serve_batch``) acquire the bundle
  once and run lock-free against its store (MVCC snapshot on the store
  side: one atomic ``_state`` reference read per request batch).
* **The swap** closes the classic lost-event race — an ingest that
  lands between the catch-up read and the flip used to be written to
  the *old* bundle's store only.  Because every event is in the ring
  *before* any store sees it, draining the ring **again after the
  flip** (and on every subsequent ingest, via the watermark) guarantees
  the new bundle observes it exactly once.
"""
from __future__ import annotations

import dataclasses
import heapq
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from repro_torch.core.serving import (ClusterQueueStore,
                                      ShardedQueueStore)
from repro_torch.faults import InjectedCrash, get_faults
from repro_torch.kernels.common import resolve_device
from repro_torch.lifecycle.snapshot import IndexSnapshot
from repro_torch.obs import get_telemetry


class EventRing:
    """Fixed-capacity ring of raw (user, item, ts) engagement events —
    the replay source for queue re-keying at swap time.

    Multi-writer safe: ``push`` reserves ``[start, start+n)`` with an
    atomic cursor fetch-add (a two-op critical section under the ring
    lock), scatters the events into the reserved slots with no lock
    held, then commits.  ``committed`` is the contiguous prefix of
    reservations whose writes have finished — out-of-order completions
    park in a small heap until the gap before them closes — and bounds
    what ``window_since`` returns, so a half-written range is never
    visible.

    Wrap safety: once ``cursor`` exceeds ``capacity``, an in-flight
    write at reserved position ``q`` aliases the physical slot of the
    committed position ``q - capacity``.  All in-flight writes satisfy
    ``q >= committed`` (commit can't pass an unfinished reservation),
    so a reader is safe iff it never touches positions below
    ``cursor - capacity``: ``window_since`` clamps its lower bound by
    the *reserved* cursor, re-checks the cursor after copying (a
    reservation made mid-copy could reach back into the window), and
    retries — falling back to a copy under the ring lock, where no new
    reservation can start and the clamp makes pre-existing in-flight
    writes provably disjoint from the window.  Positions skipped by the
    clamp are events already being overwritten by newer pushes — the
    same overflow the capacity bound always implied.
    """

    _WINDOW_SPINS = 8

    def __init__(self, capacity: int = 1 << 16):
        self.capacity = int(capacity)
        self.user = np.full(self.capacity, -1, np.int64)
        self.item = np.full(self.capacity, -1, np.int64)
        self.ts = np.full(self.capacity, -np.inf, np.float64)
        self.cursor = 0                   # total slots ever reserved
        self.committed = 0                # contiguous fully-written prefix
        self._lock = threading.Lock()
        self._done: list = []             # (start, end) finished o-o-o

    def push(self, user_ids: np.ndarray, item_ids: np.ndarray,
             timestamps: np.ndarray) -> int:
        """Append a batch of events; returns how many were **dropped**
        (0 in steady state — only a single batch larger than the whole
        ring truncates to its trailing window, and callers must know).

        Reservation applies backpressure: a reservation is granted only
        while the total in-flight span (``cursor - committed + n``)
        fits the ring, so two concurrent reservations can never alias
        the same physical slots and stomp each other's unlocked
        scatters.  The wait is a yield-loop — committers need the same
        lock, so it cannot be held while waiting."""
        u = np.asarray(user_ids, np.int64).ravel()
        if u.size == 0:
            return 0
        i = np.asarray(item_ids, np.int64).ravel()
        t = np.asarray(timestamps, np.float64).ravel()
        dropped = 0
        if u.size > self.capacity:        # only the trailing window fits
            dropped = u.size - self.capacity
            u, i, t = (a[-self.capacity:] for a in (u, i, t))
        while True:                       # atomic fetch-add reservation
            with self._lock:
                if (self.cursor - self.committed + u.size
                        <= self.capacity):
                    start = self.cursor
                    self.cursor = start + u.size
                    break
            time.sleep(0)                 # let in-flight writers commit
        slot = (start + np.arange(u.size)) % self.capacity
        self.user[slot] = u               # slot writes: no lock held
        self.item[slot] = i
        self.ts[slot] = t
        with self._lock:                  # commit: close contiguous gaps
            heapq.heappush(self._done, (start, start + u.size))
            while self._done and self._done[0][0] <= self.committed:
                _, end = heapq.heappop(self._done)
                if end > self.committed:
                    self.committed = end
        return dropped

    def _copy_window(self, start: int):
        """One attempt at a consistent ``[lo, committed)`` copy; returns
        ``None`` when a reservation made during the copy may have
        scattered into the physical slots just read."""
        end = self.committed
        lo = max(start, self.cursor - self.capacity)   # wrap-safe bound
        if lo >= end:
            z = np.zeros(0, np.int64)
            return z, z.copy(), np.zeros(0, np.float64), end
        pos = np.arange(lo, end) % self.capacity
        u, i, t = self.user[pos], self.item[pos], self.ts[pos]
        if self.cursor > lo + self.capacity:           # mid-copy alias
            return None
        return u, i, t, end

    def window_since(self, start: int, min_ts: float
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
        """Events pushed at positions ``[start, committed)`` (clamped to
        the ring's wrap-safe trailing window) with ``ts >= min_ts``,
        oldest first.  Returns ``(users, items, ts, cursor_at_read)`` —
        feed ``cursor_at_read`` back as the next ``start`` for an
        incremental read that never delivers a position twice."""
        out = None
        for _ in range(self._WINDOW_SPINS):
            out = self._copy_window(start)
            if out is not None:
                break
        if out is None:
            with self._lock:       # freeze reservations; clamp does the rest
                out = self._copy_window(start)
        u, i, t, end = out
        keep = t >= min_ts
        return u[keep], i[keep], t[keep], end


@dataclasses.dataclass(frozen=True)
class ServingBundle:
    """Everything one snapshot version needs to serve — flipped as a
    single immutable unit.  ``store`` is a ``ClusterQueueStore`` or,
    when the server is sharded, a ``ShardedQueueStore`` (same API)."""
    version: int
    snapshot: IndexSnapshot
    store: "ClusterQueueStore | ShardedQueueStore"
    i2i: np.ndarray


class SnapshotHandle:
    """Double-buffered bundle holder with an atomic flip.

    Readers call ``acquire()`` once per request batch and use only the
    returned bundle; ``flip(bundle)`` installs a new version in the
    spare slot and swaps the active reference.  The previous bundle
    stays alive in the spare slot until the *next* flip, giving
    still-running readers a consistent view for their whole call.
    """

    def __init__(self, bundle: ServingBundle):
        self._slots = [bundle, None]
        self._active = bundle

    def acquire(self) -> ServingBundle:
        return self._active              # one atomic reference read

    def flip(self, bundle: ServingBundle) -> ServingBundle:
        """Install ``bundle`` and return the displaced one."""
        old = self._active
        spare = 1 if self._slots[0] is old else 0
        self._slots[spare] = bundle
        self._active = bundle            # THE atomic publication point
        return old

    @property
    def version(self) -> int:
        return self._active.version


class SwapServer:
    """The serving facade the lifecycle runtime drives: ingest + batched
    retrieval against whichever snapshot version is live, and
    ``swap_to`` for zero-downtime version changes.

    Every retrieval returns ``(results, version)`` so each response is
    attributable to exactly one published snapshot.
    """

    def __init__(self, snapshot: IndexSnapshot, *, queue_len: int = 256,
                 recency_s: float = 3600.0, ring_capacity: int = 1 << 16,
                 n_shards: int = 1, delta_cap: int = 0,
                 clock: Optional[Callable[[], float]] = None,
                 telemetry=None, faults=None, device=None):
        self.queue_len = int(queue_len)
        self.recency_s = float(recency_s)
        self.n_shards = max(int(n_shards), 1)
        self.delta_cap = int(delta_cap)
        self.device = resolve_device(device)
        self.tel = telemetry if telemetry is not None else get_telemetry()
        self.faults = faults if faults is not None else get_faults()
        # injectable so swap-report timings are replayable in tests —
        # the only clock-derived state this class retains
        self._clock = clock if clock is not None else self.tel.clock.perf
        self.ring = EventRing(ring_capacity)
        self.handle = SnapshotHandle(self._bundle(snapshot))
        self.swap_reports: list = []
        self._stats_lock = threading.Lock()
        self.ring_dropped = 0            # cumulative push-truncation drops
        # test seam: called between the pre-flip catch-up and the flip —
        # exactly the window of the historical lost-event race
        self._pre_flip_hook: Optional[Callable[[], None]] = None

    def _bundle(self, snapshot: IndexSnapshot) -> ServingBundle:
        if self.n_shards > 1:
            store = ShardedQueueStore(snapshot.user_clusters,
                                      n_shards=self.n_shards,
                                      queue_len=self.queue_len,
                                      recency_s=self.recency_s,
                                      n_clusters=snapshot.n_clusters,
                                      delta_cap=self.delta_cap,
                                      telemetry=self.tel,
                                      devices=[self.device])
        else:
            store = ClusterQueueStore(snapshot.user_clusters,
                                      queue_len=self.queue_len,
                                      recency_s=self.recency_s,
                                      n_clusters=snapshot.n_clusters,
                                      delta_cap=self.delta_cap,
                                      telemetry=self.tel,
                                      device=self.device)
        return ServingBundle(version=snapshot.version, snapshot=snapshot,
                             store=store, i2i=snapshot.i2i)

    @property
    def version(self) -> int:
        return self.handle.version

    # -- ring -> store application (exactly-once per bundle) ----------------

    def _drain_into(self, bundle: ServingBundle,
                    min_ts: float = -np.inf) -> Tuple[int, int]:
        """Apply every ring event the bundle has not seen yet to its
        store and advance the bundle's watermark.  Safe under writer
        races: the (read watermark -> ingest -> advance) section runs
        under the store's write lock, so each ring position is applied
        to this store exactly once.  Returns ``(applied, stale)``."""
        store = bundle.store
        with store.write_lock:
            u, i, t, end = self.ring.window_since(store.ring_seen, -np.inf)
            stale = 0
            if min_ts > -np.inf and len(t):
                keep = t >= min_ts
                stale = int((~keep).sum())
                u, i, t = u[keep], i[keep], t[keep]
            if len(u):
                store.ingest(u, i, t)
            store.ring_seen = end
        return len(u), stale

    # -- request path -------------------------------------------------------

    def ingest(self, user_ids, item_ids, timestamps) -> None:
        """Multi-writer ingest: the ring is written first (the source of
        truth), then drained into the live bundle.  Any concurrent swap
        that misses this batch in its catch-up pass will pick it up from
        the ring post-flip; any event another writer already drained is
        skipped by the watermark.

        Degradation contract: a failed ring push (the ``ring.push``
        fault site models reservation overload) **sheds the batch**
        instead of erroring the caller — serving stays up, the loss is
        surfaced through the ring-drop counters (``swap.ring_dropped``
        plus ``swap.ingest_shed_batches``), and the already-committed
        ring prefix stays intact for exactly-once replay."""
        n = np.asarray(user_ids).size
        try:
            self.faults.fire("ring.push", n=n)
            dropped = self.ring.push(user_ids, item_ids, timestamps)
        except InjectedCrash:
            raise                       # simulated process death
        except Exception:
            # overload shed: count the whole batch as dropped, keep serving
            with self._stats_lock:
                self.ring_dropped += n
            self.tel.counter("swap.ring_dropped", float(n))
            self.tel.counter("swap.ingest_shed_batches")
            return
        if dropped:
            with self._stats_lock:
                self.ring_dropped += dropped
            self.tel.counter("swap.ring_dropped", float(dropped))
        self._drain_into(self.handle.acquire())

    def retrieve_batch(self, user_ids, now: float, k: int
                       ) -> Tuple[np.ndarray, int]:
        b = self.handle.acquire()
        return b.store.retrieve_batch(user_ids, now, k), b.version

    def serve_batch(self, user_ids, now: float, *, n_recent: int = 8,
                    k: int = 32) -> Tuple[np.ndarray, np.ndarray, int]:
        b = self.handle.acquire()
        seeds, union = b.store.serve_batch(user_ids, now,
                                           n_recent=n_recent, k=k,
                                           i2i=b.i2i)
        return seeds, union, b.version

    # -- version flip -------------------------------------------------------

    def swap_to(self, snapshot: IndexSnapshot, now: float
                ) -> Dict[str, float]:
        """Hot-swap to ``snapshot``: build + warm its store off to the
        side (the old version keeps serving), replay the retained event
        window into the new clusters, catch up events that raced in
        during the replay, flip, then drain the ring once more.

        The post-flip drain is what closes the lost-event race: a
        writer that acquired the old bundle between the catch-up read
        and the flip has already pushed its events to the ring (push
        happens-before acquire), so the new bundle's watermark drain
        observes them — and a writer that acquires the new bundle
        drains through the same watermark, so nothing is applied twice.

        The *stall* — the span in which a hypothetical concurrent
        request could observe the engine mid-transition — is only the
        catch-up + flip + post-flip drain; the bulk replay is off-path.
        """
        tel = self.tel
        with tel.span("lifecycle.swap",
                      to_version=int(snapshot.version)) as sp:
            t0 = self._clock()
            with tel.span("swap.build"):
                bundle = self._bundle(snapshot)
            cutoff = now - self.recency_s
            with tel.span("swap.replay"):        # off-path bulk replay
                applied, stale = self._drain_into(bundle, min_ts=cutoff)
            t_flip = self._clock()
            # -- stall window: catch-up + flip + post-flip drain --------
            with tel.span("swap.catchup"):
                a2, s2 = self._drain_into(bundle, min_ts=cutoff)
            if self._pre_flip_hook is not None:
                self._pre_flip_hook()
            # a fault here aborts BEFORE the reference assignment: the
            # old bundle keeps serving in full, nothing is half-flipped
            self.faults.fire("swap.flip",
                             to_version=int(snapshot.version))
            with tel.span("swap.flip"):
                old = self.handle.flip(bundle)
            with tel.span("swap.post_drain"):
                a3, _ = self._drain_into(bundle)
            t1 = self._clock()
            tel.counter("swap.replayed_events", float(applied + a2 + a3))
            tel.counter("swap.postflip_events", float(a3))
            tel.counter("swap.dropped_stale", float(stale + s2))
            report = dict(
                from_version=float(old.version),
                to_version=float(bundle.version),
                replayed_events=float(applied + a2 + a3),
                dropped_stale=float(stale + s2),
                ring_dropped=float(self.ring_dropped),
                build_ms=(t_flip - t0) * 1e3,
                stall_ms=(t1 - t_flip) * 1e3,
                span_id=float(sp.span_id))   # join key into the trace
        self.swap_reports.append(report)
        return report
