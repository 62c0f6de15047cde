"""The port's host serving engine (``repro_torch.core.serving_host``)
against the JAX package's, bitwise: ``dedup_topk_rows``, the numpy U2I2I
union and ``HostQueueStore`` (rings, cursors, generations, retrieve and
serve rows, stats, telemetry) over the same streams, across seeds.

Then the concurrency contracts that ``tests/test_serving_concurrency.py``
pins on the JAX host store, on the port's: per-thread scratch pools,
concurrent readers, readers racing writers against a single-threaded
oracle, and the seqlock's retry and fallback paths with their counters.
"""
import threading
import time

import numpy as np
import pytest
import torch

from repro.core.serving import (HostQueueStore as JHost,
                                dedup_topk_rows as j_dedup,
                                u2i2i_retrieve_batch as j_u2i2i)
from repro.obs import FixedClock as JClock, Telemetry as JTel
from repro_torch.core.serving import (BufPool, ClusterQueueStore,
                                      HostQueueStore, ThreadLocalPools,
                                      dedup_topk_rows, u2i2i_retrieve_batch)
from repro_torch.core.serving_host import u2i2i_host
from repro_torch.obs import FixedClock, Telemetry

torch.set_num_threads(2)

N_USERS, N_CLUSTERS, N_ITEMS = 32, 6, 10      # tiny item space: dup-heavy
PROBES = np.array([0, 1, 1, 5, 17, 31, N_USERS, N_USERS + 9, -1])


def _batches(rng, n_batches, t0=0.0, span=10.0, id_hi=N_USERS + 4):
    """Batched stream with non-decreasing timestamps; ids past the table
    are post-snapshot users; empty batches occur."""
    out, t = [], t0
    for _ in range(n_batches):
        n = int(rng.integers(0, 40))
        u = rng.integers(0, id_hi, n)
        it = rng.integers(0, N_ITEMS, n)
        ts = t + np.sort(rng.random(n)) * span
        t += span
        out.append((u, it, ts))
    return out


# ---------------------------------------------------------------------------
# the row utilities, bitwise against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("item_hi", [50, 1 << 30])     # int32 / int64 keys
def test_dedup_topk_rows_matches_jax(seed, item_hi):
    rng = np.random.default_rng(seed)
    B, M = 17, 24
    cand = rng.integers(0, item_hi, (B, M))
    cand[:, ::3] = cand[:, :1]                     # duplicates in each row
    prio = np.stack([rng.permutation(M) for _ in range(B)])
    valid = rng.random((B, M)) < 0.7
    valid[0] = False                               # an all-invalid row
    for k in (1, 5, M, M + 7):
        got = dedup_topk_rows(cand, prio, valid, k, M)
        assert got.dtype == np.int64 and got.shape == (B, k)
        np.testing.assert_array_equal(got, j_dedup(cand, prio, valid, k, M))
    assert (dedup_topk_rows(cand, prio, valid, 4, M)[0] == -1).all()


@pytest.mark.parametrize("seed", range(3))
def test_u2i2i_host_matches_jax_and_the_port_union(seed):
    rng = np.random.default_rng(seed)
    n, K, B, R = 40, 5, 12, 6
    i2i = rng.integers(-1, n, (n, K))
    recent = rng.integers(-1, n + 4, (B, R))       # past the table, -1 pads
    for k in (3, 16, R * K + 2):
        got = u2i2i_host(i2i, recent, k)
        np.testing.assert_array_equal(got, j_u2i2i(i2i, recent, k))
        np.testing.assert_array_equal(got, u2i2i_retrieve_batch(
            torch.as_tensor(i2i), torch.as_tensor(recent), k).numpy())


# ---------------------------------------------------------------------------
# HostQueueStore, bitwise against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_host_store_matches_jax_host_store_bitwise(seed):
    rng = np.random.default_rng(seed)
    flat = rng.integers(0, N_CLUSTERS, N_USERS)
    flat[3] = -1                                   # an unassigned user
    i2i = rng.integers(0, N_ITEMS, (N_ITEMS, 3))
    port = HostQueueStore(flat, queue_len=8, recency_s=50.0,
                          telemetry=Telemetry(clock=FixedClock()))
    ref = JHost(flat, queue_len=8, recency_s=50.0,
                telemetry=JTel(clock=JClock()))
    for u, it, ts in _batches(rng, 7):
        port.ingest(u, it, ts)
        ref.ingest(u, it, ts)
        for a in ("items", "times", "cursor", "gen"):
            x, y = getattr(port, a), getattr(ref, a)
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y, err_msg=a)
        assert port.epoch == ref.epoch and port.stats() == ref.stats()
        t_end = float(ts[-1]) if ts.size else 70.0
        for now in (t_end, t_end + 25.0, t_end + 49.9, t_end + 200.0):
            for k in (4, 8):
                np.testing.assert_array_equal(
                    port.retrieve_batch(PROBES, now, k),
                    ref.retrieve_batch(PROBES, now, k))
            for s_p, s_r in zip(
                    port.serve_batch(PROBES, now, n_recent=3, k=6, i2i=i2i),
                    ref.serve_batch(PROBES, now, n_recent=3, k=6, i2i=i2i)):
                np.testing.assert_array_equal(s_p, s_r)
        assert port.retrieve(1, t_end, 8) == ref.retrieve(1, t_end, 8)
    sp, sr = port.tel.snapshot(), ref.tel.snapshot()
    assert sp["counters"] == sr["counters"] and sp["gauges"] == sr["gauges"]
    assert ({k: v["n"] for k, v in sp["hists"].items()}
            == {k: v["n"] for k, v in sr["hists"].items()})
    seeds, union = port.serve_batch(PROBES, 1e9, n_recent=3, k=6)
    assert (union == -1).all() and union.shape == (len(PROBES), 6)
    assert port.partitions() == (port,)


# ---------------------------------------------------------------------------
# per-thread reader pools
# ---------------------------------------------------------------------------

def test_thread_local_pools_are_per_thread():
    pools = ThreadLocalPools()
    main_pool = pools.get()
    assert pools.get() is main_pool           # stable within a thread
    assert isinstance(main_pool, BufPool)
    got = {}

    def grab(name):
        got[name] = pools.get()

    ths = [threading.Thread(target=grab, args=(i,)) for i in range(3)]
    for t in ths:
        t.start()
    for t in ths:
        t.join()
    pool_ids = {id(p) for p in got.values()} | {id(main_pool)}
    assert len(pool_ids) == 4                 # no sharing across threads


def test_buf_pool_reuses_a_buffer_until_its_shape_changes():
    pool = BufPool()
    a = pool.get("rows", (4, 8), np.int32)
    assert pool.get("rows", (4, 8), np.int32) is a
    assert pool.get("rows", (4, 8), np.int64) is not a
    assert pool.get("rows", (5, 8), np.int64).shape == (5, 8)


def _host(clusters, **kw):
    return HostQueueStore(clusters, **kw)


def _device_cpu(clusters, **kw):
    return ClusterQueueStore(clusters, device="cpu", **kw)


def _device_cpu_delta(clusters, **kw):
    return ClusterQueueStore(clusters, device="cpu", delta_cap=24, **kw)


STORES = dict(argvalues=[_host, _device_cpu, _device_cpu_delta],
              ids=["host", "device_store_on_cpu", "delta_store_on_cpu"])


@pytest.mark.parametrize("make", **STORES)
def test_concurrent_readers_match_single_thread_bitwise(make):
    """N reader threads over one store: every response identical to the
    single-threaded result (no scratch aliasing between threads)."""
    rng = np.random.default_rng(0)
    n_users, n_items, C = 200, 300, 16
    store = make(rng.integers(0, C, n_users), queue_len=32, recency_s=1e9)
    store.ingest(rng.integers(0, n_users, 3000),
                 rng.integers(0, n_items, 3000),
                 rng.integers(0, 1000, 3000).astype(float))
    batches = [rng.integers(0, n_users, 64) for _ in range(8)]
    want = [store.retrieve_batch(u, 1000.0, 16) for u in batches]
    errs = []

    def reader():
        try:
            for _ in range(10):
                for u, w in zip(batches, want):
                    np.testing.assert_array_equal(
                        store.retrieve_batch(u, 1000.0, 16), w)
        except Exception as e:                # surfaced after join
            errs.append(e)

    ths = [threading.Thread(target=reader) for _ in range(4)]
    for t in ths:
        t.start()
    for t in ths:
        t.join()
    assert not errs, errs


@pytest.mark.parametrize("make", **STORES)
def test_retrieve_during_concurrent_ingest_then_oracle(make):
    """Readers run lock-free while W writers ingest; once writers finish
    the store equals a single-threaded oracle bitwise.  Writers own
    disjoint clusters and emit increasing timestamps, so the slot order
    is the timestamp order however the threads interleave."""
    W, C, n_users, n_items = 2, 8, 64, 100
    clusters = np.arange(n_users) % C          # cluster % W == user % W
    store = make(clusters, queue_len=16, recency_s=1e9)
    per_writer = [[] for _ in range(W)]
    errs = []

    def writer(w):
        try:
            rng = np.random.default_rng(100 + w)
            for step in range(60):
                n = int(rng.integers(1, 12))
                u = rng.integers(0, n_users // W, n) * W + w
                it = rng.integers(0, n_items, n)
                ts = ((np.arange(n) + step * 32) * W + w).astype(float)
                per_writer[w].append((u, it, ts))
                store.ingest(u, it, ts)
        except Exception as e:
            errs.append(e)

    def reader():
        try:
            rng = np.random.default_rng(7)
            for _ in range(80):
                out = store.retrieve_batch(
                    rng.integers(0, n_users, 32), 1e6, 8)
                assert ((out == -1) | ((out >= 0) & (out < n_items))).all()
        except Exception as e:
            errs.append(e)

    ths = ([threading.Thread(target=writer, args=(w,)) for w in range(W)]
           + [threading.Thread(target=reader) for _ in range(2)])
    for t in ths:
        t.start()
    for t in ths:
        t.join()
    assert not errs, errs
    oracle = make(clusters, queue_len=16, recency_s=1e9)
    ev = [np.concatenate(x) for x in zip(
        *(e for w in per_writer for e in w))]
    order = np.argsort(ev[2], kind="stable")
    oracle.ingest(ev[0][order], ev[1][order], ev[2][order])
    users = np.arange(n_users)
    np.testing.assert_array_equal(store.retrieve_batch(users, 1e6, 16),
                                  oracle.retrieve_batch(users, 1e6, 16))
    np.testing.assert_array_equal(store.cursor, oracle.cursor)


# ---------------------------------------------------------------------------
# seqlock: retry and fallback paths, with their counters
# ---------------------------------------------------------------------------

def test_seqlock_fallback_under_writer_pressure():
    """The bounded-spin fallback returns a consistent result (forced via
    a zero spin budget)."""
    store = HostQueueStore(np.array([0, 1]), queue_len=8, recency_s=1e9)
    store.ingest(np.array([0, 1]), np.array([5, 6]), np.array([1.0, 2.0]))
    store._SEQLOCK_SPINS = 0  # always take the locked fallback
    assert store.retrieve(0, 10.0, 4) == [5]
    assert store.retrieve(1, 10.0, 4) == [6]


def test_seqlock_retry_counter_counts_gen_moves():
    """A read whose generations move underneath it retries exactly once
    and ticks ``serving.seqlock_retries``; the value comes from the
    consistent re-read."""
    tel = Telemetry()
    store = HostQueueStore(np.array([0]), queue_len=8, recency_s=1e9,
                           telemetry=tel)
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        if calls["n"] == 1:
            store.gen[0] += 2    # still even, but *moved*: torn read
        return calls["n"]

    assert store._seqlock_read(np.array([0]), fn) == 2
    counters = tel.snapshot()["counters"]
    assert counters["serving.seqlock_retries"] == 1.0
    assert "serving.seqlock_fallbacks" not in counters


def test_seqlock_odd_gen_exhausts_spins_then_falls_back():
    tel = Telemetry()
    store = HostQueueStore(np.array([0]), queue_len=8, recency_s=1e9,
                           telemetry=tel)
    store.gen[0] = 1                          # permanently mid-flight
    assert store._seqlock_read(np.array([0]), lambda: 9) == 9
    counters = tel.snapshot()["counters"]
    assert counters["serving.seqlock_retries"] == float(
        store._SEQLOCK_SPINS)
    assert counters["serving.seqlock_fallbacks"] == 1.0


def test_seqlock_fallback_counter_and_retrieve_metrics():
    tel = Telemetry()
    store = HostQueueStore(np.array([0, 1]), queue_len=8, recency_s=1e9,
                           telemetry=tel)
    store.ingest(np.array([0, 1]), np.array([5, 6]), np.array([1.0, 2.0]))
    store._SEQLOCK_SPINS = 0
    assert store.retrieve(0, 10.0, 4) == [5]
    snap = tel.snapshot()
    assert snap["counters"]["serving.seqlock_fallbacks"] == 1.0
    assert snap["counters"]["serving.retrieve_requests"] == 1.0
    assert "serving.seqlock_retries" not in snap["counters"]
    assert snap["counters"]["serving.ingest_events"] == 2.0
    assert snap["hists"]["serving.retrieve_latency_s"]["n"] == 1
    assert snap["gauges"]["serving.queue_depth_max"] == 1.0


def test_seqlock_counters_move_under_writer_racing_readers():
    """A writer holds every generation odd for a beat per iteration, so
    overlapping readers must retry or fall back; every request still
    completes and is counted."""
    tel = Telemetry()
    n_users, C = 64, 8
    store = HostQueueStore(np.arange(n_users) % C, queue_len=16,
                           recency_s=1e9, telemetry=tel)
    store.ingest(np.arange(n_users), np.arange(n_users),
                 np.arange(n_users, dtype=float))
    stop = threading.Event()
    errs = []

    def writer():
        try:
            while not stop.is_set():
                with store.write_lock:
                    store.gen += 1            # enter: odd, readers spin
                    time.sleep(2e-4)
                    store.gen += 1            # exit: even again
                time.sleep(0)                 # let readers through
        except Exception as e:                # pragma: no cover
            errs.append(e)

    def reader():
        try:
            users = np.arange(n_users)
            for _ in range(150):
                out = store.retrieve_batch(users, 1e6, 8)
                assert out.shape == (n_users, 8)
        except Exception as e:                # pragma: no cover
            errs.append(e)

    wt = threading.Thread(target=writer)
    rts = [threading.Thread(target=reader) for _ in range(2)]
    wt.start()
    for t in rts:
        t.start()
    for t in rts:
        t.join()
    stop.set()
    wt.join()
    assert not errs, errs
    counters = tel.snapshot()["counters"]
    assert counters["serving.retrieve_requests"] == 300.0
    assert counters.get("serving.seqlock_retries", 0.0) > 0.0
    assert tel.snapshot()["hists"]["serving.retrieve_latency_s"]["n"] == 300
