"""Serving scale-out in the port: the delta-run ingest and the sharded
router (``repro_torch.core.serving``), through the swap server and the
runtime, against the JAX package.

Mirrors ``tests/test_serving_device.py``; every parity test holds the
port's store against two references on the same stream: JAX's device
store in the same mode (``ClusterQueueStore`` or ``ShardedQueueStore``
with the same ``delta_cap``) and JAX's ``HostQueueStore``.  For
non-decreasing-timestamp streams the contract is bitwise equality across
seeds, ring wraps, dup-heavy streams, unknown and post-snapshot user
ids, recency-cutoff edges and empty queues.  The one documented
tolerance (the device stores dedup at ingest, the host store at
retrieve) is pinned to its exact window, as in the reference.

The port's shards sit on ``devices=["cpu", "cpu"]`` where the reference
takes a mesh.  Then a sharded delta-mode ``SwapServer`` and a zero-step
sharded ``run_cycle`` against JAX's.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.serving import (ClusterQueueStore as JStore,
                                HostQueueStore as JHost,
                                ServingCostModel as JCost,
                                ShardedQueueStore as JSharded)
from repro.obs import FixedClock as JClock, Telemetry as JTel
from repro_torch.core.serving import (ClusterQueueStore, HostQueueStore,
                                      ServingCostModel, ShardedQueueStore,
                                      u2i2i_retrieve, u2i2i_retrieve_batch)
from repro_torch.lifecycle.swap import SwapServer
from repro_torch.obs import FixedClock, Telemetry
from test_torch_lifecycle import (_both_runtimes, _control_flow,  # noqa: F401
                                  _mk_snapshot, _observed, jax_world)

torch.set_num_threads(2)

N_USERS, N_CLUSTERS, N_ITEMS = 32, 6, 10      # tiny item space: dup-heavy
CPU2 = ["cpu", "cpu"]
# probe users: known, repeated, never-ingested clusters, post-snapshot
# ids, and a negative id
PROBES = np.array([0, 1, 1, 5, 17, 31, N_USERS, N_USERS + 9, -1])


def _clusters(rng):
    return rng.integers(0, N_CLUSTERS, N_USERS).astype(np.int64)


def _batches(rng, n_batches, t0=0.0, span=10.0, id_hi=N_USERS + 4):
    out, t = [], t0
    for _ in range(n_batches):
        n = int(rng.integers(0, 40))          # 0 => empty-batch edge
        u = rng.integers(0, id_hi, n)
        it = rng.integers(0, N_ITEMS, n)
        ts = t + np.sort(rng.random(n)) * span
        t += span
        out.append((u, it, ts))
    return out


def _stores(flat, *, n_shards=1, delta_cap=0, queue_len=8, recency_s=50.0):
    """(the port's store, JAX's device store in the same mode, JAX's host
    store) over one assignment table."""
    kw = dict(queue_len=queue_len, recency_s=recency_s, delta_cap=delta_cap)
    if n_shards > 1:
        port = ShardedQueueStore(flat, n_shards=n_shards, devices=CPU2, **kw)
        jdev = JSharded(flat, n_shards=n_shards, **kw)
    else:
        port = ClusterQueueStore(flat, device="cpu", **kw)
        jdev = JStore(flat, **kw)
    return port, jdev, JHost(flat, queue_len=queue_len, recency_s=recency_s)


def _assert_parity(port, refs, now, ks=(4, 8)):
    for k in ks:
        got = port.retrieve_batch(PROBES, now, k)
        for ref in refs:
            np.testing.assert_array_equal(got,
                                          ref.retrieve_batch(PROBES, now, k))
    for ref in refs:
        np.testing.assert_array_equal(port.cursor, ref.cursor)


def _run_stream_parity(port, refs, rng):
    """Ingest the same stream into every store, checking parity after
    every batch at recency-edge ``now`` values (cutoff before, inside,
    and after the retained window)."""
    for u, it, ts in _batches(rng, 7):
        for s in (port, *refs):
            s.ingest(u, it, ts)
        t_end = float(ts[-1]) if ts.size else 70.0
        for now in (t_end, t_end + 25.0, t_end + 49.9, t_end + 200.0):
            _assert_parity(port, refs, now)


@pytest.mark.parametrize("seed", range(4))
def test_direct_mode_matches_jax_and_host_bitwise(seed):
    rng = np.random.default_rng(seed)
    port, jdev, host = _stores(_clusters(rng))
    _run_stream_parity(port, (jdev, host), rng)


@pytest.mark.parametrize("seed", range(3))
def test_delta_mode_matches_jax_and_host_bitwise(seed):
    """A small ``delta_cap`` forces mid-stream folds; reads that see a
    part-filled delta run match both references."""
    rng = np.random.default_rng(100 + seed)
    port, jdev, host = _stores(_clusters(rng), delta_cap=16)
    _run_stream_parity(port, (jdev, host), rng)
    assert port.d_count == jdev.d_count
    assert port.stats() == jdev.stats()


@pytest.mark.parametrize("delta_cap", [0, 16])
@pytest.mark.parametrize("seed", range(3))
def test_sharded_router_matches_jax_and_host_bitwise(seed, delta_cap):
    """3 shards over 6 clusters: scatter-ingest and gather-merge retrieve
    are transparent, bitwise equal to JAX's sharded store and to the
    unsharded host store."""
    rng = np.random.default_rng(200 + seed)
    port, jdev, host = _stores(_clusters(rng), n_shards=3,
                               delta_cap=delta_cap)
    assert len(port.partitions()) == 3
    _run_stream_parity(port, (jdev, host), rng)
    assert port.stats() == jdev.stats()
    np.testing.assert_array_equal(port.items, jdev.items)
    np.testing.assert_array_equal(port.times, jdev.times)


@pytest.mark.parametrize("n_shards,delta_cap", [(1, 0), (1, 16), (3, 16)])
def test_empty_store_unknown_users_and_retrieve_list_api(n_shards,
                                                         delta_cap):
    flat = _clusters(np.random.default_rng(0))
    port, jdev, host = _stores(flat, n_shards=n_shards, delta_cap=delta_cap)
    # nothing ingested: every row is all -1 in every store
    _assert_parity(port, (jdev, host), now=10.0)
    assert (port.retrieve_batch(PROBES, 10.0, 4) == -1).all()
    for s in (port, jdev, host):
        s.ingest(np.array([0]), np.array([3]), np.array([1.0]))
    assert port.retrieve(0, 2.0, 4) == host.retrieve(0, 2.0, 4) \
        == jdev.retrieve(0, 2.0, 4) == [3]
    assert port.retrieve(N_USERS + 1, 2.0, 4) == []   # post-snapshot id


@pytest.mark.parametrize("n_shards,delta_cap", [(1, 0), (1, 16), (2, 16)])
def test_ts_regression_cross_batch_is_the_documented_tolerance(n_shards,
                                                               delta_cap):
    """The one permitted divergence from the host store, pinned to its
    window: a duplicate re-ingested in a later batch with an older
    timestamp.  The device stores keep the re-ingested (older) stamp, the
    host store the newest; they disagree iff the cutoff lands between
    the two.  The port and JAX's device store agree throughout."""
    flat = np.zeros(1, np.int64)
    port, jdev, host = _stores(flat, n_shards=n_shards, delta_cap=delta_cap)
    for s in (port, jdev, host):
        s.ingest(np.array([0]), np.array([7]), np.array([10.0]))
        s.ingest(np.array([0]), np.array([7]), np.array([5.0]))  # older!
    u = np.array([0])
    for now in (54.0, 57.0, 61.0):
        np.testing.assert_array_equal(port.retrieve_batch(u, now, 4),
                                      jdev.retrieve_batch(u, now, 4))
    # cutoff below both stamps (now=54 -> cutoff 4): both return it
    np.testing.assert_array_equal(port.retrieve_batch(u, 54.0, 4),
                                  host.retrieve_batch(u, 54.0, 4))
    # cutoff between the stamps (now=57 -> cutoff 7): the divergence
    assert host.retrieve_batch(u, 57.0, 4)[0, 0] == 7
    assert (port.retrieve_batch(u, 57.0, 4) == -1).all()
    # cutoff above both (now=61 -> cutoff 11): both empty again
    np.testing.assert_array_equal(port.retrieve_batch(u, 61.0, 4),
                                  host.retrieve_batch(u, 61.0, 4))


def _ingest_all(stores, rng, n_batches=5):
    for u, it, ts in _batches(rng, n_batches):
        for s in stores:
            s.ingest(u, it, ts)


@pytest.mark.parametrize("n_shards,delta_cap",
                         [(1, 0), (1, 16), (2, 0), (2, 16)])
def test_fused_serve_matches_jax_and_host_u2i2i(n_shards, delta_cap):
    """The port's serve (one ``queue_gather`` call a shard) equals JAX's
    single-dispatch serve (which scans delta-then-ring without folding)
    and the host's two-step path, bitwise."""
    rng = np.random.default_rng(7)
    port, jdev, host = _stores(_clusters(rng), n_shards=n_shards,
                               delta_cap=delta_cap, recency_s=1e9)
    _ingest_all((port, jdev, host), rng)
    i2i = rng.integers(0, N_ITEMS, (N_ITEMS, 3)).astype(np.int64)
    hs, hu = host.serve_batch(PROBES, 100.0, n_recent=4, k=8, i2i=i2i)
    js, ju = jdev.serve_batch(PROBES, 100.0, n_recent=4, k=8, i2i=i2i)
    seeds, union = port.serve_batch(PROBES, 100.0, n_recent=4, k=8, i2i=i2i)
    for a, b in ((seeds, hs), (union, hu), (seeds, js), (union, ju)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(union, u2i2i_retrieve_batch(
        torch.as_tensor(i2i), torch.as_tensor(seeds), 8).numpy())
    for row in (0, 4):
        assert u2i2i_retrieve(i2i, seeds[row], 8, device="cpu") == \
            [int(x) for x in union[row] if x >= 0]
    # no i2i table: seeds only, union all -1
    seeds, union = port.serve_batch(PROBES, 100.0, n_recent=4, k=8)
    np.testing.assert_array_equal(seeds, hs)
    assert (union == -1).all()


def test_delta_serve_folds_first_like_the_jax_kernel_path():
    """With an I2I table the port's delta store folds, then runs
    ``queue_gather`` on the ring, as the JAX store's ``use_kernel`` path
    does: both paths of the reference and the port give the same rows,
    and the fold leaves nothing pending."""
    rng = np.random.default_rng(9)
    flat = _clusters(rng)
    port, jdev, _ = _stores(flat, delta_cap=16, recency_s=1e9)
    jker = JStore(flat, queue_len=8, recency_s=1e9, delta_cap=16)
    _ingest_all((port, jdev, jker), rng)
    assert port.d_count == jdev.d_count > 0
    i2i = rng.integers(0, N_ITEMS, (N_ITEMS, 3)).astype(np.int64)
    s0, u0 = jdev.serve_batch(PROBES, 100.0, n_recent=4, k=8, i2i=i2i)
    s1, u1 = jker.serve_batch(PROBES, 100.0, n_recent=4, k=8, i2i=i2i,
                              use_kernel=True)
    s2, u2 = port.serve_batch(PROBES, 100.0, n_recent=4, k=8, i2i=i2i)
    for a, b in ((s0, s1), (u0, u1), (s0, s2), (u0, u2)):
        np.testing.assert_array_equal(a, b)
    assert port.d_count == 0 == jker.d_count and jdev.d_count > 0
    assert port.folds > 0
    assert port.stats()["delta_pending"] == 0.0
    np.testing.assert_array_equal(port.items, jker.items)
    np.testing.assert_array_equal(port.times, jker.times)


@pytest.mark.parametrize("delta_cap", [4, 16])
def test_fold_counter_counts_folds_of_a_non_empty_run(delta_cap):
    """``folds`` counts the folds that move a pending run into the ring:
    one each time ingest finds the run full, one at the fold a serve or
    ``items`` makes, none when nothing is pending."""
    rng = np.random.default_rng(11)
    port, _, _ = _stores(_clusters(rng), delta_cap=delta_cap)
    n = 0
    for u, it, ts in _batches(rng, 6, id_hi=N_USERS):
        port.ingest(u, it, ts)
        n += u.size
    full = max(-(-n // delta_cap) - 1, 0)
    assert port.folds == full and port.d_count == n - full * delta_cap
    port.items
    port._fold()
    assert port.folds == full + (n > full * delta_cap) and port.d_count == 0


def test_u2i2i_retrieve_runs_on_cuda_unless_asked():
    """The single-request union copies the table to ``device``; with no
    device it asks for CUDA, which raises where there is none."""
    i2i = np.array([[1, 2], [0, 2], [0, 1]], np.int64)
    assert u2i2i_retrieve(i2i, [0], 3, device="cpu") == [1, 2]
    assert u2i2i_retrieve(torch.as_tensor(i2i), [2, 0], 3,
                          device="cpu") == [1]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            u2i2i_retrieve(i2i, [0], 3)


# ---------------------------------------------------------------------------
# stats, telemetry, cost model, placement
# ---------------------------------------------------------------------------

def test_stats_per_shard_and_delta_pending():
    rng = np.random.default_rng(3)
    flat = _clusters(rng)
    shd, jshd, _ = _stores(flat, n_shards=3, delta_cap=64, recency_s=1e9)
    _ingest_all((shd, jshd), rng, n_batches=3)
    st = shd.stats()
    assert st == jshd.stats()
    assert st["n_shards"] == 3.0
    for s in range(3):
        assert f"shard{s}.n_clusters_active" in st
        assert f"shard{s}.mean_queue" in st
    assert sum(st[f"shard{s}.n_clusters_active"] for s in range(3)) \
        == st["n_clusters_active"]
    # folding drains the pending delta
    pending = [p.stats()["delta_pending"] for p in shd.partitions()]
    for p in shd.partitions():
        p._fold()
    assert any(x > 0 for x in pending) or shd.cursor.sum() == 0
    assert all(p.stats()["delta_pending"] == 0.0
               for p in shd.partitions())


def test_sharded_telemetry_tagged_counters_and_gauges():
    """Shards emit ``.shardN``-tagged metrics, the facade the untagged
    aggregates: the same counters and gauges as JAX's sharded store, and
    the tagged ingest counts sum to the aggregate."""
    rng = np.random.default_rng(5)
    flat = _clusters(rng)
    tel, jtel = Telemetry(clock=FixedClock()), JTel(clock=JClock())
    shd = ShardedQueueStore(flat, n_shards=2, queue_len=8, recency_s=1e9,
                            telemetry=tel, devices=CPU2)
    jshd = JSharded(flat, n_shards=2, queue_len=8, recency_s=1e9,
                    telemetry=jtel)
    u = rng.integers(0, N_USERS + 3, 64)
    it = rng.integers(0, N_ITEMS, 64)
    ts = np.sort(rng.random(64) * 10.0)
    for s in (shd, jshd):
        s.ingest(u, it, ts)
        s.retrieve_batch(np.arange(-1, 9), 20.0, 4)
    snap, jsnap = tel.snapshot(), jtel.snapshot()
    c, g = snap["counters"], snap["gauges"]
    assert c == jsnap["counters"] and g == jsnap["gauges"]
    assert ({k: v["n"] for k, v in snap["hists"].items()}
            == {k: v["n"] for k, v in jsnap["hists"].items()})
    n_known = c["serving.ingest_events"]
    assert (c.get("serving.ingest_events.shard0", 0.0)
            + c.get("serving.ingest_events.shard1", 0.0)) == n_known
    assert c["serving.retrieve_requests"] == 1.0
    assert "serving.queue_depth_max" in g
    for s in range(2):
        if c.get(f"serving.ingest_events.shard{s}", 0.0):
            assert f"serving.queue_depth_max.shard{s}" in g
    assert snap["hists"]["serving.retrieve_latency_s"].get("n", 0) >= 1


def test_cost_model_shard_and_batch_scaling():
    """Launch overheads scale with the shard count and amortize with the
    dispatch batch; per-request queue work does neither.  Every figure
    equals the JAX package's model."""
    one = ServingCostModel(batch_size=1, n_shards=1)
    four = ServingCostModel(batch_size=1, n_shards=4)
    per_req_bytes = 8.0 * one.queue_read_items + 8.0
    assert four.cluster_bytes_per_req() - per_req_bytes \
        == pytest.approx(4 * (one.cluster_bytes_per_req()
                              - per_req_bytes))
    assert four.cluster_flops_per_req() > one.cluster_flops_per_req()
    assert four.cluster_bytes_per_req(batch_size=256) \
        < one.cluster_bytes_per_req(batch_size=1)
    assert four.cost_reduction(batch_size=256) \
        > four.cost_reduction(batch_size=1)
    assert one.cost_reduction(batch_size=256) > 0.99
    for kw in (dict(), dict(n_shards=4, batch_size=512),
               dict(d=128, active_pool=10_000, qps=5e4, n_probe_frac=0.2)):
        p, j = ServingCostModel(**kw), JCost(**kw)
        for b in (None, 1, 4096):
            assert p.cluster_bytes_per_req(b) == j.cluster_bytes_per_req(b)
            assert p.cluster_flops_per_req(b) == j.cluster_flops_per_req(b)
            assert p.cost_reduction(b) == j.cost_reduction(b)
        for exact in (False, True):
            assert p.knn_flops_per_req(exact) == j.knn_flops_per_req(exact)
            assert p.knn_bytes_per_req(exact) == j.knn_bytes_per_req(exact)


def test_devices_placement_smoke():
    """``devices=`` places shards round-robin over its entries (the
    reference's mesh placement); answers are unchanged, and with no
    devices the shards take the default device, CUDA, which raises
    where there is none."""
    rng = np.random.default_rng(13)
    flat = _clusters(rng)
    shd = ShardedQueueStore(flat, n_shards=3, queue_len=8, recency_s=1e9,
                            devices=[torch.device("cpu"), "cpu"])
    host = HostQueueStore(flat, queue_len=8, recency_s=1e9)
    _ingest_all((shd, host), rng, n_batches=3)
    np.testing.assert_array_equal(shd.retrieve_batch(PROBES, 100.0, 8),
                                  host.retrieve_batch(PROBES, 100.0, 8))
    for p in shd.partitions():
        assert p.device == torch.device("cpu")
        assert all(t.device == p.device for t in p._state.values())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ShardedQueueStore(flat, n_shards=2)


# ---------------------------------------------------------------------------
# the swap server and the runtime, sharded and in delta mode
# ---------------------------------------------------------------------------

def test_sharded_delta_swap_server_matches_jax():
    """``SwapServer(n_shards=3, delta_cap=16)`` in both packages: the same
    events and flips give the same swap accounting and the same served
    rows, retrieve and serve, before and after each swap."""
    from repro.lifecycle.snapshot import IndexSnapshot as JSnap
    from repro.lifecycle.swap import SwapServer as JServer
    rng = np.random.default_rng(6)
    snaps = [_mk_snapshot(rng, v, 30, 20, flip=v % 2) for v in (1, 2, 3)]
    ev = (rng.integers(0, 33, 700), rng.integers(0, 20, 700),
          np.sort(rng.random(700) * 100.0))
    later = (rng.integers(0, 30, 90), rng.integers(0, 20, 90),
             100.0 + np.sort(rng.random(90) * 10.0))
    users = np.arange(-1, 33)
    out = []
    for mk, make_server in (
            (lambda s: JSnap(**dataclasses.asdict(s)),
             lambda s: JServer(s, queue_len=16, recency_s=40.0,
                               ring_capacity=512, n_shards=3,
                               delta_cap=16)),
            (lambda s: s,
             lambda s: SwapServer(s, queue_len=16, recency_s=40.0,
                                  ring_capacity=512, n_shards=3,
                                  delta_cap=16, device="cpu"))):
        server = make_server(mk(snaps[0]))
        got = []
        server.ingest(*ev)
        got.append(server.serve_batch(users, 100.0, n_recent=4, k=8))
        for snap, now in ((snaps[1], 100.0), (snaps[2], 110.0)):
            rep = server.swap_to(mk(snap), now=now)
            got.append({k: v for k, v in rep.items()
                        if k not in ("build_ms", "stall_ms", "span_id")})
            server.ingest(*later)
            # before the serve: the port's serve folds the delta run
            got.append(server.handle.acquire().store.stats())
            got.append(server.retrieve_batch(users, now, 6))
            got.append(server.serve_batch(users, now, n_recent=4, k=8))
        got.append(server.ring_dropped)
        out.append(got)
    assert len(out[0]) == len(out[1])
    for a, b in zip(*out):
        if isinstance(a, tuple):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                if isinstance(x, np.ndarray):
                    np.testing.assert_array_equal(x, y)
                else:
                    assert x == y
        else:
            assert a == b
    rep = out[1][1]
    assert rep["replayed_events"] + rep["dropped_stale"] == 512
    assert out[1][2]["n_shards"] == 3 and out[1][2]["delta_pending"] > 0


def test_zero_step_sharded_cycle_matches_jax(jax_world, tiny_world,
                                             tiny_cfg):
    """With ``n_shards=2`` and ``serving_delta_cap=16``, zero-step cycles
    from the JAX initial state publish the same snapshot, bring serving
    up and swap the same way in both runtimes; the live traffic between
    them is served the same, with the same counters (the ``.shard{i}``
    series included) and spans."""
    pair = _both_runtimes(jax_world, tiny_world, tiny_cfg, [], n_shards=2,
                          serving_delta_cap=16)
    rng = np.random.default_rng(21)
    n_users = tiny_world.n_users
    ev = (rng.integers(0, n_users + 2, 300), rng.integers(0, 400, 300),
          86400.0 + np.sort(rng.random(300) * 3000.0))
    users = np.arange(-1, n_users + 2)
    got = []
    for rt, tel, sink in pair:
        reps = [rt.run_cycle(now=86400.0)]
        rt.server.ingest(*ev)
        rows = [rt.server.serve_batch(users, 89500.0, n_recent=4, k=8)]
        reps.append(rt.run_cycle(now=90000.0))
        rows.append(rt.server.serve_batch(users, 90000.0, n_recent=4, k=8))
        rows.append(rt.server.retrieve_batch(users, 90000.0, 6))
        parts = rt.server.handle.acquire().store.partitions()
        got.append((reps, rows, _observed(rt, tel, sink), len(parts)))
    (jreps, jrows, jobs, jn), (preps, prows, pobs, pn) = got
    assert pn == jn == 2
    for jr, pr in zip(jreps, preps):
        assert _control_flow(pr) == _control_flow(jr)
        assert pr["publish"] == jr["publish"]
    assert preps[1]["swap"]["replayed_events"] > 0
    for jr, pr in zip(jrows, prows):
        for a, b in zip(jr, pr):
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(b, a)
            else:
                assert a == b
    assert pobs == jobs
    assert "serving.ingest_events.shard1" in pobs["counters"]
