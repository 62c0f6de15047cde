"""The port's lifecycle (``repro_torch.lifecycle``: snapshot store, swap
server, runtime) on the CPU, against the JAX package's on the shared tiny
world (``tests/conftest.py``).

The first half mirrors ``tests/test_lifecycle.py`` on the port alone:
the snapshot store, the unknown-user guard, the event ring, swap
atomicity under interleaved flips, queue re-keying, the gate, the
self-healing repair burst, stage retries, rollback, crash recovery.

The second half holds the two packages against each other:

  * a snapshot either package wrote loads in the other, every leaf
    bitwise, and a corrupted leaf raises in both;
  * ``_backoff_s`` gives the same retry schedule;
  * the same ``FaultPlan`` gives the same control flow: the report's
    swap fields, versions and ``stale_cycles``, every counter and gauge,
    the histograms' counts, and the spans' names, attributes and
    parentage (both start from the JAX initial state, with zero-step
    bursts, so their snapshots agree);
  * with the JAX initial state copied in and ``steps_per_cycle=0``, both
    publish the same snapshot (codes, clusters, members, I2I) and the
    same gate metrics, bitwise.
"""
import dataclasses
import json
import os
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs.base import RankGraph2Config, RQConfig
from repro_torch.core.serving import ClusterQueueStore, u2i2i_retrieve_batch
from repro_torch.lifecycle.snapshot import (IndexSnapshot, SnapshotStore,
                                            derive_members)
from repro_torch.lifecycle.swap import (EventRing, ServingBundle,
                                        SnapshotHandle, SwapServer)

torch.set_num_threads(2)

FIELDS = ("user_codes", "item_codes", "user_clusters", "member_ptr",
          "member_ids", "coarse_codebook", "i2i")


def port_cfg(jcfg) -> RankGraph2Config:
    d = dataclasses.asdict(jcfg)
    d["rq"] = RQConfig(**d["rq"])
    return RankGraph2Config(**d)


def _trace(sink):
    return [json.loads(ln) for ln in sink.lines]


# ---------------------------------------------------------------------------
# snapshot store
# ---------------------------------------------------------------------------

def _random_snapshot(rng, version=1, n_users=40, n_items=30,
                     sizes=(4, 2), d=8, k=5, cls=IndexSnapshot):
    n_clusters = int(np.prod(sizes))
    flat = rng.integers(0, n_clusters, n_users).astype(np.int64)
    ptr, ids = derive_members(flat, n_clusters)
    codes = np.stack([flat // sizes[1], flat % sizes[1]],
                     axis=1).astype(np.int32)
    return cls(
        user_codes=codes,
        item_codes=rng.integers(0, sizes[0], (n_items, 2)).astype(np.int32),
        user_clusters=flat, member_ptr=ptr, member_ids=ids,
        coarse_codebook=rng.normal(size=(sizes[0], d)).astype(np.float32),
        i2i=rng.integers(-1, n_items, (n_items, k)).astype(np.int64),
        version=version, n_users=n_users, n_items=n_items,
        codebook_sizes=sizes,
        gate_metrics=(("recall_ratio", 0.93),))


def _assert_same_snapshot(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    for f in ("version", "n_users", "n_items", "codebook_sizes",
              "gate_metrics"):
        assert getattr(a, f) == getattr(b, f), f


def test_index_snapshot_store_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    store = SnapshotStore(str(tmp_path), keep=2)
    snap = _random_snapshot(rng, version=3)
    store.publish(snap)
    back = store.load()
    assert back.version == 3 and back.codebook_sizes == (4, 2)
    assert back.metrics == {"recall_ratio": 0.93}
    _assert_same_snapshot(snap, back)
    for v in (4, 5, 6):
        store.publish(_random_snapshot(rng, version=v))
    assert store.versions() == [5, 6]
    assert store.latest_version() == 6
    assert store.load(5).version == 5


def test_snapshot_store_rejects_non_snapshot_dir(tmp_path):
    from repro_torch.checkpoint import Checkpointer
    Checkpointer(str(tmp_path)).save(1, {"w": torch.zeros(3)})
    with pytest.raises(ValueError, match="index snapshot"):
        SnapshotStore(str(tmp_path)).load()


def test_derive_members_and_coarse_members():
    rng = np.random.default_rng(8)
    snap = _random_snapshot(rng)
    for c in range(snap.n_clusters):
        np.testing.assert_array_equal(
            np.sort(snap.members_of(c)), np.flatnonzero(snap.user_clusters
                                                        == c))
    for k0 in range(snap.codebook_sizes[0]):
        np.testing.assert_array_equal(
            np.sort(snap.coarse_members(k0)),
            np.flatnonzero(snap.user_codes[:, 0] == k0))


# ---------------------------------------------------------------------------
# serving guard: users minted after the snapshot
# ---------------------------------------------------------------------------

def test_store_unknown_user_guard():
    store = ClusterQueueStore(np.array([0, 1, 0]), queue_len=8,
                              recency_s=1e9, device="cpu")
    store.ingest(np.array([0, 7, 1]), np.array([10, 11, 12]),
                 np.array([1.0, 2.0, 3.0]))
    assert store.retrieve(0, 3.0, 4) == [10]
    assert store.retrieve(1, 3.0, 4) == [12]
    out = store.retrieve_batch(np.array([0, 7, -2]), 3.0, 4)
    assert out[0].tolist()[0] == 10
    assert (out[1] == -1).all() and (out[2] == -1).all()
    i2i = np.array([[1, 2]] * 13)
    s, u = store.serve_batch(np.array([0, 7]), 3.0, n_recent=2, k=2,
                             i2i=i2i)
    assert (s[1] == -1).all() and (u[1] == -1).all()
    assert s[0, 0] == 10
    assert store.partitions() == (store,)
    assert store.stats()["n_shards"] == 1 and store.ring_seen == 0


def test_store_telemetry_matches_jax_store():
    """The same ingest and requests report the same ``serving.*``
    counters, gauges and histogram counts in both stores."""
    from repro.core.serving import ClusterQueueStore as JaxStore
    from repro.obs import FixedClock as JClock, Telemetry as JTel
    from repro_torch.obs import FixedClock, Telemetry
    rng = np.random.default_rng(3)
    uc = rng.integers(0, 6, 20)
    uc[3] = -1
    ev = (rng.integers(0, 24, 200), rng.integers(0, 30, 200),
          np.sort(rng.random(200) * 50.0))
    i2i = rng.integers(0, 30, (30, 4))
    out = []
    for store in (JaxStore(uc, queue_len=8, recency_s=1e9, n_clusters=6,
                           telemetry=JTel(clock=JClock())),
                  ClusterQueueStore(uc, queue_len=8, recency_s=1e9,
                                    n_clusters=6, device="cpu",
                                    telemetry=Telemetry(clock=FixedClock()))):
        store.ingest(*ev)
        users = np.arange(-2, 24)
        r = store.retrieve_batch(users, 50.0, 5)
        s, u = store.serve_batch(users, 50.0, n_recent=3, k=6, i2i=i2i)
        snap = store.tel.snapshot()
        hists = {k: v["n"] for k, v in snap["hists"].items()}
        out.append((r, s, u, snap["counters"], snap["gauges"], hists))
    for a, b in zip(*out):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b
    assert out[1][3]["serving.unknown_user_requests"] == 2 * 7.0


def test_delta_cap_and_shards_name_the_roadmap_item():
    with pytest.raises(NotImplementedError, match="queue 1 item 5"):
        ClusterQueueStore(np.zeros(3, np.int64), delta_cap=64, device="cpu")
    snap = _random_snapshot(np.random.default_rng(0))
    with pytest.raises(NotImplementedError, match="queue 1 item 5"):
        SwapServer(snap, n_shards=2, device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 5"):
        SwapServer(snap, delta_cap=8, device="cpu")


# ---------------------------------------------------------------------------
# swap engine: event ring, handle, atomicity
# ---------------------------------------------------------------------------

def test_event_ring_window_and_wrap():
    ring = EventRing(capacity=8)
    ring.push(np.arange(5), np.arange(5) + 100, np.arange(5, dtype=float))
    u, i, t, seen = ring.window_since(0, -1.0)
    assert u.tolist() == [0, 1, 2, 3, 4] and seen == 5
    ring.push(np.arange(6), np.arange(6) + 200, np.arange(6, dtype=float))
    u, i, t, seen = ring.window_since(0, -1.0)      # capacity clamps
    assert len(u) == 8 and seen == 11
    assert i.tolist()[-6:] == [200, 201, 202, 203, 204, 205]
    u, i, t, _ = ring.window_since(0, 3.0)
    assert (t >= 3.0).all()
    u, i, t, seen2 = ring.window_since(seen, -1.0)
    assert len(u) == 0 and seen2 == seen
    assert ring.push(np.arange(11), np.arange(11), np.zeros(11)) == 3


def _mk_snapshot(rng, version, n_users, n_items, flip):
    """Two snapshot families with disjoint cluster layouts + i2i tables
    so any cross-version mixing is detectable in the output."""
    sizes = (4, 2)
    n_clusters = 8
    flat = ((np.arange(n_users) + (3 * flip)) % n_clusters).astype(np.int64)
    ptr, ids = derive_members(flat, n_clusters)
    codes = np.stack([flat // 2, flat % 2], axis=1).astype(np.int32)
    i2i = ((np.arange(n_items)[:, None] + 1 + flip * 7)
           % n_items).astype(np.int64).repeat(3, axis=1)
    i2i[:, 1] = (i2i[:, 1] + 1 + flip) % n_items
    i2i[:, 2] = (i2i[:, 2] + 3 + flip) % n_items
    return IndexSnapshot(
        user_codes=codes, item_codes=np.zeros((n_items, 2), np.int32),
        user_clusters=flat, member_ptr=ptr, member_ids=ids,
        coarse_codebook=np.zeros((4, 4), np.float32), i2i=i2i,
        version=version, n_users=n_users, n_items=n_items,
        codebook_sizes=sizes)


def test_swap_atomicity_under_interleaved_flips():
    """Interleave retrieve/serve with a background flip storm: every
    response must be bit-equal to the output of exactly the version it
    reports — never a mix of two snapshots' stores/i2i tables."""
    n_users, n_items, n_ev = 60, 40, 3000
    rng = np.random.default_rng(0)
    ev = (rng.integers(0, n_users, n_ev), rng.integers(0, n_items, n_ev),
          np.sort(rng.random(n_ev) * 1000.0))
    snap_a = _mk_snapshot(rng, 1, n_users, n_items, flip=0)
    snap_b = _mk_snapshot(rng, 2, n_users, n_items, flip=1)
    server = SwapServer(snap_a, queue_len=32, recency_s=1e9,
                        ring_capacity=1 << 13, device="cpu")
    server.ingest(*ev)
    now = 1000.0
    expected = {}
    for snap in (snap_a, snap_b):
        st = ClusterQueueStore(snap.user_clusters, queue_len=32,
                               recency_s=1e9, n_clusters=snap.n_clusters,
                               device="cpu")
        st.ingest(*ev)
        expected[snap.version] = (st, snap.i2i)

    users = rng.integers(0, n_users, 64)
    stop = threading.Event()
    flips = dict(n=0)

    def flipper():
        v = 2
        while not stop.is_set():
            snap = snap_b if v % 2 == 0 else snap_a
            server.swap_to(snap, now)
            flips["n"] += 1
            v += 1

    th = threading.Thread(target=flipper, daemon=True)
    th.start()
    try:
        for _ in range(60):
            res, ver = server.retrieve_batch(users, now, 16)
            st, _ = expected[ver]
            np.testing.assert_array_equal(
                res, st.retrieve_batch(users, now, 16))
            seeds, union, ver2 = server.serve_batch(users[:16], now,
                                                    n_recent=4, k=8)
            st, i2i = expected[ver2]
            es = st.retrieve_batch(users[:16], now, 4)
            np.testing.assert_array_equal(seeds, es)
            np.testing.assert_array_equal(union, u2i2i_retrieve_batch(
                torch.as_tensor(i2i), torch.as_tensor(es), 8).numpy())
    finally:
        stop.set()
        th.join(timeout=10)
    assert flips["n"] > 0


def test_swap_rekeys_queues_to_new_clusters():
    rng = np.random.default_rng(4)
    n_users, n_items = 30, 20
    snap_a = _mk_snapshot(rng, 1, n_users, n_items, flip=0)
    snap_b = _mk_snapshot(rng, 2, n_users, n_items, flip=1)
    ev = (rng.integers(0, n_users, 500), rng.integers(0, n_items, 500),
          np.sort(rng.random(500) * 100.0))
    server = SwapServer(snap_a, queue_len=16, recency_s=1e9, device="cpu")
    server.ingest(*ev)
    rep = server.swap_to(snap_b, now=100.0)
    assert rep["replayed_events"] == 500 and rep["dropped_stale"] == 0
    fresh = ClusterQueueStore(snap_b.user_clusters, queue_len=16,
                              recency_s=1e9, n_clusters=snap_b.n_clusters,
                              device="cpu")
    fresh.ingest(*ev)
    users = np.arange(n_users)
    got, ver = server.retrieve_batch(users, 100.0, 8)
    assert ver == 2
    np.testing.assert_array_equal(got,
                                  fresh.retrieve_batch(users, 100.0, 8))


def test_swap_report_matches_jax_server():
    """The same events and flips give the same swap accounting and the
    same served rows in both servers."""
    from repro.lifecycle.snapshot import IndexSnapshot as JSnap
    from repro.lifecycle.swap import SwapServer as JServer
    rng = np.random.default_rng(6)
    snaps = [_mk_snapshot(rng, v, 30, 20, flip=v % 2) for v in (1, 2)]
    ev = (rng.integers(0, 30, 700), rng.integers(0, 20, 700),
          np.sort(rng.random(700) * 100.0))
    out = []
    for mk, kw in ((lambda s: JSnap(**dataclasses.asdict(s)), {}),
                   (lambda s: s, dict(device="cpu"))):
        server = (JServer if not kw else SwapServer)(
            mk(snaps[0]), queue_len=16, recency_s=40.0, ring_capacity=512,
            **kw)
        server.ingest(*ev)
        rep = server.swap_to(mk(snaps[1]), now=100.0)
        rows = server.serve_batch(np.arange(30), 100.0, n_recent=4, k=8)
        out.append(({k: v for k, v in rep.items()
                     if k not in ("build_ms", "stall_ms", "span_id")},
                    server.ring_dropped, *rows))
    assert out[0][:2] == out[1][:2]
    for a, b in zip(out[0][2:], out[1][2:]):
        np.testing.assert_array_equal(a, b)
    rep = out[1][0]
    assert rep["replayed_events"] + rep["dropped_stale"] == 512


def test_snapshot_handle_flip_returns_displaced():
    rng = np.random.default_rng(5)
    snap = _mk_snapshot(rng, 1, 10, 10, flip=0)

    def bundle(v):
        return ServingBundle(
            version=v, snapshot=snap,
            store=ClusterQueueStore(snap.user_clusters, queue_len=4,
                                    recency_s=1.0,
                                    n_clusters=snap.n_clusters,
                                    device="cpu"),
            i2i=snap.i2i)

    h = SnapshotHandle(bundle(1))
    assert h.version == 1
    b2 = bundle(2)
    old = h.flip(b2)
    assert old.version == 1 and h.acquire() is b2
    old = h.flip(bundle(3))
    assert old.version == 2 and h.version == 3


# ---------------------------------------------------------------------------
# runtimes on the tiny world
# ---------------------------------------------------------------------------

def _graph_tables(world):
    import repro_torch.core.graph_builder as GB
    from repro_torch.data.edge_dataset import build_neighbor_tables
    g = GB.build_graph(world.day0, k_cap=16, hub_cap=12, keep_state=True)
    tables = build_neighbor_tables(g, k_imp=10, n_walks=12, walk_len=3,
                                   backend="numpy", device="cpu",
                                   keep_state=True)
    return g, tables


def _runtime(world, cfg, *, specs=None, tmp_path=None, seed=0, **lkw):
    """A port runtime on the CPU with a private FixedClock telemetry (and
    a private FaultPlan when ``specs`` is given; backoff sleeps advance
    the fixed clock)."""
    from repro_torch.faults import FaultInjector, FaultPlan
    from repro_torch.lifecycle import LifecycleConfig, LifecycleRuntime
    from repro_torch.obs import FixedClock, MemorySink, Telemetry
    sink = MemorySink()
    clock = FixedClock()
    tel = Telemetry(sink=sink, clock=clock)
    faults = (FaultInjector(FaultPlan(0, list(specs), telemetry=tel,
                                      sleep=clock.advance))
              if specs is not None else FaultInjector())
    g, tables = _graph_tables(world)
    kw = dict(steps_per_cycle=1, batch_per_type=8, recall_queries=40,
              recall_k=20, retry_backoff_s=0.01)
    kw.update(lkw)
    rt = LifecycleRuntime(cfg, LifecycleConfig(**kw), g, tables,
                          world.user_feat, world.item_feat, world=world,
                          snapshot_dir=(str(tmp_path) if tmp_path
                                        else None),
                          seed=seed, telemetry=tel, faults=faults,
                          sleep=clock.advance, device="cpu")
    return rt, tel, sink


def test_gate_failed_snapshot_is_not_persisted_or_swapped(
        tmp_path, tiny_world, tiny_cfg):
    from repro_torch.core.graph_builder import EngagementLog
    rt, _, _ = _runtime(tiny_world, port_cfg(tiny_cfg), tmp_path=tmp_path,
                        min_recall_ratio=2.0)          # unsatisfiable
    rep = rt.run_cycle(now=86400.0)
    assert rep["swap"].get("skipped") is True
    assert rt.server is None
    assert rt.store.versions() == []
    with pytest.raises(FileNotFoundError):
        rt.store.load()
    g_before, t_before = rt.g, rt.tables
    delta = EngagementLog(np.array([0]), np.array([0]),
                          np.array([0], np.int32), np.array([86401.0]),
                          tiny_world.n_users + 3, tiny_world.n_items)
    with pytest.raises(ValueError, match="user features"):
        rt.refresh(delta)
    assert rt.g is g_before and rt.tables is t_before


def test_gate_breadth_collapsed_codebook_cannot_publish():
    from repro_torch.lifecycle import LifecycleConfig, LifecycleRuntime
    rng = np.random.default_rng(0)
    healthy = _random_snapshot(rng, sizes=(4, 2))
    collapsed = dataclasses.replace(healthy, gate_metrics=(
        ("codebook_util_min", 0.25), ("recall_ratio", 0.9)))
    ok = dataclasses.replace(healthy, gate_metrics=(
        ("codebook_util_min", 1.0), ("recall_ratio", 0.9)))
    rt = SimpleNamespace(lcfg=LifecycleConfig(min_codebook_util=0.5))
    assert LifecycleRuntime.gate_passes(rt, ok)
    assert not LifecycleRuntime.gate_passes(rt, collapsed)
    assert LifecycleRuntime._failing_gates(rt, collapsed) == [
        "codebook_util_min"]
    rt_item = SimpleNamespace(lcfg=LifecycleConfig(
        min_item_recall_ratio=2.0))
    assert LifecycleRuntime.gate_passes(rt_item, ok)   # metric absent
    rt_off = SimpleNamespace(lcfg=LifecycleConfig())
    assert LifecycleRuntime.gate_passes(rt_off, collapsed)


def _healing_cfg():
    return RankGraph2Config(
        d_user_feat=64, d_item_feat=64, d_embed=24, n_heads=2,
        d_hidden=48, k_imp=10, k_train=4, n_negatives=16, n_pool_neg=4,
        rq=RQConfig(codebook_sizes=(8, 4), hist_len=20, util_coef=1.0,
                    usage_ema=0.9, dead_floor=0.25, reset_every=10),
        dtype="float32")


def _healing_runtime(world, steps=40):
    rt, _, _ = _runtime(world, _healing_cfg(), steps_per_cycle=steps,
                        batch_per_type=16, recall_queries=60, recall_k=20,
                        min_codebook_util=0.5, repair_attempts=1,
                        repair_steps=10)
    return rt


def test_publish_stability_across_consecutive_publishes(tiny_world):
    """The reference's test at its seed, with the utilisation floor at
    2/8 where the reference holds 3/8: the burst's negative draws are the
    port's own stream, and over seeds 0-3 both packages publish a
    ``codebook_util_min`` of 0.25 to 0.75 after these bursts (the JAX
    package 0.25 at seeds 1 and 2), so 3/8 holds for the reference at
    seeds 0 and 3 only.  2/8 is still twice the collapse signature (1/8)."""
    rt = _healing_runtime(tiny_world)
    r1 = rt.train_burst()
    m1 = rt.publish().metrics
    rt.train_burst()
    m2 = rt.publish().metrics
    assert "dead_code_resets" in r1 and rt.state.step == 80
    for m in (m1, m2):
        assert m["codebook_util_min"] >= 0.25       # vs 1/8 at collapse
        assert m["recall_ratio"] >= 0.8
    assert abs(m1["hitrate10_recon"] - m2["hitrate10_recon"]) < 0.9
    for l in (0, 1):
        assert abs(m1[f"util_layer{l}"] - m2[f"util_layer{l}"]) <= 0.5
    assert {"util_layer0", "util_layer1", "codebook_util_min",
            "coarse_list_balance", "coarse_list_max_share",
            "hitrate10_recon"} <= set(m2)


def _collapse(rt):
    with torch.no_grad():
        rt.state.params["rq"]["codebooks"]["layer0"].zero_()


@pytest.mark.slow
def test_collapse_injection_one_repair_burst_recovers(tiny_world):
    rt = _healing_runtime(tiny_world)
    rt.train_burst()
    base = rt.publish().metrics
    _collapse(rt)
    snap_bad = rt.publish()
    assert snap_bad.metrics["util_layer0"] == 1.0 / 8
    assert not rt.gate_passes(snap_bad)
    rep = rt.repair_burst(snap_bad)
    assert sum(rep["resets"].values()) > 0
    m = rt.publish().metrics
    assert m["util_layer0"] >= rt.lcfg.min_codebook_util
    assert m["recall_ratio"] >= 0.8 * min(base["recall_ratio"], 1.0)


@pytest.mark.slow
def test_run_cycle_repairs_gate_failure_end_to_end(tiny_world):
    rt = _healing_runtime(tiny_world, steps=20)
    _collapse(rt)
    rep = rt.run_cycle(now=86400.0)
    assert not rep["swap"].get("skipped"), rep["publish"]
    assert rep["publish"]["codebook_util_min"] >= 0.5
    assert rt.server is not None


def test_run_cycle_emits_lifecycle_spans_and_counters(tiny_world,
                                                      tiny_cfg):
    rt, tel, sink = _runtime(tiny_world, port_cfg(tiny_cfg))
    rep = rt.run_cycle(now=86400.0)
    assert not rep["swap"].get("skipped")
    spans = {r["name"]: r for r in _trace(sink) if r["type"] == "span"}
    cyc = spans["lifecycle.cycle"]
    assert cyc["parent_id"] is None
    for name in ("lifecycle.train", "lifecycle.publish", "lifecycle.swap"):
        assert spans[name]["parent_id"] == cyc["span_id"]
    assert spans["lifecycle.publish"]["attrs"]["gate_passed"] is True
    assert spans["lifecycle.swap"]["attrs"]["bring_up"] is True
    assert rep["swap"]["span_id"] == float(
        spans["lifecycle.swap"]["span_id"])
    snap = tel.snapshot()
    assert snap["counters"]["train.steps"] == 1.0
    assert snap["counters"]["publish.snapshots"] == 1.0
    assert "publish.gate_failures" not in snap["counters"]
    assert snap["hists"]["train.step_latency_s"]["n"] == 1
    for key in ("recall_ratio", "codebook_util_min"):
        assert f"publish.{key}" in snap["gauges"]


def test_repair_burst_outcome_surfaces_as_span_and_counters(tiny_world,
                                                            tiny_cfg):
    rt, tel, sink = _runtime(tiny_world, port_cfg(tiny_cfg),
                             min_recall_ratio=2.0, repair_attempts=1,
                             repair_steps=1)
    rep = rt.run_cycle(now=86400.0)
    assert rep["swap"].get("skipped") is True
    assert rep["repair"]["attempts"] == 1
    assert rep["repair"]["healed"] is False
    spans = [r for r in _trace(sink) if r["type"] == "span"]
    repair = [s for s in spans if s["name"] == "lifecycle.repair"]
    assert len(repair) == 1
    assert "recall_ratio" in repair[0]["attrs"]["trigger"]
    assert repair[0]["attrs"]["healed"] is False
    publishes = [s for s in spans if s["name"] == "lifecycle.publish"]
    assert len(publishes) == 2
    assert publishes[1]["parent_id"] == repair[0]["span_id"]
    counters = tel.snapshot()["counters"]
    assert counters["lifecycle.repair_bursts"] == 1.0
    assert counters["publish.gate_failures"] == 2.0
    assert counters["publish.snapshots"] == 2.0
    assert "lifecycle.repair_healed" not in counters


def test_transient_swap_fault_is_retried(tiny_world, tiny_cfg):
    from repro_torch.faults import FaultSpec
    rt, tel, sink = _runtime(
        tiny_world, port_cfg(tiny_cfg),
        specs=[FaultSpec("swap.flip", "raise", occurrences=(0,))],
        stage_retries=1)
    rt.run_cycle(now=86400.0)
    rep = rt.run_cycle(now=90000.0)
    assert not rep["swap"].get("skipped") and not rep["degraded"]
    assert rt.server.version == 2
    c = tel.snapshot()["counters"]
    assert c["lifecycle.stage_failures"] == 1.0
    assert c["lifecycle.stage_retries"] == 1.0
    fails = [r for r in _trace(sink) if r["type"] == "span"
             and r["name"] == "lifecycle.stage_failure"]
    assert fails and fails[0]["attrs"]["stage"] == "swap"


def test_exhausted_retries_pin_serving_and_recover_later(tiny_world,
                                                         tiny_cfg):
    from repro_torch.faults import FaultSpec
    rt, tel, _ = _runtime(
        tiny_world, port_cfg(tiny_cfg),
        specs=[FaultSpec("swap.flip", "raise", occurrences=(0, 1),
                         max_injections=2)], stage_retries=1)
    rt.run_cycle(now=86400.0)
    rep = rt.run_cycle(now=90000.0)
    assert rep["swap"]["skipped"] is True and rep["swap"]["degraded"]
    assert rep["swap"]["failed_stage"] == "swap"
    assert "swap.flip#1" in rep["swap"]["error"]
    assert rep["degraded"] is True and rep["stale_cycles"] == 1
    assert rt.server.version == 1
    snap = tel.snapshot()
    assert snap["gauges"]["lifecycle.degraded"] == 1.0
    assert snap["counters"]["lifecycle.stale_cycles"] == 1.0
    rep = rt.run_cycle(now=93600.0)
    assert not rep["swap"].get("skipped")
    assert rt.server.version == 3 and rep["degraded"] is False
    snap = tel.snapshot()
    assert snap["gauges"]["lifecycle.degraded"] == 0.0
    assert snap["counters"]["lifecycle.recoveries"] == 1.0


@pytest.mark.parametrize("rollback", [True, False])
def test_post_swap_regression_and_rollback(tiny_world, tiny_cfg, rollback):
    from repro_torch.faults import FaultSpec
    rt, tel, sink = _runtime(
        tiny_world, port_cfg(tiny_cfg),
        specs=[FaultSpec("health.post_swap", "raise", occurrences=(1,))],
        rollback_on_regression=rollback)
    rt.run_cycle(now=86400.0)
    rep = rt.run_cycle(now=90000.0)
    c = tel.snapshot()["counters"]
    if rollback:
        assert rep["swap"]["rolled_back"] is True and rep["degraded"]
        assert rt.server.version == 1
        assert c["lifecycle.rollbacks"] == 1.0
        assert c["lifecycle.post_swap_regressions"] == 1.0
        rb = [r for r in _trace(sink) if r["type"] == "span"
              and r["name"] == "lifecycle.rollback"]
        assert rb and rb[0]["attrs"]["to_version"] == 1
    else:
        assert "rolled_back" not in rep["swap"]
        assert rt.server.version == 2
        assert "lifecycle.rollbacks" not in c


def test_injected_crash_is_never_retried(tiny_world, tiny_cfg):
    from repro_torch.faults import FaultSpec, InjectedCrash
    rt, tel, _ = _runtime(
        tiny_world, port_cfg(tiny_cfg),
        specs=[FaultSpec("train.step", "crash", occurrences=(0,))],
        stage_retries=3)
    with pytest.raises(InjectedCrash):
        rt.run_cycle(now=86400.0)
    assert "lifecycle.stage_retries" not in tel.snapshot()["counters"]


def test_recover_serving_falls_back_through_corruption(tiny_world,
                                                       tiny_cfg, tmp_path):
    from repro_torch.faults import corrupt_file
    cfg = port_cfg(tiny_cfg)
    rt, _, _ = _runtime(tiny_world, cfg, specs=[], tmp_path=tmp_path)
    rt.run_cycle(now=86400.0)
    rt.run_cycle(now=90000.0)
    assert rt.store.versions() == [1, 2]
    corrupt_file(str(tmp_path / "step_2" / "000000.npy"), (0,))
    rt2, tel2, sink2 = _runtime(tiny_world, cfg, specs=[],
                                tmp_path=tmp_path)
    assert rt2.recover_serving(now=93600.0) == 1
    assert rt2.server.version == 1
    res, ver = rt2.server.retrieve_batch(np.arange(8), 93600.0, 4)
    assert ver == 1 and res.shape == (8, 4)
    assert "step_2.corrupt" in os.listdir(tmp_path)
    c = tel2.snapshot()["counters"]
    assert c["snapshot.corrupt_detected"] == 1.0
    assert c["snapshot.quarantined"] == 1.0
    assert c["lifecycle.serving_recovered"] == 1.0
    fb = [r for r in _trace(sink2) if r["type"] == "span"
          and r["name"] == "snapshot.fallback"]
    assert fb and fb[0]["attrs"]["version"] == 2


def test_recover_serving_with_empty_store_returns_none(tiny_world,
                                                       tiny_cfg, tmp_path):
    rt, _, _ = _runtime(tiny_world, port_cfg(tiny_cfg), tmp_path=tmp_path)
    assert rt.recover_serving(now=0.0) is None
    assert rt.server is None


def test_runtime_refresh_grows_both_id_spaces(tiny_world, tiny_cfg):
    """A cycle with a delta that mints users and items: the refresh
    report, the grown feature store and a snapshot over the new spaces;
    the step was rebuilt over the new tables."""
    from repro_torch.core.graph_builder import EngagementLog
    rt, tel, sink = _runtime(tiny_world, port_cfg(tiny_cfg))
    rt.run_cycle(now=86400.0)
    step_before = rt._step_fn
    log = tiny_world.day0
    nu, ni = log.n_users + 4, log.n_items + 3
    rng = np.random.default_rng(1)
    hour = log.window(86400.0, 3600.0)
    du = np.r_[hour.user_id, np.arange(log.n_users, nu)]
    di = np.r_[hour.item_id, rng.integers(0, log.n_items, 4)]
    du = np.r_[du, rng.integers(0, log.n_users, 3)]
    di = np.r_[di, np.arange(log.n_items, ni)]
    delta = EngagementLog(du.astype(np.int64), di.astype(np.int64),
                          np.zeros(len(du), np.int32),
                          np.full(len(du), 86400.0), nu, ni)
    uf = np.r_[tiny_world.user_feat,
               rng.normal(size=(4, 64)).astype(np.float32)]
    itf = np.r_[tiny_world.item_feat,
                rng.normal(size=(3, 64)).astype(np.float32)]
    rep = rt.run_cycle(delta, now=90000.0, user_feat=uf, item_feat=itf)
    assert rep["refresh"]["touched_users"] >= 4
    assert rt._step_fn is not step_before
    assert tuple(rt.dataset.user_feat.shape) == (nu, 64)
    snap = rt.server.handle.acquire().snapshot
    assert snap.n_users == nu and snap.n_items == ni and snap.version == 2
    spans = {r["name"]: r for r in _trace(sink) if r["type"] == "span"}
    assert spans["lifecycle.refresh"]["attrs"]["delta_events"] == len(du)
    res, ver = rt.server.retrieve_batch(np.arange(log.n_users, nu),
                                        90000.0, 4)
    assert ver == 2 and res.shape == (4, 4)


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------

def test_snapshots_cross_load_between_packages(tmp_path):
    from repro.checkpoint.checkpointer import (
        CheckpointCorruptError as JCorrupt)
    from repro.lifecycle.snapshot import (IndexSnapshot as JSnap,
                                          SnapshotStore as JStore)
    from repro_torch.checkpoint import CheckpointCorruptError
    from repro_torch.faults import corrupt_file
    rng = np.random.default_rng(2)
    p_snap = _random_snapshot(rng, version=4, n_users=57, sizes=(5, 3),
                              d=16, k=7)
    j_snap = _random_snapshot(rng, version=9, cls=JSnap)
    SnapshotStore(str(tmp_path / "p")).publish(p_snap)
    JStore(str(tmp_path / "j")).publish(j_snap)
    _assert_same_snapshot(JStore(str(tmp_path / "p")).load(), p_snap)
    _assert_same_snapshot(SnapshotStore(str(tmp_path / "j")).load(), j_snap)
    for d in ("p", "j"):
        with open(tmp_path / d / f"step_{4 if d == 'p' else 9}"
                  / "manifest.json") as f:
            meta = json.load(f)
        assert meta["kind"] == "index_snapshot" and meta["n_leaves"] == 7
    corrupt_file(str(tmp_path / "p" / "step_4" / "000003.npy"), (1,))
    with pytest.raises(CheckpointCorruptError, match="leaf 3 checksum"):
        SnapshotStore(str(tmp_path / "p")).load()
    with pytest.raises(JCorrupt, match="leaf 3 checksum"):
        JStore(str(tmp_path / "p")).load()


def test_backoff_schedule_matches_jax():
    from repro.lifecycle.runtime import (LifecycleConfig as JLC,
                                         LifecycleRuntime as JRT)
    from repro_torch.lifecycle import LifecycleConfig, LifecycleRuntime
    for seed, base in ((0, 0.5), (3, 0.01), (7, 0.0)):
        j = SimpleNamespace(lcfg=JLC(retry_backoff_s=base), seed=seed)
        p = SimpleNamespace(lcfg=LifecycleConfig(retry_backoff_s=base),
                            seed=seed)
        for stage in ("refresh", "train", "publish", "swap"):
            got = [LifecycleRuntime._backoff_s(p, stage, a)
                   for a in range(5)]
            assert got == [JRT._backoff_s(j, stage, a) for a in range(5)]
            assert (base == 0) == (max(got) == 0)


@pytest.fixture(scope="module")
def jax_world(tiny_world):
    """The JAX package's graph, tables and initial state on the tiny
    world, and the port's equivalents (the same numpy inputs)."""
    import repro.core.graph_builder as JGB
    from repro.data.edge_dataset import build_neighbor_tables as jtables
    from repro_torch.data.synthetic import make_world
    jg = JGB.build_graph(tiny_world.day0, k_cap=16, hub_cap=12,
                         keep_state=True)
    jt = jtables(jg, k_imp=10, n_walks=12, walk_len=3, keep_state=True)
    pw = make_world(n_users=300, n_items=400, events_per_user=25.0, seed=0)
    for a, b in ((tiny_world.day1, pw.day1), (tiny_world.day0, pw.day0)):
        for f in ("user_id", "item_id", "event_type", "timestamp"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    return dict(jg=jg, jt=jt, pw=pw)


def _both_runtimes(jw, tiny_world, tiny_cfg, specs, tmp_path=None, **lkw):
    """The JAX runtime and the port's with the same config, fault plan
    (each package's own classes) and FixedClock telemetry; the port
    starts from the JAX initial state."""
    import repro.faults as JF
    import repro.obs as JO
    import repro_torch.faults as PF
    import repro_torch.obs as PO
    from repro.lifecycle.runtime import (LifecycleConfig as JLC,
                                         LifecycleRuntime as JRT)
    from repro_torch.convert import train_state_from_jax
    from repro_torch.lifecycle import LifecycleConfig, LifecycleRuntime
    kw = dict(steps_per_cycle=0, batch_per_type=8, recall_queries=40,
              recall_k=20, retry_backoff_s=0.01)
    kw.update(lkw)
    out = []
    for F, O, LC, RT, world, g, tables, sub, extra in (
            (JF, JO, JLC, JRT, tiny_world, jw["jg"], jw["jt"], "j", {}),
            (PF, PO, LifecycleConfig, LifecycleRuntime, jw["pw"], None,
             None, "p", dict(device="cpu"))):
        if g is None:
            g, tables = _graph_tables(jw["pw"])
        sink = O.MemorySink()
        clock = O.FixedClock()
        tel = O.Telemetry(sink=sink, clock=clock)
        faults = F.FaultInjector(F.FaultPlan(
            0, [F.FaultSpec(*s[:2], **s[2]) for s in specs],
            telemetry=tel, sleep=clock.advance))
        rt = RT(tiny_cfg if sub == "j" else port_cfg(tiny_cfg), LC(**kw), g,
                tables, world.user_feat, world.item_feat, world=world,
                snapshot_dir=(str(tmp_path / sub) if tmp_path else None),
                seed=0, telemetry=tel, faults=faults, sleep=clock.advance,
                **extra)
        out.append((rt, tel, sink))
    out[1][0].state = train_state_from_jax(out[0][0].state, device="cpu")
    return out


def _control_flow(rep):
    swap = rep.get("swap", {})
    return dict(cycle=rep["cycle"], degraded=rep["degraded"],
                stale_cycles=rep["stale_cycles"],
                version=rep.get("publish", {}).get("version"),
                publish_failed=rep.get("publish", {}).get("failed"),
                repair=rep.get("repair"),
                **{"swap_" + k: swap.get(k) for k in (
                    "skipped", "degraded", "failed_stage", "error",
                    "rolled_back", "from_version", "to_version",
                    "replayed_events", "dropped_stale")})


def _spans(sink):
    recs = [r for r in _trace(sink) if r["type"] == "span"]
    by_id = {r["span_id"]: r["name"] for r in recs}
    return [(r["name"], by_id.get(r["parent_id"]), r["attrs"])
            for r in recs]


def _observed(rt, tel, sink):
    snap = tel.snapshot()
    return dict(counters=snap["counters"], gauges=snap["gauges"],
                hists={k: v["n"] for k, v in snap["hists"].items()},
                spans=_spans(sink),
                version=None if rt.server is None else rt.server.version)


PLANS = {
    "transient_swap": ([("swap.flip", "raise", dict(occurrences=(0,)))],
                       dict(stage_retries=1)),
    "exhausted_swap": ([("swap.flip", "raise",
                         dict(occurrences=(0, 1), max_injections=2))],
                       dict(stage_retries=1)),
    "rollback": ([("health.post_swap", "raise", dict(occurrences=(1,)))],
                 {}),
    "no_rollback": ([("health.post_swap", "raise",
                      dict(occurrences=(1,)))],
                    dict(rollback_on_regression=False)),
    "gate_eval": ([("gate.eval", "raise", dict(occurrences=(1, 2)))],
                  dict(stage_retries=1)),
    "repair": ([], dict(min_recall_ratio=2.0, repair_attempts=1,
                        repair_steps=0)),
}


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_same_fault_plan_same_control_flow(jax_world, tiny_world, tiny_cfg,
                                           plan):
    specs, lkw = PLANS[plan]
    (jrt, jtel, jsink), (prt, ptel, psink) = _both_runtimes(
        jax_world, tiny_world, tiny_cfg, specs, **lkw)
    for now in (86400.0, 90000.0, 93600.0):
        jrep, prep = jrt.run_cycle(now=now), prt.run_cycle(now=now)
        assert _control_flow(prep) == _control_flow(jrep)
    jo, po = _observed(jrt, jtel, jsink), _observed(prt, ptel, psink)
    assert po == jo
    assert prt.faults.plan.log == jrt.faults.plan.log
    # with rollback off the post-swap probe never runs, so never fires
    assert bool(prt.faults.plan.log) == (plan not in ("no_rollback",
                                                      "repair"))


def test_same_fault_plan_crash_and_recovery(jax_world, tiny_world,
                                            tiny_cfg, tmp_path):
    """A leaf of version 2 corrupted as it is written, then a crash at the
    next burst's first step: both runtimes crash at the same point, and a
    fresh runtime in each package recovers version 1 from the other's
    snapshot directory, with the same counters and spans."""
    specs = [("snapshot.write_leaf", "corrupt", dict(occurrences=(7,))),
             ("train.step", "crash", dict(occurrences=(0,)))]
    import repro.faults as JF
    import repro_torch.faults as PF
    pair = _both_runtimes(jax_world, tiny_world, tiny_cfg, specs,
                          tmp_path=tmp_path, steps_per_cycle=0)
    for rt, _, _ in pair:
        rt.run_cycle(now=86400.0)
        rt.run_cycle(now=90000.0)
        assert rt.store.versions() == [1, 2]
        rt.lcfg = dataclasses.replace(rt.lcfg, steps_per_cycle=1)
    with pytest.raises(JF.InjectedCrash):
        pair[0][0].run_cycle(now=93600.0)
    with pytest.raises(PF.InjectedCrash):
        pair[1][0].run_cycle(now=93600.0)
    assert _observed(*pair[1]) == _observed(*pair[0])
    # a restart on the other package's directory
    fresh = _both_runtimes(jax_world, tiny_world, tiny_cfg, [],
                           tmp_path=tmp_path / "x")
    (jrt, jtel, jsink), (prt, ptel, psink) = fresh
    jrt.store = type(jrt.store)(str(tmp_path / "p"), faults=jrt.faults,
                                telemetry=jtel)
    prt.store = type(prt.store)(str(tmp_path / "j"), faults=prt.faults,
                                telemetry=ptel)
    assert jrt.recover_serving(now=93600.0) == 1
    assert prt.recover_serving(now=93600.0) == 1
    assert _observed(prt, ptel, psink) == _observed(jrt, jtel, jsink)
    _assert_same_snapshot(prt.server.handle.acquire().snapshot,
                          jrt.server.handle.acquire().snapshot)


def test_zero_step_cycle_publishes_the_same_snapshot(jax_world, tiny_world,
                                                     tiny_cfg, tmp_path):
    """From the JAX initial state with no training, both runtimes embed
    the corpus (f32 embeddings within 1e-5), publish the same snapshot
    bitwise (codes, clusters, members, I2I; no near tie on this world)
    and the same gate metrics bitwise, and each loads the other's."""
    from repro.lifecycle.snapshot import SnapshotStore as JStore
    (jrt, _, _), (prt, _, _) = _both_runtimes(
        jax_world, tiny_world, tiny_cfg, [], tmp_path=tmp_path)
    jrep, prep = jrt.run_cycle(now=86400.0), prt.run_cycle(now=86400.0)
    np.testing.assert_allclose(prt._last_user_emb.numpy(),
                               np.asarray(jrt._last_user_emb), rtol=1e-5,
                               atol=1e-5)
    assert prep["publish"] == jrep["publish"]
    assert {"recall_ratio", "item_recall_ratio", "codebook_util_min",
            "hitrate10_recon", "coarse_list_balance"} <= set(prep["publish"])
    jsnap, psnap = jrt._last_good, prt._last_good
    _assert_same_snapshot(psnap, jsnap)
    _assert_same_snapshot(SnapshotStore(str(tmp_path / "j")).load(), jsnap)
    _assert_same_snapshot(JStore(str(tmp_path / "p")).load(), psnap)


# ---------------------------------------------------------------------------
# examples/lifecycle_e2e.py on the port (slow)
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_lifecycle_e2e_example_on_the_port(tmp_path):
    """``examples/lifecycle_e2e.py`` at its own sizes on the CPU: build on
    23 hours, cycle 0, live traffic, cycle 1 with the trailing hour and
    five new users and items, and the example's gate: the published
    index keeps >= 0.8 of exact-KNN Recall@100."""
    from repro_torch import obs
    from repro_torch.core.graph_builder import EngagementLog, build_graph
    from repro_torch.data.edge_dataset import build_neighbor_tables
    from repro_torch.data.synthetic import make_world
    from repro_torch.lifecycle import LifecycleConfig, LifecycleRuntime
    tel = obs.Telemetry(sink=obs.JsonlSink(str(tmp_path / "t.jsonl")))
    world = make_world(n_users=500, n_items=800, events_per_user=20.0,
                       seed=1)
    cfg = RankGraph2Config(
        d_user_feat=64, d_item_feat=64, d_embed=32, n_heads=2, d_hidden=96,
        k_imp=10, k_train=4, n_negatives=24, n_pool_neg=8,
        rq=RQConfig(codebook_sizes=(16, 4), hist_len=50), dtype="float32")
    lcfg = LifecycleConfig(steps_per_cycle=150, batch_per_type=64,
                           i2i_k=12, recency_s=2 * 86400.0,
                           recall_k=100, recall_queries=300,
                           min_recall_ratio=0.8)
    log = world.day0
    m = log.timestamp <= 82800.0
    old = EngagementLog(log.user_id[m], log.item_id[m], log.event_type[m],
                        log.timestamp[m], log.n_users, log.n_items)
    g = build_graph(old, k_cap=16, hub_cap=24, keep_state=True)
    tables = build_neighbor_tables(g, k_imp=10, n_walks=16, walk_len=3,
                                   backend="device", device="cpu",
                                   keep_state=True)
    rt = LifecycleRuntime(cfg, lcfg, g, tables, world.user_feat,
                          world.item_feat, world=world,
                          snapshot_dir=str(tmp_path / "snaps"), seed=0,
                          telemetry=tel, device="cpu")
    rep = rt.run_cycle(now=86400.0)
    assert rep["publish"]["recall_ratio"] >= 0.8
    d1 = world.day1
    rt.server.ingest(d1.user_id, d1.item_id, d1.timestamp)
    now = float(d1.timestamp.max())
    users = np.random.default_rng(0).integers(0, world.n_users, 512)
    seeds, union, ver = rt.server.serve_batch(users, now, n_recent=8, k=32)
    assert ver == 1 and (union >= 0).any()
    delta = log.window(86400.0, 3600.0)
    nu_new, ni_new = log.n_users + 5, log.n_items + 5
    rng = np.random.default_rng(2)
    du = np.r_[delta.user_id, np.arange(log.n_users, nu_new),
               rng.integers(0, log.n_users, 5)]
    di = np.r_[delta.item_id, rng.integers(0, log.n_items, 5),
               np.arange(log.n_items, ni_new)]
    delta = EngagementLog(du.astype(np.int64), di.astype(np.int64),
                          np.zeros(len(du), np.int32),
                          np.full(len(du), 86400.0), nu_new, ni_new)
    uf = np.r_[world.user_feat, rng.normal(0, 1, (5, 64)).astype(np.float32)]
    itf = np.r_[world.item_feat,
                rng.normal(0, 1, (5, 64)).astype(np.float32)]
    rep = rt.run_cycle(delta, now=now, user_feat=uf, item_feat=itf,
                       backend="device")
    p, s = rep["publish"], rep["swap"]
    assert not s.get("skipped"), p["recall_ratio"]
    assert p["recall_ratio"] >= 0.8
    fresh = np.arange(log.n_users, nu_new)
    res, ver = rt.server.retrieve_batch(fresh, now, 16)
    assert ver == p["version"] == 2
    assert rt.store.load().user_clusters[fresh].min() >= 0
    tel.flush()
