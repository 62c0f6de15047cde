"""The chaos harness, as ``repro/faults/chaos.py``: seeded fault schedules
against the port's full lifecycle.

``run_chaos`` drives a small synthetic world through ``cycles`` full
lifecycle cycles (refresh -> train -> publish -> swap -> serve) with a
:class:`~repro_torch.faults.plan.FaultPlan` installed at every injection
site, modelling crash-restart on :class:`InjectedCrash` (serving is
rebuilt from the newest on-disk snapshot that verifies), and checks the
four fault-tolerance invariants end to end:

* **no_bad_serve** — every snapshot version that ever answered a
  request passed its publication gate (torn/corrupt versions are
  quarantined on load, gate-failed ones are never persisted);
* **recall_floor** — the served version's gated recall ratio never
  drops below the configured floor, across degradation and rollback;
* **exactly_once** — synthetic traffic uses globally unique item ids,
  so any double-applied ring event shows up as a duplicate in the live
  store (swap replay + crash recovery must never double-deliver);
* **all_faults_traced** — every injection in ``FaultPlan.log`` has a
  matching ``fault.injected`` span in the telemetry trace.

Everything but the device's sums is deterministic: a private
``Telemetry`` on ``FixedClock`` + ``MemorySink``, tuple-keyed RNG for
traffic/deltas, and delay faults advance the fixed clock instead of
sleeping.  On the CPU with torch on one thread, two runs with the same
seed return byte-identical reports (``json.dumps`` equal).  On a card
the train step's sums need not repeat, so recall values may differ
between runs; the invariants hold all the same.

Departures from the reference: ``device`` (CUDA unless ``"cpu"`` is
asked for) holds the runtime's state; ``trace_path``, when given,
receives the run's telemetry trace and its final metric records as
JSONL (``python -m repro_torch.obs.report`` renders it); the runtime's initial state and
negative draws are the port's own streams (``lifecycle/runtime.py``),
so a port report's recall values differ from a JAX report's, while the
schedule's control flow (the injection log, crashes, recoveries) is the
same.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.faults.plan import (FaultInjector, FaultPlan, FaultSpec,
                                     InjectedCrash)
from repro_torch.obs import FixedClock, MemorySink, Telemetry

#: the acceptance-criteria site list: a full chaos schedule must inject
#: at every one of these
REQUIRED_SITES = ("snapshot.write_leaf", "snapshot.load", "ring.push",
                  "swap.flip", "train.step", "gate.eval")

#: unique synthetic item-id base for the exactly-once check (int32-safe:
#: the serving store's item queues are int32)
UNIQUE_ITEM_BASE = 1_000_000_000


def default_specs() -> Tuple[FaultSpec, ...]:
    """The standard full-coverage schedule: one injection at every
    required site plus the stage/health sites, with occurrences placed
    so each fires within a 6-cycle run under ``stage_retries=1``."""
    return (
        # cycle 0's train burst fails at step 3 -> stage retry succeeds
        FaultSpec("train.step", "raise", occurrences=(3,),
                  max_injections=1),
        # cycle 1's gate eval errors -> publish stage retries (the
        # retried publish re-embeds and re-evaluates)
        FaultSpec("gate.eval", "raise", occurrences=(1,),
                  max_injections=1),
        # a leaf of the third on-disk publish is corrupted after its
        # checksum is recorded -> detectable on any later load
        FaultSpec("snapshot.write_leaf", "corrupt", occurrences=(16,),
                  max_injections=1),
        # a later publish crashes before the atomic rename -> partial
        # .tmp dir; restart sweeps it and recovery falls back through
        # the corrupt version to the last good one
        FaultSpec("snapshot.finalize", "crash", occurrences=(3,),
                  max_injections=1),
        # the first post-restart load finds bit-rot -> quarantine + walk
        FaultSpec("snapshot.load", "corrupt", occurrences=(0,),
                  max_injections=1),
        # one traffic ingest hits ring overload -> batch shed, counted
        FaultSpec("ring.push", "raise", occurrences=(2,),
                  max_injections=1),
        # one swap fails right before the flip -> old version keeps
        # serving; stage retry re-runs swap_to and flips cleanly
        FaultSpec("swap.flip", "raise", occurrences=(1,),
                  max_injections=1),
        # one post-swap health probe regresses -> rollback to last good
        FaultSpec("health.post_swap", "raise", occurrences=(3,),
                  max_injections=1),
        # one refresh fails upstream (log fetch) -> retried
        FaultSpec("stage.refresh", "raise", occurrences=(1,),
                  max_injections=1),
    )


def _make_delta(seed: int, cycle: int, now: float, n_users: int,
                n_items: int, n_events: int = 250):
    """A keyed synthetic trailing-hour engagement window."""
    from repro_torch.core.graph_builder import EngagementLog
    rng = np.random.default_rng((seed, 11, cycle))
    du = rng.integers(0, n_users, n_events).astype(np.int64)
    di = rng.integers(0, n_items, n_events).astype(np.int64)
    ts = np.sort(now - 3600.0 * rng.random(n_events))
    return EngagementLog(du, di, np.zeros(n_events, np.int32), ts,
                         n_users, n_items)


def run_chaos(seed: int = 0, *, snapshot_dir: str, cycles: int = 6,
              specs: Optional[Tuple[FaultSpec, ...]] = None,
              steps_per_cycle: int = 30, n_users: int = 200,
              n_items: int = 260, min_recall_ratio: float = 0.5,
              stage_retries: int = 1, device=None,
              trace_path: Optional[str] = None) -> Dict[str, Any]:
    """Run one seeded chaos schedule; returns the invariant report.

    The report is JSON-serializable.  On the CPU (torch on one thread)
    it is deterministic in ``seed``: ``json.dumps(run_chaos(s)) ==
    json.dumps(run_chaos(s))`` with two distinct ``snapshot_dir``\\ s.
    """
    from repro_torch.configs.base import RankGraph2Config, RQConfig
    from repro_torch.core.graph_builder import build_graph
    from repro_torch.data.edge_dataset import build_neighbor_tables
    from repro_torch.data.synthetic import make_world
    from repro_torch.kernels.common import resolve_device
    from repro_torch.lifecycle import LifecycleConfig, LifecycleRuntime
    from repro_torch.lifecycle.runtime import StageFailed

    dev = resolve_device(device)
    sink = MemorySink()
    clock = FixedClock()
    tel = Telemetry(sink=sink, clock=clock)
    plan = FaultPlan(seed, specs if specs is not None else default_specs(),
                     telemetry=tel, sleep=clock.advance)
    faults = FaultInjector(plan)

    world = make_world(n_users=n_users, n_items=n_items,
                       events_per_user=20.0, seed=seed)
    cfg = RankGraph2Config(
        d_user_feat=64, d_item_feat=64, d_embed=24, n_heads=2, d_hidden=48,
        k_imp=10, k_train=4, n_negatives=16, n_pool_neg=4,
        rq=RQConfig(codebook_sizes=(16, 8), hist_len=20), dtype="float32")
    lcfg = LifecycleConfig(
        steps_per_cycle=steps_per_cycle, batch_per_type=32,
        recall_k=50, recall_queries=100,
        min_recall_ratio=min_recall_ratio,
        stage_retries=stage_retries, retry_backoff_s=0.01,
        rollback_on_regression=True)
    g = build_graph(world.day0, k_cap=16, hub_cap=12, keep_state=True)
    tables = build_neighbor_tables(g, k_imp=10, n_walks=12, walk_len=3,
                                   backend="numpy", device=dev,
                                   keep_state=True)
    rt = LifecycleRuntime(cfg, lcfg, g, tables, world.user_feat,
                          world.item_feat, world=world,
                          snapshot_dir=snapshot_dir, seed=seed,
                          telemetry=tel, faults=faults,
                          sleep=clock.advance, device=dev)

    served: List[int] = []          # version answering each probe
    good: Dict[int, float] = {}     # gate-passed version -> recall ratio
    cycle_log: List[Dict[str, Any]] = []
    crashes = recoveries = 0
    next_uid = 0                    # unique item-id counter

    def probe(now: float) -> None:
        if rt.server is None:
            return
        rng = np.random.default_rng((seed, 23, len(served)))
        uids = rng.integers(0, n_users, 32)
        res, ver = rt.server.retrieve_batch(uids, now, 16)
        assert res.shape == (32, 16)
        served.append(int(ver))

    def traffic(cycle: int, now: float) -> int:
        """Ingest a batch of uniquely-item-id'd events; returns count."""
        nonlocal next_uid
        if rt.server is None:
            return 0
        rng = np.random.default_rng((seed, 29, cycle))
        n = 200
        du = rng.integers(0, n_users, n).astype(np.int64)
        di = (UNIQUE_ITEM_BASE + next_uid + np.arange(n)).astype(np.int64)
        next_uid += n
        ts = now - 60.0 + 60.0 * rng.random(n)
        rt.server.ingest(du, di, np.sort(ts))
        return n

    def note_good(rep: Dict[str, Any]) -> None:
        pub, swap = rep.get("publish"), rep.get("swap")
        if not isinstance(pub, dict) or "version" not in pub:
            return
        if not isinstance(swap, dict):
            return
        if swap.get("skipped") or swap.get("rolled_back"):
            return
        good[int(pub["version"])] = float(pub.get("recall_ratio", 1.0))

    for c in range(cycles):
        now = 86400.0 + 3600.0 * (c + 1)
        try:
            traffic(c, now)
            if c == 0:
                rep = rt.run_cycle(now=now)
            else:
                delta = _make_delta(seed, c, now, n_users, n_items)
                rep = rt.run_cycle(delta, now=now, backend="numpy")
            note_good(rep)
            cycle_log.append(dict(
                cycle=c, degraded=bool(rep.get("degraded")),
                stale_cycles=int(rep.get("stale_cycles", 0)),
                swap={k: v for k, v in rep.get("swap", {}).items()
                      if k in ("skipped", "degraded", "failed_stage",
                               "to_version", "rolled_back")}))
        except InjectedCrash as e:
            # simulated process death: restart = a fresh serving tier
            # from the newest on-disk snapshot that verifies
            crashes += 1
            v = rt.recover_serving(now)
            if v is not None:
                recoveries += 1
                good.setdefault(
                    int(v),
                    float(dict(rt._last_good.gate_metrics)
                          .get("recall_ratio", 1.0)))
            cycle_log.append(dict(cycle=c, crashed=True, site=e.site,
                                  recovered_version=v))
        except StageFailed as e:
            # only reachable before serving exists (bring-up)
            cycle_log.append(dict(cycle=c, failed_stage=e.stage))
        probe(now)

    # -- invariants ---------------------------------------------------------
    served_set = sorted(set(served))
    no_bad_serve = all(v in good for v in served_set)
    recall_by_served = {str(v): good[v] for v in served_set if v in good}
    recall_floor_ok = all(r >= min_recall_ratio
                          for r in recall_by_served.values())

    # exactly-once: unique synthetic item ids must appear at most once
    # in the live store (double-applied ring events would duplicate)
    duplicates = 0
    if rt.server is not None:
        items = rt.server.handle.acquire().store.items
        uniq_ids = items[items >= UNIQUE_ITEM_BASE - 10]
        duplicates = int(uniq_ids.size - np.unique(uniq_ids).size)
    exactly_once = duplicates == 0

    # every injection must be visible as a fault.injected span
    traced = []
    for line in sink.lines:
        rec = json.loads(line)
        if rec.get("type") == "span" and rec.get("name") == "fault.injected":
            a = rec.get("attrs", {})
            traced.append((a.get("site"), a.get("occurrence"),
                           a.get("action")))
    injected = [(r["site"], r["occurrence"], r["action"])
                for r in plan.log]
    all_faults_traced = all(t in traced for t in injected)

    if trace_path is not None:
        tel.flush()                     # the metric records join the spans
        with open(trace_path, "w", encoding="utf-8") as fh:
            fh.writelines(line + "\n" for line in sink.lines)

    counters = {k: v for k, v in sorted(tel.snapshot()
                                        .get("counters", {}).items())
                if k.startswith(("faults.", "lifecycle.", "snapshot.",
                                 "publish.gate", "swap.ring_dropped",
                                 "swap.ingest_shed"))}
    return dict(
        seed=seed,
        cycles=cycles,
        injected=list(plan.log),
        sites_injected=sorted({r["site"] for r in plan.log}),
        crashes=crashes,
        recoveries=recoveries,
        served_versions=served_set,
        good_versions=sorted(good),
        recall_by_served=recall_by_served,
        duplicates=duplicates,
        cycle_log=cycle_log,
        counters=counters,
        invariants=dict(no_bad_serve=no_bad_serve,
                        recall_floor=recall_floor_ok,
                        exactly_once=exactly_once,
                        all_faults_traced=all_faults_traced),
    )
