"""Step-driven lifecycle orchestrator (the paper's co-design loop).

One ``run_cycle`` = one simulated hour of the production lifecycle:

    1. **refresh**   splice the trailing engagement window into the
                     graph + PPR tables (``edge_dataset
                     .incremental_refresh``; both id spaces may grow);
    2. **train**     a burst of ``steps_per_cycle`` co-training steps on
                     the refreshed edge dataset (``core.trainer``);
    3. **publish**   regenerate all embeddings, encode them through the
                     co-learned RQ codebooks and materialize a versioned
                     ``IndexSnapshot`` (``lifecycle.publish``), gated on
                     cluster-index recall vs exact KNN;
    4. **swap**      atomically flip the serving tier to the new
                     version (``lifecycle.swap``) — or keep the old one
                     when the gate fails.

Cadence knobs live on ``LifecycleConfig``; the runtime owns the mutable
stage state (graph, tables, dataset, train state, serving engine) and
reports one dict per cycle.

The port of ``repro/lifecycle/runtime.py``.  Its stage state lives on
``device`` (CUDA unless the caller passes ``device="cpu"``): the train
state, the feature tables (the dataset's feature store), the neighbour
tables, the serving store.  The refresh re-walks on the ``ppr_walk``
kernel, the burst trains on the ``fused_contrastive`` kernels, the
publish encodes on ``rq_assign`` and the server answers on
``queue_gather``; which path each op takes follows its tensors'
device, as everywhere in the port.  Departures from the reference:

* the initial state is ``trainer.init_state`` with a ``torch.Generator``
  seeded ``seed`` (JAX: ``jax.random.key(seed)``), and step ``s`` of a
  burst draws its negatives from a generator on the device seeded
  ``1000 + s`` (JAX: ``jax.random.key(1000 + s)``).  Both are the
  port's own streams; parity runs copy the JAX state in
  (``convert.train_state_from_jax``);
* there is no ``use_kernel`` knob: the device decides;
* the train step is rebuilt whenever the feature tables change (new
  tables, or a grown id space), because it closes over the device copy
  of the tables;
* the embeddings stay on the device in ``cfg.dtype``; the gate and the
  Group-2 fill read host copies (``publish.host_embeddings``: bf16 as
  float64, which is what numpy computes the reference's bf16 arrays
  in).
"""
from __future__ import annotations

import dataclasses
import time
import zlib
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import RankGraph2Config
from repro_torch.core import model as M
from repro_torch.core import trainer as T
from repro_torch.core.graph_builder import EngagementLog, HeteroGraph
from repro_torch.core.rq_index import per_code_counts
from repro_torch.data.edge_dataset import (EdgeDataset, NeighborTables,
                                           incremental_refresh)
from repro_torch.faults import InjectedCrash, get_faults
from repro_torch.kernels.common import resolve_device
from repro_torch.lifecycle.publish import (build_snapshot,
                                           evaluate_snapshot,
                                           host_embeddings, snapshot_health)
from repro_torch.lifecycle.snapshot import (IndexSnapshot,
                                            SnapshotCorruptError,
                                            SnapshotStore)
from repro_torch.lifecycle.swap import SwapServer
from repro_torch.obs import get_telemetry


class StageFailed(RuntimeError):
    """A lifecycle stage exhausted its retry budget.  ``run_cycle``
    absorbs this into degraded serving when a live server exists;
    without one (bring-up) it propagates to the caller."""

    def __init__(self, stage: str, attempts: int, cause: BaseException):
        super().__init__(f"stage {stage!r} failed after {attempts} "
                         f"attempt(s): {cause}")
        self.stage = stage
        self.attempts = attempts
        self.cause = cause


@dataclasses.dataclass(frozen=True)
class LifecycleConfig:
    """Cadence + serving knobs for the lifecycle runtime.

    ``steps_per_cycle``   training-burst length per hour-level cycle —
                          the compute budget that trades index freshness
                          against step throughput;
    ``publish_every``     cycles between publications (1 = publish every
                          cycle; the graph still refreshes each cycle);
    ``min_recall_ratio``  swap gate: a snapshot must retain at least
                          this fraction of exact-KNN Recall@``recall_k``
                          or the engine keeps serving the old version
                          (0 disables the gate);
    ``min_item_recall_ratio``
                          §5.2.2 gate breadth: the published I2I table
                          must retain this fraction of exact item-
                          ranking recall at its own width (0 disables);
    ``min_codebook_util`` publication-side collapse floor: every RQ
                          layer's published-code utilization must stay
                          above this fraction or the snapshot is
                          rejected (0 disables);
    ``min_hitrate_recon`` §5.2.3 reconstruction-health floor: the RQ
                          reconstruction's hitrate@10 must stay above
                          this value (0 disables) — catches the
                          1.0 -> 0.0 flapping a collapse causes;
    ``repair_attempts``   self-healing: when a gate trips, run up to
                          this many bounded repair bursts (dead-code
                          reset from published occupancy + short
                          re-train + re-publish) instead of only
                          refusing to publish (0 = refuse-only);
    ``repair_steps``      training-burst length of one repair attempt;
    ``i2i_k``             offline I2I KNN width published per item;
    ``queue_len`` / ``recency_s`` / ``ring_capacity``
                          serving-store geometry: cluster ring-buffer
                          depth, recency horizon, and how many raw
                          events are retained for swap-time re-keying;
    ``n_shards``          serving scale-out; only 1 (unsharded) is
                          ported, more raises (``ROADMAP.md`` queue 1
                          item 5);
    ``serving_delta_cap`` the store's delta-buffer depth; only 0 (direct
                          scatter per ingest) is ported, more raises
                          (item 5);
    ``snapshot_keep``     on-disk snapshot retention (when a
                          ``SnapshotStore`` directory is attached);
    ``stage_retries``     fault tolerance: how many times a failed
                          refresh/train/publish/swap stage is retried
                          before the cycle degrades (0 = fail fast);
    ``retry_backoff_s``   base of the exponential retry backoff; the
                          jitter is a tuple-keyed RNG draw, so a seeded
                          run's sleep schedule is bit-reproducible
                          (0 disables sleeping between retries);
    ``stage_deadline_s``  per-stage deadline: an overrun is *detected*
                          (counter + degraded mark) but the result is
                          kept — re-running a completed refresh would
                          merge its delta twice (0 disables);
    ``rollback_on_regression``
                          post-swap health probe: after every flip a
                          small live retrieve must answer from the new
                          version; on regression the server is rolled
                          back to the previous good snapshot;
    ``post_swap_probe``   how many users the post-swap probe retrieves
                          (0 disables the probe).
    """
    steps_per_cycle: int = 50
    batch_per_type: int = 64
    publish_every: int = 1
    min_recall_ratio: float = 0.0
    min_item_recall_ratio: float = 0.0
    min_codebook_util: float = 0.0
    min_hitrate_recon: float = 0.0
    repair_attempts: int = 0
    repair_steps: int = 30
    recall_k: int = 100
    recall_queries: int = 400
    n_probe_factor: int = 4
    i2i_k: int = 16
    queue_len: int = 256
    recency_s: float = 3600.0
    ring_capacity: int = 1 << 16
    n_shards: int = 1
    serving_delta_cap: int = 0
    embed_batch: int = 2048
    encode_chunk: int = 8192
    snapshot_keep: int = 3
    stage_retries: int = 0
    retry_backoff_s: float = 0.0
    stage_deadline_s: float = 0.0
    rollback_on_regression: bool = True
    post_swap_probe: int = 8


class LifecycleRuntime:
    """Owns the mutable stage state and drives refresh -> train ->
    publish -> swap cycles.  ``world`` (a ``SyntheticWorld`` or anything
    with ``day1`` next-day ground truth) is only needed for the recall
    gate; pass ``None`` to publish ungated.  ``device`` holds the stage
    state (CUDA unless ``"cpu"`` is asked for)."""

    def __init__(self, cfg: RankGraph2Config, lcfg: LifecycleConfig,
                 g: HeteroGraph, tables: NeighborTables,
                 user_feat: np.ndarray, item_feat: np.ndarray, *,
                 world: Any = None, snapshot_dir: Optional[str] = None,
                 seed: int = 0, telemetry=None, faults=None,
                 sleep: Optional[Callable[[float], None]] = None,
                 device=None):
        if lcfg.n_shards > 1 or lcfg.serving_delta_cap:
            raise NotImplementedError(
                "n_shards > 1 and serving_delta_cap > 0 are not ported "
                "yet: ROADMAP.md queue 1 item 5")
        self.device = resolve_device(device)
        self.tel = telemetry if telemetry is not None else get_telemetry()
        self.faults = faults if faults is not None else get_faults()
        self._sleep = sleep if sleep is not None else time.sleep
        self.cfg = cfg
        self.lcfg = lcfg
        self.world = world
        self.seed = seed
        self.g = g
        self.tables = tables
        self.user_feat = np.asarray(user_feat, np.float32)
        self.item_feat = np.asarray(item_feat, np.float32)
        self.state, self.optimizer = T.init_state(
            cfg, generator=torch.Generator().manual_seed(seed),
            device=self.device)
        self._features: Optional[T.FeatureStore] = None
        self._step_fn = None         # built by _rebuild_dataset below
        self._features_stale = True
        self.store = (SnapshotStore(snapshot_dir,
                                    keep=lcfg.snapshot_keep,
                                    faults=self.faults,
                                    telemetry=self.tel)
                      if snapshot_dir else None)
        self.server: Optional[SwapServer] = None
        self.cycle = 0
        self.version = 0
        self._last_user_emb: Optional[torch.Tensor] = None
        self._last_item_emb: Optional[torch.Tensor] = None
        # degradation bookkeeping: serving pinned on _last_good while
        # degraded; stale_cycles counts publish-eligible cycles served
        # from an old version
        self.degraded = False
        self.stale_cycles = 0
        self._last_good: Optional[IndexSnapshot] = None
        self._rebuild_dataset()

    # -- stage isolation ----------------------------------------------------

    def _backoff_s(self, stage: str, attempt: int) -> float:
        """Exponential backoff with *deterministic* jitter: the jitter
        factor is a tuple-keyed RNG draw (seed, stage, attempt), so a
        seeded run's retry schedule replays bit-identically."""
        base = self.lcfg.retry_backoff_s
        if base <= 0:
            return 0.0
        j = np.random.default_rng(
            (self.seed, zlib.crc32(stage.encode()), attempt)).random()
        return base * (2.0 ** attempt) * (1.0 + 0.5 * j)

    def _run_stage(self, stage: str, fn: Callable[[], Any]) -> Any:
        """Run one lifecycle stage under the fault-tolerance contract:
        up to ``stage_retries`` keyed-backoff retries on failure, then
        :class:`StageFailed`; a deadline overrun is counted and marks
        the runtime degraded but the completed result is KEPT (re-running
        a refresh that finished late would merge its delta twice).
        :class:`InjectedCrash` (simulated process death) is never
        retried or absorbed."""
        retries = max(self.lcfg.stage_retries, 0)
        deadline = self.lcfg.stage_deadline_s
        tel = self.tel
        for attempt in range(retries + 1):
            t0 = tel.clock.perf() if deadline > 0 else 0.0
            try:
                out = fn()
            except InjectedCrash:
                raise
            except Exception as e:
                tel.counter("lifecycle.stage_failures")
                with tel.span("lifecycle.stage_failure", stage=stage,
                              attempt=attempt, error=str(e)):
                    pass
                if attempt >= retries:
                    raise StageFailed(stage, attempt + 1, e) from e
                wait = self._backoff_s(stage, attempt)
                tel.counter("lifecycle.stage_retries")
                if wait > 0:
                    self._sleep(wait)
                continue
            if deadline > 0 and tel.clock.perf() - t0 > deadline:
                tel.counter("lifecycle.deadline_overruns")
                self._mark_degraded(f"{stage}_deadline")
            return out

    def _mark_degraded(self, reason: str) -> None:
        self.degraded = True
        self.tel.gauge("lifecycle.degraded", 1.0)
        self.tel.counter("lifecycle.degraded_events")
        with self.tel.span("lifecycle.degraded", reason=reason):
            pass

    def _mark_healthy(self) -> None:
        if self.degraded:
            self.tel.counter("lifecycle.recoveries")
        self.degraded = False
        self.stale_cycles = 0
        self.tel.gauge("lifecycle.degraded", 0.0)
        self.tel.gauge("lifecycle.stale_cycles", 0.0)

    def _count_stale_cycle(self) -> None:
        """A publish-eligible cycle ended still serving an old version."""
        if self.server is None:
            return
        self.stale_cycles += 1
        self.tel.counter("lifecycle.stale_cycles")
        self.tel.gauge("lifecycle.stale_cycles", float(self.stale_cycles))

    # -- stage plumbing -----------------------------------------------------

    def _rebuild_dataset(self) -> None:
        # id-only batches gather features inside the step from the
        # device copy of the feature tables; it is made again (and the
        # step rebuilt over it) only when the tables themselves change
        # (id-space growth or in-place edits) — graph/table refreshes
        # alone reuse it
        if self._step_fn is None or self._features_stale:
            dev = self.device
            self._features = T.FeatureStore(
                torch.as_tensor(self.user_feat).to(dev),
                torch.as_tensor(self.item_feat).to(dev))
            self._step_fn = T.make_train_step(self.cfg, self.optimizer,
                                              features=self._features)
            self._features_stale = False
        self.dataset = EdgeDataset(self.tables, self._features.user_feat,
                                   self._features.item_feat,
                                   k_train=self.cfg.k_train,
                                   device=self.device, g=self.g)

    def refresh(self, delta_log: EngagementLog, *,
                user_feat: Optional[np.ndarray] = None,
                item_feat: Optional[np.ndarray] = None,
                backend: Optional[str] = None) -> Dict:
        """Stage 1: splice the trailing window in.  Grown id spaces must
        come with grown feature tables."""
        # models an upstream log-fetch failure: fires before any state
        # mutates, so a retried refresh replays the same delta cleanly
        self.faults.fire("stage.refresh", cycle=self.cycle)
        prev_emb = (host_embeddings(torch.cat([self._last_user_emb,
                                               self._last_item_emb]))
                    if self._last_user_emb is not None else None)
        if user_feat is not None:
            self.user_feat = np.asarray(user_feat, np.float32)
        if item_feat is not None:
            self.item_feat = np.asarray(item_feat, np.float32)
        if user_feat is not None or item_feat is not None:
            # explicit tables may be the same ndarray object mutated in
            # place — always refresh the device-resident FeatureStore
            self._features_stale = True
        # validate BEFORE mutating graph/tables: a failed refresh must
        # leave the runtime consistent (retrying after the error would
        # otherwise merge the same delta's aggregates twice)
        if self.user_feat.shape[0] < delta_log.n_users:
            raise ValueError("user space grew without new user features")
        if self.item_feat.shape[0] < delta_log.n_items:
            raise ValueError("item space grew without new item features")
        if prev_emb is not None and len(prev_emb) != (
                delta_log.n_users + delta_log.n_items):
            prev_emb = None            # id space grew past the last embed
        with self.tel.span("lifecycle.refresh",
                           delta_events=int(len(delta_log.user_id))):
            self.g, self.tables, report = incremental_refresh(
                self.g, self.tables, delta_log, prev_emb=prev_emb,
                backend=backend, device=self.device)
            self._rebuild_dataset()
        return report

    def train_burst(self, steps: Optional[int] = None) -> Dict[str, float]:
        """Stage 2: co-train model + RQ index on the current dataset.

        When ``cfg.rq.reset_every > 0`` the burst interleaves dead-code
        reset passes: every ``reset_every`` steps *and after the final
        step*, codes whose EMA usage fell below the floor are re-seeded
        from high-load clusters' residuals (``rq_index
        .dead_code_reset``).  Each pass embeds a fresh probe — the whole
        embedding cloud translates under contrastive training, so rows
        planted from a stale probe are born dead — and the closing pass
        means a publish right after the burst encodes with a codebook
        adapted to the *current* cloud, not one ``reset_every`` steps
        stale."""
        steps = steps if steps is not None else self.lcfg.steps_per_cycle
        per_type = {et: self.lcfg.batch_per_type
                    for et in ("uu", "ui", "ii")}
        m: Dict[str, Any] = {}
        base = self.state.step
        every = self.cfg.rq.reset_every
        resets = 0
        tel = self.tel
        with tel.span("lifecycle.train", steps=int(steps)):
            for t in range(steps):
                t_step = tel.clock.perf() if tel.enabled else 0.0
                self.faults.fire("train.step", step=base + t)
                batch = self.dataset.sample_batch(base + t, self.seed,
                                                  per_type)
                gen = torch.Generator(self.device).manual_seed(
                    1000 + base + t)
                self.state, m = self._step_fn(self.state, batch,
                                              generator=gen)
                if every > 0 and ((t + 1) % every == 0 or t + 1 == steps):
                    self.state, rep = T.reset_dead_codes(
                        self.state, self._probe_embeddings(base + t + 1),
                        self.cfg, seed=self.seed, step=base + t + 1)
                    resets += sum(rep.values())
                if tel.enabled:
                    tel.observe("train.step_latency_s",
                                tel.clock.perf() - t_step)
            if tel.enabled:
                tel.counter("train.steps", float(steps))
                if resets:
                    tel.counter("train.dead_code_resets", float(resets))
        out = {k: float(v) for k, v in m.items()}
        if every > 0:
            out["dead_code_resets"] = float(resets)
        return out

    def _probe_embeddings(self, step: int) -> torch.Tensor:
        """A keyed-uniform sample of *freshly embedded* nodes for the
        reset pass.  Freshness is load-bearing: the embedding cloud
        drifts coherently under contrastive training (it is rotation-
        invariant; nothing anchors absolute positions), so re-seeding
        from cached corpus embeddings plants rows where the data no
        longer is."""
        n_probe = self.cfg.rq.reset_probe
        nu, ni = self.g.n_users, self.g.n_items
        rng = np.random.default_rng((self.seed, 91, step))
        ids = np.sort(rng.choice(nu + ni, min(n_probe, nu + ni),
                                 replace=False))
        parts = []
        for node_type, sel in ((M.USER, ids[ids < nu]),
                               (M.ITEM, ids[ids >= nu])):
            if len(sel):
                parts.append(T.embed_all(
                    self.state.params, self.cfg, self.dataset,
                    node_type=node_type, ids=sel,
                    batch=min(self.lcfg.embed_batch, len(sel))))
        return torch.cat(parts)

    def embed_corpus(self) -> None:
        nu, ni = self.g.n_users, self.g.n_items
        self._last_user_emb = T.embed_all(
            self.state.params, self.cfg, self.dataset, node_type=M.USER,
            ids=np.arange(nu), batch=self.lcfg.embed_batch)
        self._last_item_emb = T.embed_all(
            self.state.params, self.cfg, self.dataset, node_type=M.ITEM,
            ids=np.arange(nu, nu + ni), batch=self.lcfg.embed_batch)

    def gate_passes(self, snap: IndexSnapshot) -> bool:
        """The swap/persist gate: every enabled floor must hold —
        user-side recall ratio, §5.2.2 item-side recall ratio, the
        published-code utilization (collapse) floor, and the §5.2.3
        reconstruction-hitrate floor."""
        m = snap.metrics
        for gate, key in ((self.lcfg.min_recall_ratio, "recall_ratio"),
                          (self.lcfg.min_item_recall_ratio,
                           "item_recall_ratio"),
                          (self.lcfg.min_codebook_util,
                           "codebook_util_min"),
                          (self.lcfg.min_hitrate_recon,
                           "hitrate10_recon")):
            val = m.get(key)
            if gate > 0 and val is not None and val < gate:
                return False
        return True

    def _failing_gates(self, snap: IndexSnapshot) -> list:
        """The gate keys currently below their floors (repair triggers).

        Mirrors ``gate_passes`` (kept self-contained: tests call it
        unbound against a bare-``lcfg`` namespace)."""
        m = snap.metrics
        failing = []
        for gate, key in ((self.lcfg.min_recall_ratio, "recall_ratio"),
                          (self.lcfg.min_item_recall_ratio,
                           "item_recall_ratio"),
                          (self.lcfg.min_codebook_util,
                           "codebook_util_min"),
                          (self.lcfg.min_hitrate_recon,
                           "hitrate10_recon")):
            val = m.get(key)
            if gate > 0 and val is not None and val < gate:
                failing.append(key)
        return failing

    def repair_burst(self, snap: IndexSnapshot) -> Dict[str, Any]:
        """Self-healing: one bounded repair pass after a tripped gate.

        Deadness is judged from the *published* corpus occupancy of
        ``snap`` (EMA counters can look healthy long after the published
        assignments collapsed — e.g. an injected all-equal codebook),
        dead codes are re-seeded from a keyed-uniform sample of the
        freshly published embeddings, and a short re-train burst
        (``lcfg.repair_steps``) settles the revived codes before the
        caller re-publishes."""
        self.tel.counter("lifecycle.repair_bursts")
        all_codes = np.concatenate([snap.user_codes, snap.item_codes],
                                   axis=0)
        usage = per_code_counts(all_codes, snap.codebook_sizes)
        emb = torch.cat([self._last_user_emb, self._last_item_emb])
        rng = np.random.default_rng((self.seed, 93, self.version))
        n = min(self.cfg.rq.reset_probe, len(emb))
        probe = emb[torch.from_numpy(np.sort(
            rng.choice(len(emb), n, replace=False))).to(emb.device)]
        self.state, resets = T.reset_dead_codes(
            self.state, probe, self.cfg, seed=self.seed,
            step=self.version, usage=usage)
        train = self.train_burst(self.lcfg.repair_steps)
        return dict(resets=resets, train=train)

    def publish(self) -> IndexSnapshot:
        """Stage 3: materialize + gate + persist the next version.

        Gate-failed snapshots are *not* written to the store: the
        on-disk ``latest`` pointer (what a restarted server loads) must
        only ever name a snapshot that passed, and retention must never
        evict a known-good version in favor of rejected ones.
        """
        tel = self.tel
        with tel.span("lifecycle.publish",
                      version=int(self.version + 1)) as sp:
            self.embed_corpus()
            self.version += 1
            snap, recon = build_snapshot(
                self.version, self._last_user_emb, self._last_item_emb,
                self.state.params["rq"], self.cfg,
                i2i_k=self.lcfg.i2i_k, chunk=self.lcfg.encode_chunk,
                want_user_recon=True)
            if self.world is not None:
                metrics = evaluate_snapshot(
                    snap, self._last_user_emb, recon, self.world,
                    recall_k=self.lcfg.recall_k,
                    n_queries=self.lcfg.recall_queries, seed=self.seed,
                    n_probe_factor=self.lcfg.n_probe_factor,
                    hitrate_pairs=self._hitrate_pairs(),
                    item_emb=self._last_item_emb)
            else:
                # ungated publication still carries first-class
                # index-health metrics (utilization + list balance need
                # no eval world)
                metrics = snapshot_health(snap)
            snap = dataclasses.replace(
                snap, gate_metrics=tuple(sorted(
                    (k, float(v)) for k, v in metrics.items())))
            self.faults.fire("gate.eval", version=int(self.version))
            passed = self.gate_passes(snap)
            if tel.enabled:
                for k, v in metrics.items():
                    if isinstance(v, (int, float)):
                        tel.gauge(f"publish.{k}", float(v))
                tel.counter("publish.snapshots")
                if not passed:
                    tel.counter("publish.gate_failures")
            sp.set("gate_passed", bool(passed))
            if self.store is not None and passed:
                self.store.publish(snap)
        return snap

    def _hitrate_pairs(self, n: int = 512) -> np.ndarray:
        """U-U positive pairs for the §5.2.3 index hitrate."""
        uu = self.g.uu
        if len(uu) == 0:
            return np.zeros((0, 2), np.int64)
        rng = np.random.default_rng(self.seed)
        idx = rng.integers(0, len(uu), min(n, len(uu)))
        return np.stack([uu.src[idx], uu.dst[idx]], axis=1)

    def swap(self, snap: IndexSnapshot, now: float) -> Dict[str, float]:
        """Stage 4: flip serving to ``snap`` (or bring serving up)."""
        if self.server is None:
            with self.tel.span("lifecycle.swap", bring_up=True,
                               to_version=int(snap.version)) as sp:
                self.server = SwapServer(
                    snap, queue_len=self.lcfg.queue_len,
                    recency_s=self.lcfg.recency_s,
                    ring_capacity=self.lcfg.ring_capacity,
                    n_shards=self.lcfg.n_shards,
                    delta_cap=self.lcfg.serving_delta_cap,
                    telemetry=self.tel, faults=self.faults,
                    device=self.device)
            return dict(from_version=0.0,
                        to_version=float(snap.version),
                        build_ms=0.0, stall_ms=0.0, replayed_events=0.0,
                        dropped_stale=0.0, ring_dropped=0.0,
                        span_id=float(sp.span_id))
        return self.server.swap_to(snap, now)

    def _post_swap_health(self, snap: IndexSnapshot, now: float) -> bool:
        """Post-flip smoke probe: a small live retrieve must answer from
        the freshly flipped version.  Catches regressions that only
        manifest in the *serving* copy of the snapshot (store build,
        replay, id-space wiring) — the publication gate cannot see
        those.  Returns ``False`` on any probe failure."""
        n = min(self.lcfg.post_swap_probe, snap.n_users)
        if n <= 0 or self.server is None:
            return True
        try:
            self.faults.fire("health.post_swap",
                             version=int(snap.version))
            res, ver = self.server.retrieve_batch(
                np.arange(n), now, min(self.lcfg.recall_k, 8))
            ok = (ver == snap.version and res.shape[0] == n)
            # every serving partition must be wired and answering: a
            # mis-built shard (wrong range, dead sub-table) shows up
            # here even when the probed users all hash to healthy shards
            store = self.server.handle.acquire().store
            parts = store.partitions()
            ok = ok and len(parts) == max(self.lcfg.n_shards, 1)
            ok = ok and all(p.stats()["n_shards"] == 1 for p in parts)
        except InjectedCrash:
            raise
        except Exception as e:
            with self.tel.span("lifecycle.post_swap_probe_error",
                               error=str(e)):
                pass
            ok = False
        if not ok:
            self.tel.counter("lifecycle.post_swap_regressions")
        return ok

    def _rollback(self, now: float) -> Optional[Dict[str, float]]:
        """Roll serving back to the previous good snapshot after a
        post-swap health regression.  Returns the rollback swap report
        (``None`` when there is no previous good version to return to —
        serving stays on the regressed snapshot, degraded)."""
        prev = self._last_good
        if prev is None or self.server is None:
            return None
        with self.tel.span("lifecycle.rollback",
                           to_version=int(prev.version)):
            rep = self.server.swap_to(prev, now)
        self.tel.counter("lifecycle.rollbacks")
        return rep

    def recover_serving(self, now: float = 0.0) -> Optional[int]:
        """Crash recovery: bring serving up from the newest retained
        snapshot that verifies (corrupt versions are quarantined by the
        store walk).  Returns the recovered version, or ``None`` when
        the store is absent or holds no loadable snapshot."""
        if self.store is None:
            return None
        try:
            snap = self.store.load_latest_good()
        except (FileNotFoundError, SnapshotCorruptError):
            return None
        with self.tel.span("lifecycle.recover",
                           version=int(snap.version)):
            self.server = SwapServer(
                snap, queue_len=self.lcfg.queue_len,
                recency_s=self.lcfg.recency_s,
                ring_capacity=self.lcfg.ring_capacity,
                n_shards=self.lcfg.n_shards,
                delta_cap=self.lcfg.serving_delta_cap,
                telemetry=self.tel, faults=self.faults,
                device=self.device)
        self.version = max(self.version, snap.version)
        self._last_good = snap
        self.tel.counter("lifecycle.serving_recovered")
        return int(snap.version)

    # -- the loop -----------------------------------------------------------

    def run_cycle(self, delta_log: Optional[EngagementLog] = None, *,
                  now: float = 0.0,
                  user_feat: Optional[np.ndarray] = None,
                  item_feat: Optional[np.ndarray] = None,
                  backend: Optional[str] = None) -> Dict[str, Any]:
        """One full lifecycle cycle; returns a stage-by-stage report.

        Stage isolation: each stage runs under ``_run_stage``
        (keyed-backoff retries + deadlines).  Once serving is live, a
        stage that exhausts its retries *degrades* the cycle — serving
        stays pinned on the last good snapshot, the failure lands in
        the report and the ``lifecycle.degraded`` gauge — instead of
        propagating.  Before serving exists (bring-up) there is nothing
        to degrade to, so :class:`StageFailed` raises to the caller.
        ``InjectedCrash`` always propagates (simulated process death).
        """
        tel = self.tel
        report: Dict[str, Any] = dict(cycle=self.cycle)
        with tel.span("lifecycle.cycle", cycle=int(self.cycle)):
            failed: Optional[StageFailed] = None
            if delta_log is not None:
                try:
                    r = self._run_stage("refresh", lambda: self.refresh(
                        delta_log, user_feat=user_feat,
                        item_feat=item_feat, backend=backend))
                    report["refresh"] = dict(
                        touched_users=len(r["touched_users"]),
                        touched_items=len(r["touched_items"]),
                        affected_nodes=len(r["affected_nodes"]),
                        refresh_seconds=r["refresh_seconds"])
                except StageFailed as e:
                    if self.server is None:
                        raise
                    failed = e
                    report["refresh"] = dict(failed=True, error=str(e))
            if failed is None:
                try:
                    report["train"] = self._run_stage(
                        "train", self.train_burst)
                except StageFailed as e:
                    if self.server is None:
                        raise
                    failed = e
                    report["train"] = dict(failed=True, error=str(e))
            if self.cycle % max(self.lcfg.publish_every, 1) == 0:
                if failed is not None:
                    # an upstream stage already failed: stay pinned on
                    # the last good snapshot, publish nothing
                    self._mark_degraded(failed.stage)
                    self._count_stale_cycle()
                    report["swap"] = dict(skipped=True, degraded=True,
                                          failed_stage=failed.stage)
                else:
                    report.update(self._publish_and_swap(now))
        self.cycle += 1
        report["degraded"] = self.degraded
        report["stale_cycles"] = self.stale_cycles
        return report

    def _publish_and_swap(self, now: float) -> Dict[str, Any]:
        """The publish-eligible tail of a cycle: publish (+ bounded
        self-healing repair), gate, swap, post-swap health probe with
        rollback.  Every failure path leaves serving pinned on the last
        good snapshot and says so in the returned report."""
        tel = self.tel
        out: Dict[str, Any] = {}
        try:
            snap = self._run_stage("publish", self.publish)
        except StageFailed as e:
            if self.server is None:
                raise
            self._mark_degraded("publish")
            self._count_stale_cycle()
            out["publish"] = dict(failed=True, error=str(e))
            out["swap"] = dict(skipped=True, degraded=True,
                               failed_stage="publish")
            return out
        # self-healing: a tripped gate triggers bounded repair bursts
        # (reset + short re-train + re-publish) so the cycle converges
        # to a publishable index instead of wedging.  The re-publish is
        # a direct call — its span parents under lifecycle.repair.
        attempts = 0
        repairs = []
        while (not self.gate_passes(snap)
               and attempts < self.lcfg.repair_attempts):
            attempts += 1
            trigger = ",".join(self._failing_gates(snap))
            with tel.span("lifecycle.repair",
                          attempt=attempts,
                          trigger=trigger) as rsp:
                rep = self.repair_burst(snap)
                snap = self.publish()
                healed = self.gate_passes(snap)
                n_reset = int(sum(rep["resets"].values()))
                rsp.set("resets", n_reset)
                rsp.set("healed", healed)
                if tel.enabled:
                    tel.counter("lifecycle.repair_resets",
                                float(n_reset))
                    if healed:
                        tel.counter("lifecycle.repair_healed")
            repairs.append(rep)
        if attempts:
            out["repair"] = dict(
                attempts=attempts,
                healed=self.gate_passes(snap),
                resets=[r["resets"] for r in repairs])
        out["publish"] = dict(version=snap.version, **snap.metrics)
        if not self.gate_passes(snap):
            # gate-blocked publish: the stale snapshot keeps serving
            self._count_stale_cycle()
            out["swap"] = dict(
                skipped=True,
                recall_ratio=snap.metrics.get("recall_ratio"),
                item_recall_ratio=snap.metrics.get(
                    "item_recall_ratio"),
                codebook_util_min=snap.metrics.get(
                    "codebook_util_min"),
                hitrate10_recon=snap.metrics.get(
                    "hitrate10_recon"))
            return out
        try:
            out["swap"] = self._run_stage(
                "swap", lambda: self.swap(snap, now))
        except StageFailed as e:
            if self.server is None:
                raise
            self._mark_degraded("swap")
            self._count_stale_cycle()
            out["swap"] = dict(skipped=True, degraded=True,
                               failed_stage="swap", error=str(e))
            return out
        if (self.lcfg.rollback_on_regression
                and not self._post_swap_health(snap, now)):
            rb = self._rollback(now)
            self._mark_degraded("post_swap_health")
            self._count_stale_cycle()
            out["swap"] = dict(out["swap"], rolled_back=True)
            if rb is not None:
                out["rollback"] = rb
            return out
        self._last_good = snap
        self._mark_healthy()
        return out
