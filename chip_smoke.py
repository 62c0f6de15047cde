#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) once on one GPU.

    python3 chip_smoke.py [--seed 0]

Phase 0 prints the card (``nvidia-smi`` name and power limit) and
builds every CUDA kernel from ``src/repro_torch/csrc`` with nvcc.
Phase 1 holds each kernel against its plain PyTorch version on the
card, at the shapes the main path gives it, and times both with CUDA
events.  Phase 2 runs the publish-and-serve path at the full width of
the ``rankgraph2`` configuration (bf16 compute, d 256, 4 heads, hidden
1024, K_IMP 50, K' 10, RQ codebooks 5000 x 50 = 250,000 clusters) on
1,048,576 users and 262,144 items with random weights from ``--seed``:
``embed_all`` for both node types, ``build_snapshot`` (rq_assign
kernel), a ``ClusterQueueStore`` fed 8,388,608 events over two hours,
then ``serve_batch`` (queue_gather kernel) for 8 batches of 512 requests
and one of 262,144, and checks what comes out.  The kernels' launch
counts are zeroed just before Phase 2 and read just after it.

The second-to-last line is a JSON object listing every ported kernel
(launches on the main path, error against the plain version, times and
the card's bound); the last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or without the rest of
the repository beside it, the script fails before printing any result.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs.base import RANKGRAPH2_SHAPES  # noqa: E402
from repro_torch.configs.rankgraph2 import CONFIG  # noqa: E402
from repro_torch.core import model as M  # noqa: E402
from repro_torch.core.rq_index import init_rq  # noqa: E402
from repro_torch.core.serving import ClusterQueueStore  # noqa: E402
from repro_torch.core.trainer import embed_all  # noqa: E402
from repro_torch.data.edge_dataset import (EdgeDataset,  # noqa: E402
                                           NeighborTables)
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.queue_gather import queue_gather as QG  # noqa: E402
from repro_torch.kernels.queue_gather.ref import (  # noqa: E402
    dup_of_earlier, queue_gather_ref, ring_window)
from repro_torch.kernels.rq_assign import rq_assign as RQA  # noqa: E402
from repro_torch.kernels.rq_assign.ref import rq_assign_ref  # noqa: E402
from repro_torch.lifecycle.publish import (build_snapshot,  # noqa: E402
                                           snapshot_health)

N_USERS, N_ITEMS = 1_048_576, 262_144
N_EVENTS, INGEST_BATCH, SPAN_S = 8_388_608, 65_536, 7200.0
QUEUE_LEN, RECENCY_S, N_RECENT, K_UNION, I2I_K = 256, 3600.0, 8, 32, 16
SHAPES = {s.name: s.dims for s in RANKGRAPH2_SHAPES}
P99_BATCH = SHAPES["serve_p99"]["batch"]       # 512
BULK_BATCH = SHAPES["serve_bulk"]["batch"]     # 262,144
P99_REPS = 8
RQ_ROWS = 65_536             # rq_assign_corpus chunk on the main path
QG_CLUSTERS = 250_000        # 5000 x 50 RQ clusters
NEAR_TIE = 1e-4              # |d2 gap| <= NEAR_TIE * (1 + |d2|)


def card_peaks(name: str):
    """(FP32 FLOP/s without tensor cores, memory bytes/s) from NVIDIA's
    data sheets for the card ``nvidia-smi`` names."""
    if "H100" in name and "PCIe" in name:
        return 51.2e12, 2.0e12
    if "H100" in name and "NVL" in name:
        return 60.0e12, 3.9e12
    if "H200" in name:
        return 67.0e12, 4.8e12
    if "H100" in name:
        return 67.0e12, 3.35e12               # SXM
    raise RuntimeError(f"no data-sheet peaks for {name!r}")


def time_ms(fn, reps: int) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs, after one
    warm-up run."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# Phase 1: each kernel against its plain version
# ---------------------------------------------------------------------------

def phase1_rq_assign(g: torch.Generator, dev, peaks) -> dict:
    d = CONFIG.d_embed
    x = torch.randn((RQ_ROWS, d), generator=g, device=dev)
    x = x / x.norm(dim=1, keepdim=True)
    books = [torch.randn((n, d), generator=g, device=dev) * (0.1 / (l + 1))
             for l, n in enumerate(CONFIG.rq.codebook_sizes)]
    ck, rk = RQA.rq_assign(x, books)
    cp, rp = rq_assign_ref(x, books)
    torch.cuda.synchronize()
    same = (ck == cp).all(dim=1)
    # every differing row must be a near-tie at its first differing layer
    near = 0
    for row in torch.nonzero(~same).flatten().tolist():
        r = x[row].double()
        for l, C in enumerate(books):
            a, b = int(ck[row, l]), int(cp[row, l])
            if a != b:
                da = float(((r - C[a].double()) ** 2).sum())
                db = float(((r - C[b].double()) ** 2).sum())
                check(abs(da - db) <= NEAR_TIE * (1 + abs(db)),
                      f"rq_assign row {row} layer {l}: code {a} (d2 {da}) "
                      f"vs plain {b} (d2 {db}) is not a near-tie")
                near += 1
                break
            r = r - C[a].double()
    err = float((rk[same] - rp[same]).abs().max()) if same.any() else 0.0
    check(err <= 1e-6, f"rq_assign recon differs on matching rows: {err}")
    # exact ties: copy the most used layer-0 code to the last index; every
    # row that picked it must keep the lower index
    last = books[0].shape[0] - 1
    top = int(torch.mode(ck[:, 0][ck[:, 0] < last]).values)
    tied = [b.clone() for b in books]
    tied[0][last] = tied[0][top]
    ct, _ = RQA.rq_assign(x, tied)
    n_tied = int((ct[:, 0] == top).sum())
    check(n_tied > 0 and not bool((ct[:, 0] == last).any()),
          "rq_assign does not break exact ties to the lowest index")
    ms = time_ms(lambda: RQA.rq_assign(x, books), 10)
    plain_ms = time_ms(lambda: rq_assign_ref(x, books), 3)
    n_sum = sum(CONFIG.rq.codebook_sizes)
    L = len(books)
    ops = 2.0 * RQ_ROWS * d * n_sum
    nbytes = 4.0 * (2 * RQ_ROWS * d + n_sum * d + RQ_ROWS * L)
    bound_ms = max(ops / peaks[0], nbytes / peaks[1]) * 1e3
    bound_by = "operations" if ops / peaks[0] >= nbytes / peaks[1] \
        else "bytes"
    print(f"[phase1] rq_assign rows={RQ_ROWS} books={CONFIG.rq.codebook_sizes}"
          f" near_tie_rows={near} recon_max_abs_err={err:.3g} "
          f"exact_tie_rows={n_tied} (lowest index kept) "
          f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"bound_ms={bound_ms:.4f} ({bound_by})")
    return dict(name="rq_assign", route="cuda",
                source="src/repro_torch/csrc/rq_assign.cu",
                replaces="src/repro/kernels/rq_assign/rq_assign.py:74",
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def queue_gather_bytes(items, times, cursor, clusters, i2i, cutoff,
                       R, k) -> float:
    """Bytes the function needs on this data: the ring entries up to the
    R-th seed (or the fill), each seed's I2I row, cursor and cluster id
    per request, and the outputs."""
    it, valid = ring_window(items, times, cursor, clusters, cutoff)
    valid = valid & ~dup_of_earlier(it, valid)
    cnt = valid.cumsum(dim=1)
    C, Q = items.shape
    known = (clusters >= 0) & (clusters < C)
    fill = torch.where(known, cursor[clusters.clamp(0, C - 1).long()]
                       .clamp(max=Q), 0)
    reached = cnt >= R
    scanned = torch.where(reached.any(dim=1),
                          reached.to(torch.int32).argmax(dim=1) + 1, fill)
    seeds = torch.where(valid & (cnt <= R), it, -1)
    rows = ((seeds >= 0) & (seeds < i2i.shape[0])).sum()
    B = clusters.shape[0]
    return float(8 * scanned.sum() + 4 * i2i.shape[1] * rows
                 + B * (8 + 4 * (R + k)))


def phase1_queue_gather(g: torch.Generator, dev, peaks) -> dict:
    C, Q, N, K = QG_CLUSTERS, QUEUE_LEN, N_ITEMS, I2I_K
    # half the rings draw from a ~300-item window (duplicate-heavy), half
    # from the whole space; 1% of ids are past the I2I table; 5% are -1
    base = torch.randint(0, N, (C, 1), generator=g, device=dev)
    narrow = (base + torch.randint(0, 300, (C, Q), generator=g, device=dev)) % N
    wide = torch.randint(0, N + N // 100, (C, Q), generator=g, device=dev)
    dup_heavy = torch.rand((C, 1), generator=g, device=dev) < 0.5
    items = torch.where(dup_heavy, narrow, wide)
    items = torch.where(torch.rand((C, Q), generator=g, device=dev) < 0.05,
                        -1, items).to(torch.int32)
    times = torch.rand((C, Q), generator=g, device=dev) * SPAN_S
    cursor = torch.randint(0, 3 * Q, (C,), generator=g, device=dev,
                           dtype=torch.int32)
    i2i = torch.randint(-1, N, (N, K), generator=g, device=dev,
                        dtype=torch.int32)
    cutoff = SPAN_S - RECENCY_S
    out = {}
    for B in (P99_BATCH, 4096, BULK_BATCH):
        cl = torch.randint(0, C, (B,), generator=g, device=dev,
                           dtype=torch.int32)
        cl[:: 97] = -1                                  # unknown users
        sk, uk = QG.queue_gather(items, times, cursor, cl, i2i,
                                 cutoff=cutoff, n_recent=N_RECENT, k=K_UNION)
        sp, up = queue_gather_ref(items, times, cursor, cl, i2i,
                                  cutoff=cutoff, n_recent=N_RECENT,
                                  k=K_UNION)
        torch.cuda.synchronize()
        err = max(int((sk - sp).abs().max()), int((uk - up).abs().max()))
        check(torch.equal(sk, sp) and torch.equal(uk, up),
              f"queue_gather differs from its plain version at B={B}")
        ms = time_ms(lambda: QG.queue_gather(
            items, times, cursor, cl, i2i, cutoff=cutoff,
            n_recent=N_RECENT, k=K_UNION), 20)
        plain_ms = time_ms(lambda: queue_gather_ref(
            items, times, cursor, cl, i2i, cutoff=cutoff,
            n_recent=N_RECENT, k=K_UNION), 3)
        nbytes = queue_gather_bytes(items, times, cursor, cl, i2i, cutoff,
                                    N_RECENT, K_UNION)
        bound_ms = nbytes / peaks[1] * 1e3
        print(f"[phase1] queue_gather C={C} Q={Q} B={B} R={N_RECENT} "
              f"k={K_UNION} K={K} bitwise_equal=True kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.5f} (bytes "
              f"{nbytes:.0f})")
        out[B] = (err, ms, plain_ms, bound_ms)
    err, ms, plain_ms, bound_ms = out[BULK_BATCH]
    return dict(name="queue_gather", route="cuda",
                source="src/repro_torch/csrc/queue_gather.cu",
                replaces="src/repro/kernels/queue_gather/queue_gather.py:134",
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes", library_ms=None)


# ---------------------------------------------------------------------------
# Phase 2: the publish-and-serve slice at full width
# ---------------------------------------------------------------------------

def make_world(seed: int, n_users: int, n_items: int, k_imp: int):
    """Features and padded K_IMP neighbour tables (global ids, -1 at the
    tail of rows with fewer than K_IMP neighbours), from numpy."""
    rng = np.random.default_rng(seed)
    cfg = CONFIG
    user_feat = rng.standard_normal((n_users, cfg.d_user_feat), np.float32)
    item_feat = rng.standard_normal((n_items, cfg.d_item_feat), np.float32)
    n = n_users + n_items
    cols = np.arange(k_imp)[None, :]
    user_nbrs = rng.integers(0, n_users, (n, k_imp), dtype=np.int32)
    user_nbrs[cols >= rng.integers(5, k_imp + 1, n)[:, None]] = -1
    item_nbrs = rng.integers(n_users, n, (n, k_imp), dtype=np.int32)
    item_nbrs[cols >= rng.integers(5, k_imp + 1, n)[:, None]] = -1
    tables = NeighborTables(user_nbrs, item_nbrs, n_users, n_items)
    return tables, user_feat, item_feat


def phase2(seed: int, dev) -> dict:
    cfg = CONFIG
    secs = {}
    t = time.perf_counter()
    tables, user_feat, item_feat = make_world(seed, N_USERS, N_ITEMS,
                                              cfg.k_imp)
    g = torch.Generator().manual_seed(seed)
    params = M.init_params(cfg, generator=g, device=dev)
    rq = init_rq(cfg.rq, cfg.d_embed, generator=g, device=dev)
    ds = EdgeDataset(tables, user_feat, item_feat, k_train=cfg.k_train,
                     device=dev)
    torch.cuda.synchronize()
    secs["setup"] = time.perf_counter() - t

    torch.cuda.reset_peak_memory_stats()
    common.reset_launches()                  # main path starts here
    t = time.perf_counter()
    user_ids = np.arange(N_USERS)
    user_emb = embed_all(params, cfg, ds, node_type=M.USER, ids=user_ids)
    item_emb = embed_all(params, cfg, ds, node_type=M.ITEM,
                         ids=N_USERS + np.arange(N_ITEMS))
    torch.cuda.synchronize()
    secs["embed_all"] = time.perf_counter() - t

    t = time.perf_counter()
    snap = build_snapshot(1, user_emb, item_emb, rq, cfg, i2i_k=I2I_K)
    secs["build_snapshot"] = time.perf_counter() - t

    t = time.perf_counter()
    store = ClusterQueueStore(snap.user_clusters, queue_len=QUEUE_LEN,
                              recency_s=RECENCY_S,
                              n_clusters=snap.n_clusters, device=dev)
    rng = np.random.default_rng(seed + 1)
    t0 = 1.7e9
    n_batches = N_EVENTS // INGEST_BATCH
    dt = SPAN_S / n_batches
    for b in range(n_batches):
        ts = t0 + dt * (b + np.sort(rng.random(INGEST_BATCH)))
        store.ingest(rng.integers(0, N_USERS, INGEST_BATCH),
                     rng.integers(0, N_ITEMS, INGEST_BATCH), ts)
    torch.cuda.synchronize()
    secs["ingest"] = time.perf_counter() - t

    now = t0 + SPAN_S
    p99_s, results = [], []
    for _ in range(P99_REPS):
        users = rng.integers(0, N_USERS, P99_BATCH)
        t = time.perf_counter()
        s, u = store.serve_batch(users, now, n_recent=N_RECENT, k=K_UNION,
                                 i2i=snap.i2i)
        p99_s.append(time.perf_counter() - t)
        results.append((users, s, u))
    users = rng.integers(0, N_USERS, BULK_BATCH)
    users[:: 1009] = N_USERS + 5                # post-snapshot ids
    t = time.perf_counter()
    s, u = store.serve_batch(users, now, n_recent=N_RECENT, k=K_UNION,
                             i2i=snap.i2i)
    secs["serve_bulk"] = time.perf_counter() - t
    results.append((users, s, u))
    launches = common.launch_counts()        # main path ends here
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    secs["serve_p99_max"] = max(p99_s)

    # --- checks --------------------------------------------------------
    check(tuple(user_emb.shape) == (N_USERS, cfg.d_embed)
          and tuple(item_emb.shape) == (N_ITEMS, cfg.d_embed),
          "embedding shapes")
    for e in (user_emb, item_emb):
        check(bool(torch.isfinite(e).all()), "non-finite embeddings")
        nrm = e.float().norm(dim=1)
        check(bool(((nrm - 1).abs() < 2e-2).all()),
              "primary embeddings are not unit norm")
    # bf16 on the card vs f32 on the CPU for the first chunk's first rows
    cpu_ds = EdgeDataset(tables, user_feat, item_feat,
                         k_train=cfg.k_train, device="cpu")
    chunk = user_ids[:4096]                 # embed_all's first padded chunk
    chunk = np.r_[chunk, np.repeat(chunk[-1:], 4096 - len(chunk))]
    side = cpu_ds.node_inference_batch(chunk)
    side = {k_: v[:256] for k_, v in side.items()}
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    ref = M.embed_side(copy.deepcopy(params).cpu(), cfg32, side, M.USER)[1]
    emb_err = float((user_emb[:256].float().cpu() - ref).abs().max())
    check(emb_err <= 5e-2, f"card bf16 vs CPU f32 embeddings: {emb_err}")

    n_cl = snap.n_clusters
    check(snap.user_clusters.min() >= 0 and snap.user_clusters.max() < n_cl,
          "cluster ids out of range")
    check(int(snap.member_ptr[-1]) == N_USERS, "member CSR size")
    i2i = snap.i2i
    check(i2i.shape == (N_ITEMS, I2I_K) and i2i.min() >= 0
          and i2i.max() < N_ITEMS, "i2i range")
    check(not (i2i == np.arange(N_ITEMS)[:, None]).any(), "i2i self hits")
    health = snapshot_health(snap)

    st = store._state
    i2i_dev = torch.as_tensor(i2i).to(dev, torch.int32)
    cutoff = store.rel_cutoff(now)
    for users, s, u in results:
        cl, known = store.clusters_of(users)
        cl_t = torch.as_tensor(np.where(known, cl, -1).astype(np.int32)
                               ).to(dev)
        s_t = torch.as_tensor(s).to(dev)
        u_t = torch.as_tensor(u).to(dev)
        check(bool(((s_t >= -1) & (s_t < N_ITEMS)).all())
              and bool(((u_t >= -1) & (u_t < N_ITEMS)).all()),
              "ids out of range")
        check(bool((s_t[~torch.as_tensor(known).to(dev)] == -1).all()),
              "unknown users got seeds")
        live_it, live = ring_window(st["items"], st["times"], st["total"],
                                    cl_t, cutoff)
        in_ring = ((s_t[:, :, None] == live_it[:, None, :])
                   & live[:, None, :]).any(dim=2)
        check(bool((in_ring | (s_t < 0)).all()),
              "a seed is not a live item of its cluster's ring")
        check(bool(((u_t[:, :, None] != s_t[:, None, :])
                    | (u_t[:, :, None] < 0)).all()), "union holds a seed")
        srt = torch.sort(u_t, dim=1).values
        check(bool(((srt[:, 1:] != srt[:, :-1]) | (srt[:, 1:] < 0)).all()),
              "union holds a duplicate")
    # one serve_p99 batch against the plain version on the same snapshot
    users, s, u = results[0]
    cl, known = store.clusters_of(users)
    sp, up = queue_gather_ref(
        st["items"], st["times"], st["total"],
        torch.as_tensor(np.where(known, cl, -1).astype(np.int32)).to(dev),
        i2i_dev, cutoff=cutoff, n_recent=N_RECENT, k=K_UNION)
    check(np.array_equal(s, sp.cpu().numpy())
          and np.array_equal(u, up.cpu().numpy()),
          "served batch differs from the plain version")
    filled = float((s[:, 0] >= 0).mean())
    for name in ("rq_assign", "queue_gather"):
        check(launches.get(name, 0) > 0,
              f"{name} was not launched on the main path")
    print(f"[phase2] n_users={N_USERS} n_items={N_ITEMS} "
          f"n_clusters={n_cl} events={N_EVENTS} "
          f"seconds={json.dumps({k_: round(v, 4) for k_, v in secs.items()})}")
    print(f"[phase2] serve_p99 batch={P99_BATCH} seconds per batch="
          f"{[round(v, 5) for v in p99_s]}; serve_bulk batch={BULK_BATCH} "
          f"rows with a seed={filled:.4f}; store={store.stats()}")
    print(f"[phase2] snapshot_health={json.dumps(health)}")
    print(f"[phase2] embed card-bf16 vs cpu-f32 max_abs_err={emb_err:.4g}; "
          f"peak device memory {peak_gb:.3f} GB; launches={launches}")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    peaks = card_peaks(name)
    print(f"[phase0] torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi)
    t = time.perf_counter()
    logs = common.build(["rq_assign", "queue_gather"])
    print(f"[phase0] built {sorted(logs)} in "
          f"{time.perf_counter() - t:.2f} s")
    for kname, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[phase0] {kname}: {line.strip()}")

    g = torch.Generator(device=dev).manual_seed(args.seed)
    rows = [phase1_rq_assign(g, dev, peaks), phase1_queue_gather(g, dev, peaks)]
    launches = phase2(args.seed, dev)
    for r in rows:
        r["launches"] = launches[r["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
