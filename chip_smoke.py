#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) once on one GPU.

    python3 chip_smoke.py [--seed 0]

Phase 0 prints the card (``nvidia-smi`` name and power limit) and
builds every CUDA kernel from ``src/repro_torch/csrc`` with nvcc, one
process per source, all at once.  Phase 1 holds each kernel against its
plain PyTorch version on the card, at the shapes the main path gives it,
and times both with CUDA events.

Phase 2 runs the publish-and-serve path at the full width of the
``rankgraph2`` configuration (bf16 compute, d 256, 4 heads, hidden
1024, K_IMP 50, K' 10, RQ codebooks 5000 x 50 = 250,000 clusters) on
1,048,576 users and 262,144 items with random weights from ``--seed``:
``embed_all`` for both node types, ``build_snapshot`` (rq_assign
kernel), a ``ClusterQueueStore`` fed 8,388,608 events over two hours,
then ``serve_batch`` (queue_gather kernel) for 8 batches of 512 requests
and one of 262,144, and checks what comes out.

Phase 3 runs the construct-and-train path, ``run_pipeline``, at the same
width on a topic-clustered one-day log of 262,144 users and 65,536
items made with numpy: ``build_graph`` on the host, the PPR tables
(ppr_walk kernel, 4,096 starts per launch), 20 train steps of 10,922
edges per type (the fused_contrastive forward and backward kernels, 7
of each per step), then ``embed_all`` and ``assign_codes`` (rq_assign).
It checks the traces and tables against the numpy walker and top-k, the
losses, that every parameter moved, the launch counts, one step's
losses on the card against the CPU, and the embeddings.  In f32 it runs
four steps from the initial state on the card and on the CPU with the
same batches and draws, which must agree step by step, and the main
path's 20 steps again on the card, whose first step must agree with the
bf16 run's; it prints both runs' trajectories.

Phase 4 runs the recsys serve-and-train path at the full width of
``dlrm-rm2`` (13 dense, 26 sparse fields, embed 64, MLPs 13-512-256-64
and 415-512-512-256-1, bf16 compute, f32 params) with random weights
from ``--seed``: 26 tables of 10,000,000 rows (66.56 GB) fed multi-hot
bags (lengths uniform in 1..16, ids uniform; the config is single-hot,
and the bags are made up to drive the kernel), 8 serve_p99 batches of
512 and one serve_bulk batch of 262,144 (embedding_bag forward kernel),
one retrieval query against 1,000,000 candidates, then 20 train steps
of 65,536 rows at a vocab cut to 1,000,000 per field (embedding_bag
forward and backward kernels); wide-deep, sasrec and bst serve one
serve_bulk batch each.  It checks 512 bulk logits, spread evenly over
the batch, against the CPU on only the rows they touch, the top 100 against the CPU ranking,
that the losses are finite and every parameter moved, and four f32
steps on the card against the CPU.

Phase 5 runs the dense LM serve path at the full width of
``llama3.2-3b`` (28 layers, d 3,072, 24 query heads over 8 KV heads,
head dim 128, ff 8,192, vocab 128,256, f32 params, bf16 compute) with
random weights from ``--seed``: prefill at 32,768 tokens (B 1, cut from
32), 16 greedy decode steps from its cache, one decode_32k step at B 8
(cut from 128) on a random cache filled to 32,767, and one long_500k step
on a random cache of 524,288 positions (60.1 GB beside 14.43 GB of
params: the stage needs the whole 80 GB card); then ``gemma-2b`` at full
width (18 layers, MQA, head dim 256) prefills 8,192 tokens and decodes
16.  The bf16 attention runs on the tensor-core kernels: prefill on
``flash_attention`` (wgmma, head dims 128 and gemma's 256),
decode on ``flash_attention_decode`` with a split kv range (partials,
then ``flash_attention_merge``); the f32 check runs
``flash_attention_f32``.  It checks shapes and finite values, the launch
counts by kernel, llama at 2 layers card vs CPU in f32 (prefill logits,
caches, one decode step within 1e-3), and the prefill/decode consistency
on the card in bf16.

Each path's launch counts are zeroed just before it runs and read just
after: ``rq_assign`` and ``queue_gather`` report Phase 2's,
``ppr_walk`` and ``fused_contrastive_*`` Phase 3's, ``embedding_bag_*``
Phase 4's serve and train stages, ``flash_attention*`` Phase 5's serve
stages.

The second-to-last line is a JSON object listing every ported kernel
(launches on the main path, error against the plain version, times and
the card's bound); the last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or without the rest of
the repository beside it, the script fails before printing any result.
"""
from __future__ import annotations

import argparse
import copy
import ctypes
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

from repro_torch.configs.base import (LM_SHAPES,  # noqa: E402
                                      RANKGRAPH2_SHAPES, RECSYS_SHAPES,
                                      get_arch)
from repro_torch.configs.rankgraph2 import CONFIG  # noqa: E402
from repro_torch.core import model as M  # noqa: E402
from repro_torch.core.graph_builder import EngagementLog  # noqa: E402
from repro_torch.core.negatives import negative_draws  # noqa: E402
from repro_torch.core.pipeline import run_pipeline  # noqa: E402
from repro_torch.core.ppr import (_topk_from_counts,  # noqa: E402
                                  _walk_device, _walk_numpy,
                                  adjacency_to_device,
                                  build_padded_hetero_adj,
                                  global_visit_mass)
from repro_torch.core.rq_index import init_rq  # noqa: E402
from repro_torch.core.serving import ClusterQueueStore  # noqa: E402
from repro_torch.core.trainer import (FeatureStore, embed_all,  # noqa: E402
                                      forward_losses, init_state,
                                      loss_directions, make_train_step)
from repro_torch.data.edge_dataset import (EdgeDataset,  # noqa: E402
                                           NeighborTables)
from repro_torch.data.synthetic import SyntheticWorld  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.embedding_bag import (  # noqa: E402
    embedding_bag as EB)
from repro_torch.kernels.embedding_bag.ref import (  # noqa: E402
    embedding_bag_bwd_ref, embedding_bag_ref)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention as FA, ops as FA_OPS)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_ref, chunked_attention_ref, merge_ref)
from repro_torch.kernels.fused_contrastive import (  # noqa: E402
    fused_contrastive as FC)
from repro_torch.kernels.fused_contrastive.ref import (  # noqa: E402
    bwd_ref, fwd_ref)
from repro_torch.kernels.ppr_walk import ppr_walk as PW  # noqa: E402
from repro_torch.kernels.ppr_walk.ref import (  # noqa: E402
    last_valid_cols as ppr_last_valid_cols, ppr_walk_ref)
from repro_torch.kernels.queue_gather import queue_gather as QG  # noqa: E402
from repro_torch.kernels.queue_gather.ref import (  # noqa: E402
    dup_of_earlier, queue_gather_ref, ring_window)
from repro_torch.kernels.rq_assign import rq_assign as RQA  # noqa: E402
from repro_torch.kernels.rq_assign.ref import rq_assign_ref  # noqa: E402
from repro_torch.launch.steps import (lm_decode_step,  # noqa: E402
                                      lm_prefill_step, recsys_retrieval_step,
                                      recsys_serve_step, recsys_train_step,
                                      top_k)
from repro_torch.lifecycle.publish import (build_snapshot,  # noqa: E402
                                           snapshot_health)
from repro_torch.models.lm import model as LM  # noqa: E402
from repro_torch.models.recsys import models as R  # noqa: E402
from repro_torch.optim.optimizers import rankgraph2_optimizer  # noqa: E402

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
PPR_DEG = 32                 # max_deg_per_type: D2 = 64
PPR_STARTS = 4096            # starts per walk chunk on the main path
PPR_NODES = 1_310_720        # adjacency rows of the Phase 1 walk
BIG_NODES = (1 << 24) + 4096  # a walk over ids above 2^24
CF_ROWS = SHAPES["train_batch"]["batch"] // 3   # edges per type: 10,922
SLICE1 = ("rq_assign", "queue_gather")  # their launches: Phase 2's path
P3_USERS, P3_ITEMS = 262_144, 65_536
N_TOPICS, EVENTS_PER_USER, HOME_SHARE = 1024, 30, 0.8
P3_STEPS, P3_POOL = 20, 8192
CHECK_ROWS = 1024            # edges per type of the card-vs-CPU steps
CARD_CPU_REL, CARD_CPU_ABS = 5e-2, 1e-2   # bf16 vs f32 losses
F32_REL, F32_RQ_REL, F32_ABS = 1e-3, 1e-2, 1e-3  # f32 card vs f32 CPU
F32_STEPS = 4                # steps of the f32 card-vs-CPU trajectory
DST_TYPE = {"uu": "user", "ui": "item", "iu": "user", "ii": "item"}
DLRM = get_arch("dlrm-rm2").config   # bf16 compute, f32 params, embed 64
RS = {s.name: s.dims for s in RECSYS_SHAPES}
RS_P99, RS_BULK = RS["serve_p99"]["batch"], RS["serve_bulk"]["batch"]
RS_TRAIN = RS["train_batch"]["batch"]                     # 65,536
RS_CAND = RS["retrieval_cand"]["n_candidates"]            # 1,000,000
BAG = 16                     # ids per multi-hot bag (lengths 1..BAG)
EB_ROWS = DLRM.n_sparse * DLRM.default_vocab      # 2.6e8 flat table rows
EB_BWD_ROWS = 40_000_000     # backward table: 2.56e9 elements > 2^31
BIG_ID = 1 << 24             # the TPU kernel's one-hot id cap
TRAIN_VOCAB = 1_000_000      # per field in Phase 4's train stage
CHECK_VOCAB, CHECK_BATCH = 100_000, 1024   # Phase 4's f32 card-vs-CPU steps
P4_STEPS, P4_F32_STEPS = 20, 4
P4_REL = 2.0 ** -5           # bf16 logits: card vs CPU, of the largest
# parameters after the f32 card-vs-CPU steps, as tests/test_torch_recsys.py
# holds them: median gap, and the share of entries beyond PARAM_FAR
PARAM_MEDIAN, PARAM_FAR, PARAM_FAR_SHARE = 1e-4, 1e-3, 0.01
LLAMA = get_arch("llama3.2-3b").config  # bf16 compute, f32 params
GEMMA = get_arch("gemma-2b").config
LM_SH = {s.name: s.dims for s in LM_SHAPES}
P5_PREFILL_B = 1             # prefill_32k's batch, cut from 32
P5_DECODE_B = 8              # decode_32k's batch, cut from 128
GEN_STEPS = 16               # greedy decode steps after a prefill
P5_DECODE_REPS, P5_LONG_REPS = 3, 2
P5_GEMMA_SEQ = 8192          # gemma-2b's prefill length
CHECK_LM_B, CHECK_LM_S = 2, 256   # Phase 5's f32 card-vs-CPU check
CARD_CPU_LM_REL = 1e-3       # f32 logits and caches: card vs CPU
BF16_LM_TOL = 5e-2           # bf16 prefill/decode consistency, of the largest


def card_peaks(name: str):
    """(FP32 FLOP/s without tensor cores, memory bytes/s, dense bf16
    tensor-core FLOP/s) from NVIDIA's data sheets for the card
    ``nvidia-smi`` names."""
    if "H100" in name and "PCIe" in name:
        return 51.2e12, 2.0e12, 756e12
    if "H100" in name and "NVL" in name:
        return 60.0e12, 3.9e12, 835e12
    if "H200" in name:
        return 67.0e12, 4.8e12, 989e12
    if "H100" in name:
        return 67.0e12, 3.35e12, 989e12       # SXM
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


def close(a: torch.Tensor, b: torch.Tensor, rel: float) -> bool:
    """``|a - b| <= rel * |b| + 1e-4 * max|b|`` everywhere: relative to
    each entry, with a floor at 1e-4 of the tensor's largest magnitude for
    the entries that cancel to near zero."""
    a, b = a.float(), b.float()
    return bool(((a - b).abs() <= rel * b.abs() + 1e-4 * b.abs().max()
                 ).all())


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


def random_adjacency(g: torch.Generator, N: int, D2: int, dev, *,
                     lo: int = 0, rows: int = 1 << 20):
    """(N, D2) int32 ids in [lo, N) with random degrees (a tenth of the
    rows dangling, -1 tails) and their f32 cum rows, a third of them
    scaled to top out below 1.  Filled ``rows`` rows at a time."""
    nbrs = torch.empty((N, D2), dtype=torch.int32, device=dev)
    cum = torch.empty((N, D2), dtype=torch.float32, device=dev)
    cols = torch.arange(D2, device=dev)
    for r0 in range(0, N, rows):
        r1 = min(N, r0 + rows)
        n = r1 - r0
        deg = torch.randint(0, D2 + 1, (n,), generator=g, device=dev)
        deg[torch.rand(n, generator=g, device=dev) < 0.1] = 0
        mask = cols[None, :] < deg[:, None]
        ids = torch.randint(lo, N, (n, D2), generator=g, device=dev,
                            dtype=torch.int32)
        nbrs[r0:r1] = torch.where(mask, ids, -1)
        c = torch.where(mask, torch.rand((n, D2), generator=g, device=dev),
                        0.0).cumsum(dim=1)
        c = c / c[:, -1:].clamp_min(1e-12)
        short = torch.rand((n, 1), generator=g, device=dev) < 1 / 3
        cum[r0:r1] = torch.where(short, c * 0.97, c)
    return nbrs, cum


def ppr_walk_bytes(n: int, W: int, L: int) -> float:
    """Bytes the walk needs: the uniforms and starts read once, visited
    and counts written once, and per walker step one cum value and one
    id of the walker's row."""
    return float(4 * n * W * 2 * L + 4 * n + 2 * 4 * n * W * L
                 + 8 * n * W * L)


def phase1_ppr_walk(g: torch.Generator, dev, peaks) -> dict:
    W, L, D2 = CONFIG.ppr_walks, CONFIG.ppr_len, 2 * PPR_DEG
    restart = CONFIG.ppr_restart
    out = {}
    for case, N, lo in (("1.3M nodes", PPR_NODES, 0),
                        ("ids above 2^24", BIG_NODES, 1 << 24)):
        nbrs, cum = random_adjacency(g, N, D2, dev, lo=lo)
        last = ppr_last_valid_cols(cum)
        starts = torch.randint(lo, N, (PPR_STARTS,), generator=g,
                               device=dev, dtype=torch.int32)
        u = torch.rand((PPR_STARTS, W, 2 * L), generator=g, device=dev)
        vk, ck = PW.ppr_walk(nbrs, cum, last, starts, u, restart=restart)
        vp, cp = ppr_walk_ref(nbrs, cum, starts, u, restart=restart,
                              last=last)
        torch.cuda.synchronize()
        check(torch.equal(vk, vp) and torch.equal(ck, cp),
              f"ppr_walk ({case}) differs from its plain version")
        check(bool((ck.sum(dim=1) == W * L).all()),
              f"ppr_walk ({case}) counts do not sum to the trace length")
        if lo:
            check(int(vk.min()) >= lo, "big-id walk left the top ids")
        ms = time_ms(lambda: PW.ppr_walk(nbrs, cum, last, starts, u,
                                         restart=restart), 20)
        plain_ms = time_ms(lambda: ppr_walk_ref(
            nbrs, cum, starts, u, restart=restart, last=last), 3)
        nbytes = ppr_walk_bytes(PPR_STARTS, W, L)
        bound_ms = nbytes / peaks[1] * 1e3
        moved = float((vk != starts.repeat_interleave(W * L).view_as(vk)
                       ).float().mean())
        print(f"[phase1] ppr_walk {case}: N={N} D2={D2} starts="
              f"{PPR_STARTS} walks={W} len={L} bitwise_equal=True "
              f"max_id={int(vk.max())} share_away_from_start={moved:.4f} "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={bound_ms:.5f} (bytes {nbytes:.0f})")
        out[case] = (ms, plain_ms, bound_ms)
        del nbrs, cum, last
        torch.cuda.empty_cache()
    ms, plain_ms, bound_ms = out["1.3M nodes"]
    return dict(name="ppr_walk", route="cuda",
                source="src/repro_torch/csrc/ppr_walk.cu",
                replaces="src/repro/kernels/ppr_walk/ppr_walk.py:106",
                max_abs_err=0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes", library_ms=None)


def contrastive_bound(B: int, N: int, d: int, esize: int, backward: bool,
                      peaks) -> tuple:
    """(bound ms, what bounds it) for one pass: inputs read once, outputs
    written once; 2 ops per multiply-add on the FP32 pipes."""
    nbytes = esize * (2 * B * d + B * N * d) + 4 * 4 * B
    ops = 2.0 * B * N * d + 2.0 * B * d
    if backward:
        nbytes += esize * (2 * B * d + B * N * d)
        ops += 2.0 * B * N * d + 1.0 * B * N * d + 2.0 * B * d
    t_b, t_o = nbytes / peaks[1], ops / peaks[0]
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def phase1_fused_contrastive(g: torch.Generator, dev, peaks) -> list:
    """Forward and backward kernels against the plain versions in f32
    and bf16 at the train step's shapes.  Tolerances (``close``): f32 and
    bf16 forward outputs and f32 gradients within 1e-4 relative (the same
    f32 arithmetic summed in another order); bf16 gradients within one
    bf16 rounding, 2^-7 relative, of the plain f32 result."""
    B, N, d = CF_ROWS, CONFIG.n_negatives, CONFIG.d_embed
    m, tau = CONFIG.margin, CONFIG.tau
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        def unit(*shape):
            x = torch.randn(shape, generator=g, device=dev)
            return (x / x.norm(dim=-1, keepdim=True)).to(dtype)
        src, dst, negs = unit(B, d), unit(B, d), unit(B, N, d)
        gm = torch.randn(B, generator=g, device=dev) / B
        gi = torch.randn(B, generator=g, device=dev) / B
        fk = FC.fused_contrastive_fwd(src, dst, negs, margin=m, tau=tau)
        fp = fwd_ref(src, dst, negs, margin=m, tau=tau)
        bk = FC.fused_contrastive_bwd(src, dst, negs, gm, gi, fp[2], fp[3],
                                      margin=m, tau=tau)
        bp = bwd_ref(src, dst, negs, gm, gi, fp[2], fp[3], margin=m,
                     tau=tau)
        torch.cuda.synchronize()
        f_err = max(float((a - b).abs().max()) for a, b in zip(fk, fp))
        for a, b in zip(fk, fp):
            check(close(a, b, 1e-4),
                  f"fused_contrastive forward ({dtype}) off the plain one")
        b_err = 0.0
        rel = 1e-4 if dtype == torch.float32 else 2.0 ** -7
        for a, b in zip(bk, bp):
            check(a.dtype == dtype, "gradient type is not the input type")
            b_err = max(b_err, float((a.float() - b).abs().max()))
            check(close(a, b, rel),
                  f"fused_contrastive backward ({dtype}) off the plain one")
        f_ms = time_ms(lambda: FC.fused_contrastive_fwd(
            src, dst, negs, margin=m, tau=tau), 20)
        f_plain = time_ms(lambda: fwd_ref(src, dst, negs, margin=m,
                                          tau=tau), 5)
        b_ms = time_ms(lambda: FC.fused_contrastive_bwd(
            src, dst, negs, gm, gi, fp[2], fp[3], margin=m, tau=tau), 20)
        b_plain = time_ms(lambda: bwd_ref(src, dst, negs, gm, gi, fp[2],
                                          fp[3], margin=m, tau=tau), 5)
        es = src.element_size()
        fb, fby = contrastive_bound(B, N, d, es, False, peaks)
        bb, bby = contrastive_bound(B, N, d, es, True, peaks)
        name = str(dtype).replace("torch.", "")
        print(f"[phase1] fused_contrastive {name} B={B} N={N} d={d}: fwd "
              f"max_abs_err={f_err:.3g} kernel_ms={f_ms:.4f} plain_ms="
              f"{f_plain:.4f} bound_ms={fb:.4f} ({fby}); bwd max_abs_err="
              f"{b_err:.3g} kernel_ms={b_ms:.4f} plain_ms={b_plain:.4f} "
              f"bound_ms={bb:.4f} ({bby})")
        rows[dtype] = (f_err, f_ms, f_plain, fb, fby, b_err, b_ms, b_plain,
                       bb, bby)
        del src, dst, negs, fk, fp, bk, bp
        torch.cuda.empty_cache()
    # the main path trains in bf16: its numbers go into the kernels line
    f_err, f_ms, f_plain, fb, fby, b_err, b_ms, b_plain, bb, bby = \
        rows[torch.bfloat16]
    src_file = "src/repro_torch/csrc/fused_contrastive.cu"
    jax_file = "src/repro/kernels/fused_contrastive/fused_contrastive.py"
    return [dict(name="fused_contrastive_fwd", route="cuda", source=src_file,
                 replaces=f"{jax_file}:93", max_abs_err=f_err, ms=f_ms,
                 plain_ms=f_plain, bound_ms=fb, bound_by=fby,
                 library_ms=None),
            dict(name="fused_contrastive_bwd", route="cuda", source=src_file,
                 replaces=f"{jax_file}:118", max_abs_err=b_err, ms=b_ms,
                 plain_ms=b_plain, bound_ms=bb, bound_by=bby,
                 library_ms=None)]


def random_bags(g: torch.Generator, n: int, L: int, rows: int, dev, *,
                lo: int = 0) -> torch.Tensor:
    """(n, L) int32 bags: lengths uniform in 1..L, ids uniform in
    [lo, rows), -1 after each bag's length."""
    length = torch.randint(1, L + 1, (n, 1), generator=g, device=dev)
    ids = torch.randint(lo, rows, (n, L), generator=g, device=dev)
    cols = torch.arange(L, device=dev)[None, :]
    return torch.where(cols < length, ids, -1).to(torch.int32)


def eb_bound(ids: torch.Tensor, D: int, V: int, backward: bool,
             peaks) -> tuple:
    """(bound ms, what bounds it) of the main path's call on the (N, L)
    bags ``ids``: an f32 (V, D) table, bf16 compute, no weights (weights
    would add their read, the rows' read and the d_weights write).
    Forward: ids read once, each distinct valid row read once, the bf16
    output written once; a multiply and an add per valid element.
    Backward: ids and the bf16 cotangent read once, the dense f32 d_table
    written once; an add per valid element.  Operations at the FP32
    rate."""
    N, L = ids.shape
    valid = ids[ids >= 0]
    nbytes = 4.0 * N * L + 2.0 * N * D
    if backward:
        ops = 1.0 * valid.numel() * D
        nbytes += 4.0 * V * D
    else:
        ops = 2.0 * valid.numel() * D
        nbytes += 4.0 * torch.unique(valid).numel() * D
    t_b, t_o = nbytes / peaks[1], ops / peaks[0]
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def eb_plan_share(ids: torch.Tensor, V: int, op_ms: float) -> str:
    """The segment plan's time (CUDA events, the op's own tiles at D 64)
    and its share of the whole backward's ``op_ms``."""
    tile = EB.rows_per_tile(DLRM.embed_dim)
    ms = time_ms(lambda: EB.segment_plan(ids, V, tile), 10)
    return f"segment_plan {ms:.4f} ms = {ms / op_ms:.1%} of the op"


def eb_repeat(gout, table, ids, first: torch.Tensor, what: str) -> None:
    """The backward again on the same inputs: d_table bitwise equal."""
    again, _ = EB.embedding_bag_bwd(gout, table, ids, None, "sum",
                                    torch.bfloat16)
    check(torch.equal(again, first),
          f"embedding_bag d_table {what}: a repeat differs bitwise")


def eb_library(table: torch.Tensor, ids: torch.Tensor):
    """``F.embedding_bag`` (sum, pads as weight 0 on row 0): the library
    yardstick of the forward, f32 throughout (no bf16 rounding)."""
    mask = (ids >= 0).to(table.dtype)
    safe = ids.clamp_min(0).long()
    return lambda: torch.nn.functional.embedding_bag(
        safe, table, mode="sum", per_sample_weights=mask)


def phase1_embedding_bag(g: torch.Generator, dev, peaks) -> list:
    """Forward and backward kernels against the plain versions.
    Tolerances (``close``): f32 outputs, f32 d_table and d_weights within
    1e-5 relative (the same f32 sums in another order: the plain
    backward's ``index_add_`` adds with atomics on the card); bf16
    outputs and bf16-rounded d_table within one bf16 step, 2^-7
    relative.  The backward's d_table must also repeat bitwise (its sums
    run in the segment plan's fixed order)."""
    D, F_ = DLRM.embed_dim, DLRM.n_sparse
    bf16, f32 = torch.bfloat16, torch.float32

    def held(a, b, dtype, what):
        """``close`` in chunks of rows (no temporaries of a table's size);
        returns the largest absolute gap."""
        rel = 2.0 ** -7 if dtype == bf16 else 1e-5
        floor = 1e-4 * max(float(b[r:r + (1 << 22)].float().abs().max())
                           for r in range(0, b.shape[0], 1 << 22))
        check(a.dtype == b.dtype and a.shape == b.shape,
              f"embedding_bag {what}: type or shape")
        err = 0.0
        for r in range(0, b.shape[0], 1 << 22):
            x, y = a[r:r + (1 << 22)].float(), b[r:r + (1 << 22)].float()
            gap = (x - y).abs()
            check(bool((gap <= rel * y.abs() + floor).all()),
                  f"embedding_bag {what} off the plain version")
            err = max(err, float(gap.max()))
        return err

    # (a) every mode, weighting and type at small shapes
    small = 0
    for Dm, L, tdt, cdt in ((64, 16, f32, bf16), (64, 40, f32, f32),
                            (50, 16, bf16, bf16), (16, 5, f32, bf16)):
        table = torch.randn((100_000, Dm), generator=g, device=dev).to(tdt)
        ids = random_bags(g, 4096, L, 100_000, dev)
        ids[7] = -1                                      # an empty bag
        w = torch.rand((4096, L), generator=g, device=dev)
        gout = torch.randn((4096, Dm), generator=g, device=dev).to(cdt)
        for mode in ("sum", "mean"):
            for wt in (None, w):
                held(EB.embedding_bag_fwd(table, ids, wt, mode, cdt),
                     embedding_bag_ref(table, ids, wt, mode, cdt), cdt,
                     f"fwd {mode} D={Dm} {tdt}/{cdt}")
                dk, wk = EB.embedding_bag_bwd(gout, table, ids, wt, mode,
                                              cdt)
                dp, wp = embedding_bag_bwd_ref(gout, table, ids, wt, mode,
                                               cdt)
                held(dk, dp, bf16 if bf16 in (tdt, cdt) else f32,
                     f"d_table {mode} D={Dm} {tdt}/{cdt}")
                if wt is not None:
                    check(close(wk, wp, 1e-4),
                          f"embedding_bag d_weights {mode} D={Dm} off")
                small += 1
        del table, ids, w, gout
    print(f"[phase1] embedding_bag: {small} small cases (sum/mean x "
          f"weighted/unweighted x 4 shapes and types, fwd and bwd) held")

    # (b) the train stage's shape: 1,703,936 bags on its 26M-row table
    N, V = RS_TRAIN * F_, F_ * TRAIN_VOCAB
    table = torch.empty((V, D), device=dev).normal_(generator=g).mul_(0.01)
    ids = random_bags(g, N, BAG, V, dev)
    n_valid = int((ids >= 0).sum())
    gout = (torch.randn((N, D), generator=g, device=dev) * 1e-3).to(bf16)
    out_k = EB.embedding_bag_fwd(table, ids, None, "sum", bf16)
    f_err = held(out_k, embedding_bag_ref(table, ids, None, "sum", bf16),
                 bf16, "fwd at the train shape")
    dk, _ = EB.embedding_bag_bwd(gout, table, ids, None, "sum", bf16)
    dp, _ = embedding_bag_bwd_ref(gout, table, ids, None, "sum", bf16)
    b_err = held(dk, dp, bf16, "d_table at the train shape")
    del out_k, dp
    eb_repeat(gout, table, ids, dk, "at the train shape")
    del dk
    torch.cuda.empty_cache()
    f_ms = time_ms(lambda: EB.embedding_bag_fwd(table, ids, None, "sum",
                                                bf16), 10)
    f_plain = time_ms(lambda: embedding_bag_ref(table, ids, None, "sum",
                                                bf16), 3)
    f_lib = time_ms(eb_library(table, ids), 10)
    b_ms = time_ms(lambda: EB.embedding_bag_bwd(gout, table, ids, None,
                                                "sum", bf16), 10)
    b_plain = time_ms(lambda: embedding_bag_bwd_ref(gout, table, ids, None,
                                                    "sum", bf16), 3)
    valid = ids.flatten() >= 0
    flat = ids.flatten()[valid].long()
    contrib = (gout.float()[:, None, :].expand(N, BAG, D).reshape(-1, D)
               [valid])
    acc = torch.zeros((V, D), device=dev)
    b_lib = time_ms(lambda: acc.index_add_(0, flat, contrib), 10)
    del acc, contrib, flat, valid
    fb, fby = eb_bound(ids, D, V, False, peaks)
    bb, bby = eb_bound(ids, D, V, True, peaks)
    print(f"[phase1] embedding_bag train shape: bags={N} L<={BAG} D={D} "
          f"table=({V}, {D}) f32, bf16 compute, valid ids={n_valid}: fwd "
          f"max_abs_err={f_err:.3g} kernel_ms={f_ms:.4f} plain_ms="
          f"{f_plain:.4f} F.embedding_bag_ms={f_lib:.4f} bound_ms={fb:.4f} "
          f"({fby}); bwd max_abs_err={b_err:.3g} kernel_ms={b_ms:.4f} "
          f"plain_ms={b_plain:.4f} index_add_ms={b_lib:.4f} bound_ms="
          f"{bb:.4f} ({bby}), {eb_plan_share(ids, V, b_ms)}; repeat "
          f"bitwise equal")

    # (b') skewed: one row takes 10% of the valid ids (a hot item)
    hot = V // 2
    ids[(torch.rand(ids.shape, generator=g, device=dev) < 0.1)
        & (ids >= 0)] = hot
    share = float((ids == hot).sum()) / n_valid
    dk, _ = EB.embedding_bag_bwd(gout, table, ids, None, "sum", bf16)
    dp, _ = embedding_bag_bwd_ref(gout, table, ids, None, "sum", bf16)
    s_err = held(dk, dp, bf16, "d_table with a hot row")
    del dp
    eb_repeat(gout, table, ids, dk, "with a hot row")
    del dk
    s_ms = time_ms(lambda: EB.embedding_bag_bwd(gout, table, ids, None,
                                                "sum", bf16), 10)
    # the same without the hot row's split: no sorted piece is whole
    piece, EB.PIECE = EB.PIECE, 1 << 30
    try:
        u_ms = time_ms(lambda: EB.embedding_bag_bwd(gout, table, ids, None,
                                                    "sum", bf16), 2)
    finally:
        EB.PIECE = piece
    print(f"[phase1] embedding_bag bwd at the train shape with row {hot} "
          f"holding {share:.2%} of the valid ids: max_abs_err={s_err:.3g} "
          f"kernel_ms={s_ms:.4f} ({s_ms / b_ms:.2f}x the uniform case; "
          f"without the split into pieces of {EB.PIECE} ids "
          f"{u_ms:.4f} ms, {u_ms / b_ms:.2f}x); repeat bitwise equal")
    del table, ids, gout
    torch.cuda.empty_cache()

    # (c) the serving table, 2.6e8 x 64 f32 (66.56 GB): ids above 2^24,
    # element offsets above 2^31; bags at the serve_p99, serve_bulk (the
    # main path's largest launch) and train shapes
    V = EB_ROWS
    table = torch.empty((V, D), device=dev)
    for r0 in range(0, V, 1 << 26):
        table[r0:r0 + (1 << 26)].normal_(generator=g).mul_(0.01)
    big = {}
    for name, N in (("serve_p99", RS_P99 * F_), ("serve_bulk", RS_BULK * F_),
                    ("train_batch", RS_TRAIN * F_)):
        ids = random_bags(g, N, BAG, V, dev, lo=BIG_ID)
        ids[:64, 0] = V - 1 - torch.arange(64, device=dev, dtype=torch.int32)
        out_k = EB.embedding_bag_fwd(table, ids, None, "sum", bf16)
        err = 0.0
        for c0 in range(0, N, 1 << 18):              # plain, in chunks
            err = max(err, held(out_k[c0:c0 + (1 << 18)], embedding_bag_ref(
                table, ids[c0:c0 + (1 << 18)], None, "sum", bf16), bf16,
                f"fwd on the 2.6e8-row table at {name}"))
        ms = time_ms(lambda: EB.embedding_bag_fwd(table, ids, None, "sum",
                                                  bf16), 10)
        bound, by = eb_bound(ids, D, V, False, peaks)
        if name == "serve_p99":
            big[name] = ids
        print(f"[phase1] embedding_bag fwd on ({V}, {D}) f32 at {name}: "
              f"bags={N} min_id={int(ids[ids >= 0].min())} max_id="
              f"{int(ids.max())} max_abs_err={err:.3g} kernel_ms={ms:.4f} "
              f"bound_ms={bound:.4f} ({by})")
        del out_k
    p99_plain = time_ms(lambda: embedding_bag_ref(
        table, big["serve_p99"], None, "sum", bf16), 3)
    p99_lib = time_ms(eb_library(table, big["serve_p99"]), 10)
    print(f"[phase1] embedding_bag fwd serve_p99 on the 2.6e8-row table: "
          f"plain_ms={p99_plain:.4f} F.embedding_bag_ms={p99_lib:.4f}")
    del table, big
    torch.cuda.empty_cache()

    # (d) the backward with ids above 2^24 and element offsets above 2^31:
    # a 40M-row table (2.56e9 elements), train_batch bags
    V, N = EB_BWD_ROWS, RS_TRAIN * F_
    table = torch.empty((V, D), device=dev)
    ids = random_bags(g, N, BAG, V, dev, lo=BIG_ID)
    ids[:64, 0] = V - 1 - torch.arange(64, device=dev, dtype=torch.int32)
    gout = (torch.randn((N, D), generator=g, device=dev) * 1e-3).to(bf16)
    dk, _ = EB.embedding_bag_bwd(gout, table, ids, None, "sum", bf16)
    dp, _ = embedding_bag_bwd_ref(gout, table, ids, None, "sum", bf16)
    err = held(dk, dp, bf16, "d_table with offsets above 2^31")
    # the top rows (element offsets near 2.56e9) entry by entry, with no
    # floor; no row below 2^24 was written
    top_dk, top_p = dk[V - 64:], dp[V - 64:]
    check(bool(((top_dk - top_p).abs() <= 2.0 ** -7 * top_p.abs()).all())
          and float((top_p != 0).float().mean()) > 0.9,
          "embedding_bag d_table: the top rows differ from the plain ones")
    check(float(dk[:BIG_ID].abs().max()) == 0,
          "embedding_bag d_table: a row below 2^24 is not zero")
    del dp
    eb_repeat(gout, table, ids, dk, "with offsets above 2^31")
    del dk
    torch.cuda.empty_cache()
    ms = time_ms(lambda: EB.embedding_bag_bwd(gout, table, ids, None, "sum",
                                              bf16), 5)
    bound, by = eb_bound(ids, D, V, True, peaks)
    print(f"[phase1] embedding_bag bwd on ({V}, {D}) f32 at train_batch: "
          f"bags={N} ids in [2^24, {V}) max_abs_err={err:.3g} kernel_ms="
          f"{ms:.4f} bound_ms={bound:.4f} ({by}), "
          f"{eb_plan_share(ids, V, ms)}; repeat bitwise equal")
    del table, ids, gout
    torch.cuda.empty_cache()

    src_file = "src/repro_torch/csrc/embedding_bag.cu"
    jax_file = "src/repro/kernels/embedding_bag"
    return [dict(name="embedding_bag_fwd", route="cuda", source=src_file,
                 replaces=f"{jax_file}/embedding_bag.py:57",
                 max_abs_err=f_err, ms=f_ms, plain_ms=f_plain, bound_ms=fb,
                 bound_by=fby, library_ms=f_lib),
            dict(name="embedding_bag_bwd", route="cuda", source=src_file,
                 replaces=f"{jax_file}/ops.py:34", max_abs_err=b_err,
                 ms=b_ms, plain_ms=b_plain, bound_ms=bb, bound_by=bby,
                 library_ms=b_lib)]


FA_SHAPES = (
    # (name, B, S, Hq, Hkv, T, D, causal): the main path's launches; the
    # decode ones read a cache filled to T (kv_len T, one new row)
    ("prefill_32k", 1, 32768, 24, 8, 32768, 128, True),
    ("decode_32k", 8, 1, 24, 8, 32768, 128, False),
    ("long_500k", 1, 1, 24, 8, 524288, 128, False),
    ("gemma_prefill_8k", 1, 8192, 8, 1, 8192, 256, True),
)
FA_SMALL = (
    # tests/test_kernels.py's sweep (B, Hq, Hkv, S, T, D, causal), in the
    # (B, H, S, D) contract through strided views, plus D 256
    (2, 4, 2, 256, 256, 64, True), (1, 2, 2, 200, 200, 32, True),
    (2, 4, 1, 1, 300, 64, True), (1, 2, 2, 128, 256, 64, False),
    (1, 8, 8, 96, 96, 128, True), (1, 8, 1, 70, 333, 256, True),
    (1, 8, 1, 1, 2000, 256, True),           # gemma-like decode, split
)
BF16_STEP = 2.0 ** -7        # one bf16 rounding, relative


def fa_work(B, S, Hq, Hkv, T, D, causal, esize) -> tuple:
    """(operations, bytes) the attention needs: 4 D per (query, key) pair
    that the mask keeps (2 D for q.k, 2 D for p.v), q, k, v read once and
    o written once."""
    pairs = S * (S + 1) // 2 if causal and S == T else S * T
    ops = 4.0 * D * pairs * B * Hq
    nbytes = esize * (2.0 * B * S * Hq * D + 2.0 * B * T * Hkv * D)
    return ops, nbytes


def sdpa_library(q, k, v, causal, scale, math: bool = False):
    """``scaled_dot_product_attention(enable_gqa=True)`` in the (B, H, S,
    D) layout (views of the (B, S, H, D) tensors), kept off the math
    backend, which would hold the whole score matrix, unless ``math``
    (for a small f32 shape, where no fused backend takes GQA); None where
    no allowed backend takes it."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    fn = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa
        qt, kt, vt, is_causal=causal, scale=scale, enable_gqa=True)
    try:
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                          SDPBackend.EFFICIENT_ATTENTION,
                          SDPBackend.CUDNN_ATTENTION]
                         + ([SDPBackend.MATH] if math else [])):
            out = fn()
            ms = time_ms(fn, 5)
    except RuntimeError as e:
        print(f"[phase1] SDPA refuses this shape: {str(e).splitlines()[0]}")
        return None, None
    return ms, out.transpose(1, 2)


def fa_launches(fn):
    """``fn()`` and the flash-attention launches it made, by kernel."""
    before = common.launch_counts()
    out = fn()
    after = common.launch_counts()
    return out, {k: n - before.get(k, 0) for k, n in after.items()
                 if k.startswith("flash_attention") and n != before.get(k, 0)}


def check_fa_launches(got: dict, kernel: str, splits: int, what: str):
    want = {kernel: 1, **({"flash_attention_merge": 1} if splits > 1
                          else {})}
    check(got == want, f"{what}: launches {got}, want {want}")


def phase1_flash_attention(g: torch.Generator, dev, peaks) -> list:
    """The forward kernels (whole op: one launch, or partials and merge
    when ``plan`` splits the kv range) against ``chunked_attention_ref``
    at the main path's four launch shapes in bf16, and on small cases in
    f32 against ``attention_ref``.  bf16 runs the tensor-core kernels
    (``flash_attention`` above 16 rows per KV head, else
    ``flash_attention_decode``), f32 the FP32-pipe ``flash_attention_f32``;
    every call's launches are checked by name.  Tolerances: bf16 outputs
    within one bf16 step, 2^-7 relative (``close``: plus 1e-4 of the
    largest for the entries near zero), since both sides compute the same
    f32 scores, the kernels' P.V carries P to about 16 bits (split in two
    bf16 parts), and both round once; f32 within 3e-4 as
    tests/test_kernels.py holds the Pallas kernel (f32 sums in another
    order); the merge kernel within 1e-5 of ``merge_ref`` on the same
    partials (the same f32 sums in another order)."""
    bf16 = torch.bfloat16
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count

    def planned(q, k, T):
        B, S, Hq, D = q.shape
        return FA.plan(B, S, Hq, k.shape[2], T, n_sm, D=D, dtype=q.dtype)

    # (a) small cases, f32, (B, H, S, D) contract through transposed views
    for B, Hq, Hkv, S, T, D, causal in FA_SMALL:
        q = torch.randn((B, Hq, S, D), generator=g, device=dev)
        k = torch.randn((B, Hkv, T, D), generator=g, device=dev)
        v = torch.randn((B, Hkv, T, D), generator=g, device=dev)
        got, n = fa_launches(lambda: FA_OPS.attention(q, k, v,
                                                      causal=causal))
        want = attention_ref(q, k, v, causal=causal)
        case = (B, Hq, Hkv, S, T, D, causal)
        check(close(got, want, 3e-4), f"flash_attention small case "
              f"{case} off attention_ref")
        check_fa_launches(n, *planned(got.transpose(1, 2), k.transpose(1, 2),
                                      T), f"f32 small case {case}")
        # the same in bf16 against the model contract's plain version
        qb, kb, vb = (x.transpose(1, 2).to(bf16) for x in (q, k, v))
        kw = dict(causal=causal, scale=D ** -0.5,
                  q_offset=T - S if causal else 0)
        gb, n = fa_launches(lambda: FA.flash_attention(qb, kb, vb, **kw))
        wb = chunked_attention_ref(qb, kb, vb, **kw)
        check(close(gb, wb, BF16_STEP), f"flash_attention small bf16 case "
              f"{case} off the plain version")
        check_fa_launches(n, *planned(qb, kb, T), f"bf16 small case {case}")
    # a ragged kv_len tensor, an offset and forced splits: f32, then bf16
    # on both tensor-core kernels (15 rows per KV head: the decode kernel
    # takes them, and so does the 128-row one)
    kvl = torch.tensor([1, 333, 700], dtype=torch.int32, device=dev)
    for dtype, S, kernels in ((torch.float32, 5, ("flash_attention_f32",)),
                              (bf16, 5, ("flash_attention_decode",
                                         "flash_attention")),
                              (bf16, 50, ("flash_attention",))):
        q = torch.randn((3, S, 6, 64), generator=g, device=dev).to(dtype)
        k = torch.randn((3, 700, 2, 64), generator=g, device=dev).to(dtype)
        v = torch.randn((3, 700, 2, 64), generator=g, device=dev).to(dtype)
        tol = 3e-4 if dtype == torch.float32 else BF16_STEP
        for causal in (False, True):
            kw = dict(causal=causal, q_offset=600, kv_len=kvl, scale=0.125)
            want = chunked_attention_ref(q, k, v, **kw)
            got, n = fa_launches(lambda: FA.flash_attention(q, k, v, **kw))
            check(close(got, want, tol), f"flash_attention ragged kv_len "
                  f"({dtype}, S {S}, causal={causal}) off the plain version")
            check_fa_launches(n, *planned(q, k, 700), f"ragged kv_len "
                              f"({dtype}, S {S})")
            check(kernels[0] in n, f"ragged kv_len ({dtype}, S {S}): "
                  f"launches {n}, want {kernels[0]}")
            for kernel in kernels:
                for splits in (2, 5, 11):
                    part = FA.flash_attention_partials(
                        q, k, v, splits=splits, kernel=kernel,
                        rpt=4 if dtype == torch.float32 else None, **kw)
                    got = FA.flash_attention_merge(*part, n_heads=6,
                                                   dtype=dtype)
                    check(close(got, want, tol), f"{kernel} with {splits} "
                          f"forced splits (S {S}, causal={causal}) off the "
                          f"plain version")
    print(f"[phase1] flash_attention: {2 * len(FA_SMALL)} small cases (f32 "
          f"vs attention_ref, bf16 vs chunked_attention_ref) and ragged "
          f"kv_len / offset / forced-split cases held (f32 on "
          f"flash_attention_f32, bf16 on flash_attention and "
          f"flash_attention_decode), launches as planned")

    # (b) the main path's launch shapes, bf16
    rows = {}
    for name, B, S, Hq, Hkv, T, D, causal in FA_SHAPES:
        q = torch.randn((B, S, Hq, D), generator=g, device=dev).to(bf16)
        k = torch.empty((B, T, Hkv, D), dtype=bf16, device=dev).normal_(
            generator=g)
        v = torch.empty((B, T, Hkv, D), dtype=bf16, device=dev).normal_(
            generator=g)
        kw = dict(causal=causal, scale=D ** -0.5,
                  kv_len=None if causal else T)
        kernel, splits = planned(q, k, T)
        got, n = fa_launches(lambda: FA.flash_attention(q, k, v, **kw))
        check_fa_launches(n, kernel, splits, f"flash_attention at {name}")
        want = chunked_attention_ref(q, k, v, block_q=1024 if causal else 1,
                                     **kw)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        check(got.dtype == bf16 and close(got, want, BF16_STEP),
              f"flash_attention at {name} off the plain version ({err})")
        reps = 3 if causal else 20
        ms = time_ms(lambda: FA.flash_attention(q, k, v, **kw), reps)
        plain_ms = time_ms(lambda: chunked_attention_ref(
            q, k, v, block_q=1024 if causal else 1, **kw), 2)
        lib_ms, lib_out = sdpa_library(q, k, v, causal, D ** -0.5)
        lib_err = (None if lib_out is None else
                   float((lib_out.float() - want.float()).abs().max()))
        ops, nbytes = fa_work(B, S, Hq, Hkv, T, D, causal, 2)
        t_o, t_b = ops / peaks[2], nbytes / peaks[1]
        bound_ms, by = max(t_o, t_b) * 1e3, ("operations" if t_o >= t_b
                                             else "bytes")
        per_s = 1e3 / ms
        rate = (f"{ops * per_s / 1e12:.1f} TFLOP/s ({ops * per_s / peaks[2]:.1%}"
                f" of the bf16 peak)" if by == "operations" else
                f"{nbytes * per_s / 1e9:.1f} GB/s "
                f"({nbytes * per_s / peaks[1]:.1%} of the memory rate)")
        extra = ""
        if splits > 1:
            part = FA.flash_attention_partials(q, k, v, splits=splits, **kw)
            m_got = FA.flash_attention_merge(*part, n_heads=Hq, dtype=bf16)
            m_want = merge_ref(*part, n_heads=Hq, dtype=torch.float32)
            m_err = float((m_got.float() - m_want).abs().max())
            check(close(m_got, m_want, BF16_STEP),
                  f"flash_attention_merge at {name} off merge_ref")
            # the merge alone: in f32 against merge_ref, no bf16 rounding
            m32 = FA.flash_attention_merge(*part, n_heads=Hq,
                                           dtype=torch.float32)
            check(close(m32, m_want, 1e-5),
                  f"flash_attention_merge (f32) at {name} off merge_ref")
            p_ms = time_ms(lambda: FA.flash_attention_partials(
                q, k, v, splits=splits, **kw), reps)
            m_ms = time_ms(lambda: FA.flash_attention_merge(
                *part, n_heads=Hq, dtype=bf16), reps)
            m_plain = time_ms(lambda: merge_ref(*part, n_heads=Hq,
                                                dtype=bf16), reps)
            m_bytes = 4.0 * sum(p.numel() for p in part) + 2.0 * q.numel()
            rows[f"merge_{name}"] = (float((m32 - m_want).abs().max()), m_ms,
                                     m_plain, m_bytes / peaks[1] * 1e3)
            extra = (f" splits={splits}: partials_ms={p_ms:.4f} merge_ms="
                     f"{m_ms:.4f} (merge max_abs_err {m_err:.3g}, plain "
                     f"{m_plain:.4f} ms)")
        rows[name] = (err, ms, plain_ms, bound_ms, by, lib_ms)
        print(f"[phase1] {kernel} {name}: q {tuple(q.shape)} k/v "
              f"{tuple(k.shape)} bf16 causal={causal}{extra} "
              f"max_abs_err={err:.3g} kernel_ms={ms:.4f} ({rate}) "
              f"plain_ms={plain_ms:.4f} sdpa_ms={lib_ms} (max_abs_err vs "
              f"plain {lib_err}) bound_ms={bound_ms:.4f} ({by}; "
              f"{ops / 1e12:.4f} TFLOP, {nbytes / 1e9:.4f} GB)")
        del q, k, v, got, want, lib_out
        torch.cuda.empty_cache()
    # (c) the FP32-pipe kernel at the shape of Phase 5's f32 card-vs-CPU
    # check (llama heads, B 2 x 256 tokens, causal prefill)
    B, S, Hq, Hkv, D = (CHECK_LM_B, CHECK_LM_S, LLAMA.n_heads,
                        LLAMA.n_kv_heads, LLAMA.resolved_head_dim)
    q = torch.randn((B, S, Hq, D), generator=g, device=dev)
    k = torch.randn((B, S, Hkv, D), generator=g, device=dev)
    v = torch.randn((B, S, Hkv, D), generator=g, device=dev)
    kw = dict(causal=True, scale=D ** -0.5)
    got, n = fa_launches(lambda: FA.flash_attention(q, k, v, **kw))
    check(n == {"flash_attention_f32": 1}, f"f32 attention at the check "
          f"shape: launches {n}")
    want = chunked_attention_ref(q, k, v, **kw)
    err = float((got - want).abs().max())
    check(close(got, want, 3e-4), "flash_attention_f32 at the f32 check "
          "shape off the plain version")
    ms = time_ms(lambda: FA.flash_attention(q, k, v, **kw), 20)
    plain_ms = time_ms(lambda: chunked_attention_ref(q, k, v, **kw), 5)
    lib_ms, _ = sdpa_library(q, k, v, True, D ** -0.5, math=True)
    ops, nbytes = fa_work(B, S, Hq, Hkv, S, D, True, 4)
    t_o, t_b = ops / peaks[0], nbytes / peaks[1]
    print(f"[phase1] flash_attention_f32 at Phase 5's f32 check shape: q "
          f"{tuple(q.shape)} k/v {tuple(k.shape)} f32 causal max_abs_err="
          f"{err:.3g} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"sdpa_ms={lib_ms} (math backend allowed) bound_ms="
          f"{max(t_o, t_b) * 1e3:.4f} "
          f"({'operations' if t_o >= t_b else 'bytes'} at the FP32 rate)")
    del q, k, v, got, want

    src_file = "src/repro_torch/csrc/flash_attention.cu"
    jax_file = "src/repro/kernels/flash_attention/flash_attention.py:91"
    out = []
    for kname, shape in (("flash_attention", "prefill_32k"),
                         ("flash_attention_decode", "decode_32k")):
        err, ms, plain_ms, bound_ms, by, lib_ms = rows[shape]
        out.append(dict(name=kname, route="cuda", source=src_file,
                        replaces=jax_file, max_abs_err=err, ms=ms,
                        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                        library_ms=lib_ms))
    m_err, m_ms, m_plain, m_bound = rows["merge_decode_32k"]
    out.append(dict(name="flash_attention_merge", route="cuda",
                    source=src_file, replaces=jax_file, max_abs_err=m_err,
                    ms=m_ms, plain_ms=m_plain, bound_ms=m_bound,
                    bound_by="bytes", library_ms=None))
    return out


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


# ---------------------------------------------------------------------------
# Phase 3: the construct-and-train slice at full width
# ---------------------------------------------------------------------------

def make_log_world(seed: int) -> SyntheticWorld:
    """A topic-clustered engagement log of one day, made with numpy: each
    user has a home topic (N_TOPICS topics of equal item count) and
    Poisson(EVENTS_PER_USER) events, HOME_SHARE of them on items of the
    home topic and the rest on any item, both Zipf-1.1 by popularity;
    event types 0-3 with probabilities 0.7 / 0.15 / 0.1 / 0.05;
    timestamps over one day; standard-normal features."""
    rng = np.random.default_rng(seed)
    nu, ni, T_ = P3_USERS, P3_ITEMS, N_TOPICS
    per_topic = ni // T_
    topic_items = rng.permutation(ni)        # topic t: a block, rank order
    global_items = rng.permutation(ni)       # global popularity rank order

    def zipf_cdf(n):
        p = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** 1.1
        return np.cumsum(p / p.sum())

    home = rng.integers(0, T_, nu)
    per_user = np.maximum(rng.poisson(EVENTS_PER_USER, nu), 1)
    users = np.repeat(np.arange(nu, dtype=np.int64), per_user)
    n_ev = len(users)
    r_loc = np.minimum(np.searchsorted(zipf_cdf(per_topic),
                                       rng.random(n_ev)), per_topic - 1)
    r_glob = np.minimum(np.searchsorted(zipf_cdf(ni), rng.random(n_ev)),
                        ni - 1)
    items = np.where(rng.random(n_ev) < HOME_SHARE,
                     topic_items[home[users] * per_topic + r_loc],
                     global_items[r_glob]).astype(np.int64)
    etype = rng.choice(4, n_ev, p=[0.7, 0.15, 0.1, 0.05]).astype(np.int32)
    ts = rng.random(n_ev) * 86400.0
    log = EngagementLog(users, items, etype, ts, nu, ni)
    empty = EngagementLog(np.zeros(0, np.int64), np.zeros(0, np.int64),
                          np.zeros(0, np.int32), np.zeros(0), nu, ni)
    cfg = CONFIG
    return SyntheticWorld(
        np.zeros((nu, 0), np.float32), np.zeros((ni, 0), np.float32),
        rng.standard_normal((nu, cfg.d_user_feat), np.float32),
        rng.standard_normal((ni, cfg.d_item_feat), np.float32),
        np.zeros(ni, np.float32), day0=log, day1=empty)


def draws_for(cfg, pool, batch, rows: int, g: torch.Generator) -> dict:
    """Negative draws of every loss direction of ``batch`` from the CPU
    generator ``g``, to inject into a step on any device."""
    fills = {"user": pool.user_fill, "item": pool.item_fill}
    return {dn: negative_draws(rows, cfg.n_heads, cfg.n_negatives,
                               cfg.n_pool_neg, fills[DST_TYPE[dn]],
                               generator=g)
            for dn in loss_directions(batch)}


def train_from_init(cfg, res, world, seed: int, dev, rows: int,
                    steps: int, *, inject: bool) -> list:
    """``steps`` train steps from run ``seed``'s initial state on
    ``dev``, on the batches ``run_pipeline`` takes at ``rows`` edges per
    type.  The negatives are drawn as ``run_pipeline`` draws them (a
    generator on ``dev`` seeded 1000 + t) or, with ``inject``, from one
    CPU generator, so that two devices get the same draws.  Returns each
    step's metrics."""
    ds = EdgeDataset(res.tables, world.user_feat, world.item_feat,
                     k_train=cfg.k_train, device=dev, g=res.graph)
    state, opt = init_state(cfg, generator=torch.Generator().manual_seed(
        seed), pool_size=P3_POOL, device=dev)
    step_fn = make_train_step(cfg, opt, features=FeatureStore(
        ds.user_feat, ds.item_feat))
    per_type = {et: rows for et in ("uu", "ui", "ii")}
    g = torch.Generator().manual_seed(seed + 11)
    out = []
    for t in range(steps):
        batch = ds.sample_batch(t, seed, per_type)
        if inject:
            kw = dict(draws=draws_for(cfg, state.pool, batch, rows, g))
        else:
            kw = dict(generator=torch.Generator(dev).manual_seed(1000 + t))
        state, m = step_fn(state, batch, **kw)
        out.append({k: float(v) for k, v in m.items()})
    return out


def within(a: dict, b: dict, rel: float, abs_: float) -> float:
    """The largest ``|a - b| / (rel |b| + abs_)`` over the metrics of one
    step (1 is the tolerance)."""
    return max(abs(a[k] - b[k]) / (rel * abs(b[k]) + abs_) for k in b)


def f32_gap(a: dict, b: dict) -> float:
    """``within`` for the f32 card-vs-CPU steps.  The RQ losses follow
    discrete code choices: a near-tie argmin that falls the other way in
    f32 sums of another order moves one row's reconstruction, about 1e-3
    of ``rq_contrastive`` at CHECK_ROWS edges per type, so they get
    F32_RQ_REL; every other loss and the grad norm get F32_REL."""
    return max(abs(a[k] - b[k])
               / ((F32_RQ_REL if k.startswith("rq_") else F32_REL)
                  * abs(b[k]) + F32_ABS) for k in b)


def card_vs_cpu_losses(res, world, seed: int, dev) -> dict:
    """One step's task losses on the card (bf16, kernels) and on the CPU
    (f32, plain versions) from the same trained state, batch and
    negative draws, at CHECK_ROWS edges per type."""
    cfg = CONFIG
    st = res.state
    kw = dict(k_train=cfg.k_train, g=res.graph)
    ds = {d: EdgeDataset(res.tables, world.user_feat, world.item_feat,
                         device=d, **kw) for d in (dev, "cpu")}
    per_type = {et: CHECK_ROWS for et in ("uu", "ui", "ii")}
    batch = {d: ds[d].sample_batch(P3_STEPS, seed, per_type) for d in ds}
    g = torch.Generator().manual_seed(seed + 7)
    draws = draws_for(cfg, st.pool, batch["cpu"], CHECK_ROWS, g)
    cpu_pool = dataclasses.replace(st.pool, user=st.pool.user.cpu(),
                                   item=st.pool.item.cpu())
    cpu_rq = dataclasses.replace(
        st.rq_state, hists=tuple(h.cpu() for h in st.rq_state.hists),
        usage=tuple(u.cpu() for u in st.rq_state.usage))
    cpu_params = copy.deepcopy(st.params).cpu()
    out = {}
    with torch.no_grad():
        for d, params, c, pool, rq in (
                (dev, st.params, cfg, st.pool, st.rq_state),
                ("cpu", cpu_params, dataclasses.replace(cfg, dtype="float32"),
                 cpu_pool, cpu_rq)):
            tasks, _ = forward_losses(
                params, c, batch[d], pool, rq, draws=draws,
                features=FeatureStore(ds[d].user_feat, ds[d].item_feat))
            out[str(d)] = {k: float(v) for k, v in tasks.items()}
    return out


def phase3(seed: int, dev) -> dict:
    cfg = CONFIG
    t = time.perf_counter()
    world = make_log_world(seed)
    log_s = time.perf_counter() - t
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    common.reset_launches()                  # main path starts here
    t = time.perf_counter()
    res = run_pipeline(world, cfg, steps=P3_STEPS, batch_per_type=CF_ROWS,
                       pool_size=P3_POOL, seed=seed, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = common.launch_counts()        # main path ends here
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    g = res.graph
    nu, ni = g.n_users, g.n_items
    n_nodes = nu + ni
    edges = {et: len(getattr(g, et)) for et in ("ui", "uu", "ii")}
    print(f"[phase3] log: users={nu} items={ni} events="
          f"{len(world.day0.user_id)} topics={N_TOPICS} made in "
          f"{log_s:.2f} s; edges={json.dumps(edges)}")
    check(all(v > 0 for v in edges.values()), "an edge type is empty")
    check(edges["uu"] >= nu, f"U-U holds only {edges['uu']} edges")

    # --- checks --------------------------------------------------------
    t = time.perf_counter()
    for i, m in enumerate(res.history):
        check(all(np.isfinite(v) for v in m.values()),
              f"step {i}: non-finite metrics {m}")
        check(m["grad_norm"] > 0, f"step {i}: zero gradient")
    fresh, _ = init_state(cfg, generator=torch.Generator().manual_seed(seed),
                          pool_size=P3_POOL, device=dev)
    moved = {k: float((p - fresh.params.get_parameter(k)).detach()
                       .abs().max())
             for k, p in res.state.params.named_parameters()}
    check(all(v > 0 for v in moved.values()),
          f"parameters that did not move: "
          f"{[k for k, v in moved.items() if v == 0]}")
    del fresh
    want = {"ppr_walk": -(-n_nodes // PPR_STARTS),
            "fused_contrastive_fwd": 7 * P3_STEPS,
            "fused_contrastive_bwd": 7 * P3_STEPS}
    for name, n in want.items():
        check(launches.get(name, 0) == n,
              f"{name}: {launches.get(name, 0)} launches, expected {n}")
    check(launches.get("rq_assign", 0) > 0, "rq_assign was not launched")
    for e, n in ((res.user_emb, nu), (res.item_emb, ni)):
        check(tuple(e.shape) == (n, cfg.d_embed), "embedding shape")
        nrm = e.float().norm(dim=1)
        check(bool(torch.isfinite(e).all())
              and bool(((nrm - 1).abs() < 2e-2).all()),
              "embeddings are not finite unit vectors")
    n_cl = int(np.prod(cfg.rq.codebook_sizes))
    check(int(res.user_codes.min()) >= 0
          and int(res.user_codes.max()) < n_cl, "codes out of range")

    # traces of 4,096 starts against the numpy walker; the full tables
    # against the numpy top-k on the same visits and counts
    adj = build_padded_hetero_adj(g, PPR_DEG)
    starts = np.arange(n_nodes, dtype=np.int64)
    vis, cnt = _walk_device(adjacency_to_device(adj, dev), starts,
                            n_walks=cfg.ppr_walks, walk_len=cfg.ppr_len,
                            restart=cfg.ppr_restart, seed=seed)
    vis = vis.cpu().numpy().astype(np.int64)
    cnt = cnt.cpu().numpy().astype(np.int64)
    rng = np.random.default_rng(seed + 3)
    edge = min(1024, n_nodes // 4)      # first and last ids, then random
    mid = np.arange(edge, n_nodes - edge)
    sample = np.r_[np.arange(edge), n_nodes - edge + np.arange(edge),
                   rng.choice(mid, min(len(mid), 4096 - 2 * edge),
                              replace=False)]
    ref_vis = _walk_numpy(adj, sample, n_walks=cfg.ppr_walks,
                          walk_len=cfg.ppr_len, restart=cfg.ppr_restart,
                          seed=seed, chunk=1 << 18)
    check(np.array_equal(vis[sample], ref_vis),
          "device walk traces differ from the numpy walker's")
    users, items = _topk_from_counts(vis, cnt, starts, cfg.k_imp, nu, 0.5,
                                     global_visit_mass(vis, n_nodes))
    check(np.array_equal(users, res.tables.user_nbrs)
          and np.array_equal(items, res.tables.item_nbrs),
          "device top-k tables differ from the numpy top-k")
    filled = float((res.tables.user_nbrs[:, 0] >= 0).mean())
    del vis, cnt, users, items

    losses = card_vs_cpu_losses(res, world, seed, dev)
    card, cpu = losses[str(dev)], losses["cpu"]
    worst = 0.0
    for k in cpu:
        gap = abs(card[k] - cpu[k])
        worst = max(worst, gap / (CARD_CPU_REL * abs(cpu[k]) + CARD_CPU_ABS))
        check(gap <= CARD_CPU_REL * abs(cpu[k]) + CARD_CPU_ABS,
              f"task {k}: card bf16 {card[k]} vs cpu f32 {cpu[k]}")

    # the train chain in f32, where the card must match the CPU closely:
    # F32_STEPS steps from the initial state, same batches and draws
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    f32 = {str(d): train_from_init(cfg32, res, world, seed, d, CHECK_ROWS,
                                   F32_STEPS, inject=True)
           for d in (dev, "cpu")}
    f32_worst = 0.0
    for i, (a, b) in enumerate(zip(f32[str(dev)], f32["cpu"])):
        w = f32_gap(a, b)
        f32_worst = max(f32_worst, w)
        check(w <= 1, f"f32 step {i}: card {a} vs cpu {b}")
    # the main path's 20 steps again in f32 on the card: same initial
    # state, batches and draws; step 0 must agree with the bf16 run
    replay = train_from_init(cfg32, res, world, seed, dev, CF_ROWS,
                             P3_STEPS, inject=False)
    check(all(np.isfinite(v) for m in replay for v in m.values()),
          "non-finite metrics in the f32 replay")
    w0 = within(res.history[0], replay[0], CARD_CPU_REL, CARD_CPU_ABS)
    check(w0 <= 1, f"step 0: bf16 {res.history[0]} vs f32 {replay[0]}")
    check_s = time.perf_counter() - t

    # one more step, split: the batch (host numpy + copy to the card),
    # then the step on it (device work, ended by a sync)
    ds = EdgeDataset(res.tables, world.user_feat, world.item_feat,
                     k_train=cfg.k_train, device=dev, g=g)
    per_type = {et: CF_ROWS for et in ("uu", "ui", "ii")}
    step_fn = make_train_step(cfg, rankgraph2_optimizer(),
                              features=FeatureStore(ds.user_feat,
                                                    ds.item_feat))
    torch.cuda.synchronize()
    t = time.perf_counter()
    batch = ds.sample_batch(P3_STEPS, seed, per_type)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t
    step_fn(res.state, batch,
            generator=torch.Generator(dev).manual_seed(1000 + P3_STEPS))
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t - batch_s

    train_s = res.seconds["train"]
    eps = P3_STEPS * 3 * CF_ROWS / train_s
    print(f"[phase3] run_pipeline seconds={json.dumps({k: round(v, 4) for k, v in res.seconds.items()})} "
          f"wall={wall:.2f} checks={check_s:.2f}")
    print(f"[phase3] train: {P3_STEPS} steps x {3 * CF_ROWS} edges, "
          f"{eps:.0f} edges/s (host clock, first step included)")
    print(f"[phase3] one more step: batch {batch_s:.4f} s (host numpy + "
          f"copy), step on it {step_s:.4f} s (synced)")
    print(f"[phase3] last step metrics {json.dumps({k: round(v, 5) for k, v in res.metrics.items()})}")
    print(f"[phase3] one step card-bf16 vs cpu-f32 at {CHECK_ROWS} edges "
          f"per type: {json.dumps({k: [round(card[k], 5), round(cpu[k], 5)] for k in cpu})} "
          f"(worst gap {worst:.3f} of the tolerance)")
    print(f"[phase3] f32 card vs f32 cpu, {F32_STEPS} steps from the "
          f"initial state at {CHECK_ROWS} edges per type: total "
          f"{[[round(m['total'], 5) for m in f32[k]] for k in f32]}, grad "
          f"norm {[[round(m['grad_norm'], 5) for m in f32[k]] for k in f32]}"
          f" (worst gap {f32_worst:.3f} of the tolerance)")
    for name, h in (("bf16 main path", res.history), ("f32 replay", replay)):
        print(f"[phase3] {name}: total "
              f"{[round(m['total'], 4) for m in h]}; rq_reg "
              f"{[round(m['rq_reg'], 3) for m in h]}; grad norm "
              f"{[round(m['grad_norm'], 3) for m in h]}")
    print(f"[phase3] step 0 bf16 vs f32: worst gap {w0:.3f} of the "
          f"tolerance")
    print(f"[phase3] traces of {len(sample)} starts bitwise equal to the "
          f"numpy walker; tables equal to the numpy top-k; rows with a "
          f"user neighbour {filled:.4f}; peak device memory {peak_gb:.3f} "
          f"GB; launches={launches}")
    return launches


# ---------------------------------------------------------------------------
# Phase 4: the recsys serve-and-train slice at full width
# ---------------------------------------------------------------------------

def recsys_batch(cfg, g: torch.Generator, n: int, dev, *, bags: int = 0,
                 labels: bool = True) -> dict:
    """A batch of ``n`` requests made on ``dev`` from ``g``: ids uniform
    over the vocab; with ``bags``, dlrm multi-hot ids (n, F, bags) whose
    lengths are uniform in 1..bags (-1 after)."""
    V = cfg.default_vocab

    def ids(*shape, lo=0):
        return torch.randint(lo, V, shape, generator=g, device=dev,
                             dtype=torch.int32)
    b = {}
    if cfg.kind == "dlrm":
        b["dense"] = torch.randn((n, cfg.n_dense), generator=g, device=dev)
        b["sparse"] = (random_bags(g, n * cfg.n_sparse, bags, V, dev).view(
            n, cfg.n_sparse, bags) if bags else ids(n, cfg.n_sparse))
    elif cfg.kind == "wide_deep":
        b["sparse"] = ids(n, cfg.n_sparse)
    elif cfg.kind == "sasrec":
        b["seq"] = ids(n, cfg.seq_len, lo=-1)
    else:
        b.update(seq=ids(n, cfg.seq_len, lo=-1), target=ids(n),
                 other=ids(n, cfg.n_sparse))
    if labels and cfg.kind != "sasrec":
        b["labels"] = (torch.rand(n, generator=g, device=dev) > 0.5).float()
    return b


def compact_dlrm(params, batch, sel: torch.Tensor):
    """The requests ``sel`` of a multi-hot dlrm batch on the CPU, with
    only the table rows they touch: each field's valid ids re-indexed
    into a compact (F, U, D) table (U the largest count of a field)."""
    ids = batch["sparse"][sel].cpu().long()
    tables = params["tables"]
    per, width = [], 1
    for f in range(ids.shape[1]):
        valid = ids[:, f] >= 0
        uniq, inv = torch.unique(ids[:, f][valid], return_inverse=True)
        per.append((valid, uniq, inv))
        width = max(width, len(uniq))
    compact = torch.zeros((ids.shape[1], width, tables.shape[2]))
    new = torch.full_like(ids, -1)
    for f, (valid, uniq, inv) in enumerate(per):
        compact[f, : len(uniq)] = tables[f, uniq.to(tables.device)].cpu()
        new[:, f][valid] = inv
    cpu = {k: v for k, v in params.items() if k != "tables"}
    cpu = {k: [{q: t.detach().cpu() for q, t in layer.items()}
               for layer in v] for k, v in cpu.items()}
    cpu["tables"] = compact
    return cpu, {"dense": batch["dense"][sel].cpu(), "sparse": new}


def params_gap(a: dict, b: dict) -> dict:
    """Per parameter: (median gap, share of entries beyond PARAM_FAR,
    largest gap)."""
    out = {}
    for k in b:
        d = (a[k].detach().float().cpu() - b[k].detach().float()).abs()
        out[k] = (float(d.median()), float((d > PARAM_FAR).float().mean()),
                  float(d.max()))
    return out


def phase4(seed: int, dev) -> dict:
    """dlrm-rm2 serve (8 serve_p99 batches, one serve_bulk), retrieval
    and 20 train steps; wide-deep, sasrec and bst one serve_bulk batch
    each.  Returns the embedding_bag launches of the serve and train
    stages."""
    cfg = DLRM
    secs, peaks, checks = {}, {}, {}
    g = torch.Generator(dev).manual_seed(seed + 40)

    def begin():
        """A stage starts: its peak memory counts from here."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        return time.perf_counter()

    def stage(name, t0):
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        peaks[name] = torch.cuda.max_memory_allocated() / 1e9

    # --- serve: 26 x 10,000,000 x 64 f32 tables, multi-hot bags --------
    t = begin()
    params = R.init_params(cfg, generator=torch.Generator(dev).manual_seed(
        seed), device=dev)
    stage("init", t)
    common.reset_launches()                  # serve path starts here
    t = begin()
    p99_s = []
    for _ in range(P99_REPS):
        b = recsys_batch(cfg, g, RS_P99, dev, bags=BAG, labels=False)
        t1 = time.perf_counter()
        out = recsys_serve_step(params, cfg, b)
        torch.cuda.synchronize()
        p99_s.append(time.perf_counter() - t1)
        check(out.shape == (RS_P99,) and bool(torch.isfinite(out).all()),
              "serve_p99 logits are not finite")
    bulk = recsys_batch(cfg, g, RS_BULK, dev, bags=BAG, labels=False)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    logits = recsys_serve_step(params, cfg, bulk)
    torch.cuda.synchronize()
    secs["serve_bulk"] = time.perf_counter() - t1
    stage("serve", t)
    serve_launches = common.launch_counts()  # serve path ends here
    check(logits.shape == (RS_BULK,) and logits.dtype == torch.bfloat16
          and bool(torch.isfinite(logits).all()), "serve_bulk logits")
    rows = int((bulk["sparse"] >= 0).sum())
    # serve_p99 requests spread evenly over the bulk batch (so over the
    # whole kernel grid), on the CPU, from only the rows they touch
    sel = torch.arange(0, RS_BULK, RS_BULK // RS_P99, device=dev)
    cpu_params, cpu_batch = compact_dlrm(params, bulk, sel)
    ref = R.dlrm_forward(cpu_params, cfg, cpu_batch["dense"],
                         cpu_batch["sparse"]).float()
    gap = float((logits[sel].float().cpu() - ref).abs().max())
    checks["serve_cpu_gap"] = gap / float(ref.abs().max())
    check(gap <= P4_REL * float(ref.abs().max()),
          f"serve_bulk logits vs the CPU: {gap} of {float(ref.abs().max())}")
    del bulk, logits, cpu_params, cpu_batch

    # --- retrieval: one query against 1,000,000 candidates --------------
    t = begin()
    q = recsys_batch(cfg, g, 1, dev, labels=False)
    cand = torch.randint(0, 4 * cfg.default_vocab, (RS_CAND,), generator=g,
                         device=dev, dtype=torch.int32)
    vals, idx = recsys_retrieval_step(params, cfg, q, cand, k=100)
    stage("retrieval", t)
    # the same bf16 scores on the card, ranked on the CPU
    tab = params["tables"][0]
    u = tab[q["sparse"][0].long()].mean(dim=0, keepdim=True).to(
        torch.bfloat16)
    cvec = tab[torch.remainder(cand, tab.shape[0]).long()].to(torch.bfloat16)
    scores = (u @ cvec.T)[0].cpu()
    _, want = top_k(scores, 100)
    check(torch.equal(idx.cpu(), want),
          "retrieval top-100 differs from the CPU ranking of its scores")
    # and the scores recomputed on the CPU
    cpu_scores = (u.cpu() @ cvec.cpu().T)[0]
    s_gap = float((cpu_scores.float() - scores.float()).abs().max())
    check(s_gap <= 2.0 ** -7 * float(scores.float().abs().max()),
          f"retrieval scores: card vs CPU {s_gap}")
    cpu_ids = top_k(cpu_scores, 100)[1]
    checks["retrieval_ties_in_top100"] = 100 - len(set(vals.float().tolist()))
    checks["retrieval_cpu_scores_same_ids"] = bool(torch.equal(
        cpu_ids, idx.cpu()))
    del params, tab, u, cvec, cand
    torch.cuda.empty_cache()

    # --- train: 20 steps at train_batch, vocab cut to 1,000,000 ---------
    tcfg = dataclasses.replace(cfg, default_vocab=TRAIN_VOCAB)
    t = begin()
    params = R.init_params(tcfg, generator=torch.Generator(dev).manual_seed(
        seed + 1), device=dev)
    flat = R.flatten_params(params)
    start = {k: v.clone() for k, v in flat.items()}
    opt = rankgraph2_optimizer()
    st = opt.init(flat)
    stage("train_init", t)
    common.reset_launches()                  # train path starts here
    t = begin()
    losses = []
    for _ in range(P4_STEPS):
        b = recsys_batch(tcfg, g, RS_TRAIN, dev, bags=BAG)
        loss, st = recsys_train_step(params, st, b, tcfg, opt)
        losses.append(float(loss))
    stage("train", t)
    train_launches = common.launch_counts()  # train path ends here
    check(all(np.isfinite(losses)), f"train losses {losses}")
    still = [k for k, v in flat.items() if torch.equal(v, start[k])]
    check(not still, f"parameters that did not move: {still}")
    del params, flat, start, st, opt, b, loss
    torch.cuda.empty_cache()

    # --- the train chain in f32, card vs CPU: same init and batches ------
    t = begin()
    ccfg = dataclasses.replace(cfg, default_vocab=CHECK_VOCAB,
                               dtype="float32")
    p_cpu = R.init_params(ccfg, generator=torch.Generator().manual_seed(
        seed + 2), device="cpu")
    p_dev = {k: (v.to(dev) if torch.is_tensor(v) else
                 [{q_: x.to(dev) for q_, x in layer.items()} for layer in v])
             for k, v in p_cpu.items()}
    traj = {}
    gb = torch.Generator().manual_seed(seed + 3)
    batches = [recsys_batch(ccfg, gb, CHECK_BATCH, "cpu", bags=BAG)
               for _ in range(P4_F32_STEPS)]
    for d, p in ((dev, p_dev), ("cpu", p_cpu)):
        o = rankgraph2_optimizer()
        ost = o.init(R.flatten_params(p))
        traj[str(d)] = []
        for bb in batches:
            loss, ost = recsys_train_step(
                p, ost, {k: v.to(d) for k, v in bb.items()}, ccfg, o)
            traj[str(d)].append(float(loss))
    stage("f32_check", t)
    worst = max(abs(a - b_) / (F32_REL * abs(b_) + F32_ABS)
                for a, b_ in zip(traj[str(dev)], traj["cpu"]))
    check(worst <= 1, f"f32 losses card {traj[str(dev)]} vs cpu "
          f"{traj['cpu']}")
    pg = params_gap(R.flatten_params(p_dev), R.flatten_params(p_cpu))
    for k, (med, far, mx) in pg.items():
        check(med <= PARAM_MEDIAN and far <= PARAM_FAR_SHARE,
              f"f32 param {k}: median {med}, share beyond {PARAM_FAR} "
              f"{far}, max {mx}")
    del p_dev, p_cpu
    torch.cuda.empty_cache()

    # --- the other archs: one serve_bulk batch each at full width -------
    other = {}
    for arch in ("wide-deep", "sasrec", "bst"):
        acfg = get_arch(arch).config
        t = begin()
        params = R.init_params(acfg, generator=torch.Generator(
            dev).manual_seed(seed), device=dev)
        b = recsys_batch(acfg, g, RS_BULK, dev, labels=False)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = recsys_serve_step(params, acfg, b)
        torch.cuda.synchronize()
        other[arch] = time.perf_counter() - t1
        check(out.shape[0] == RS_BULK and bool(torch.isfinite(out).all()),
              f"{arch} serve_bulk outputs are not finite")
        stage(arch, t)
        del params, b, out
        torch.cuda.empty_cache()

    fwd, bwd = "embedding_bag_fwd", "embedding_bag_bwd"
    check(serve_launches.get(fwd, 0) >= P99_REPS + 1,
          f"serve: {serve_launches.get(fwd, 0)} {fwd} launches")
    check(train_launches.get(fwd, 0) >= P4_STEPS
          and train_launches.get(bwd, 0) >= P4_STEPS,
          f"train: {train_launches.get(fwd, 0)} {fwd}, "
          f"{train_launches.get(bwd, 0)} {bwd} launches")
    print(f"[phase4] dlrm-rm2 serve: tables {cfg.n_sparse} x "
          f"{cfg.default_vocab} x {cfg.embed_dim} f32, bags of 1..{BAG}; "
          f"serve_p99 batch={RS_P99} seconds per batch "
          f"{[round(v, 5) for v in p99_s]}; serve_bulk batch={RS_BULK} "
          f"({rows} rows gathered) {secs['serve_bulk']:.4f} s; "
          f"{RS_P99} strided logits vs the CPU on compact tables: worst gap "
          f"{checks['serve_cpu_gap']:.3g} of the largest (tolerance "
          f"{P4_REL})")
    print(f"[phase4] retrieval: {RS_CAND} candidates, top 100 equal to the "
          f"CPU ranking of the card's scores; CPU-computed scores give the "
          f"same ids: {checks['retrieval_cpu_scores_same_ids']}; tied "
          f"scores in the top 100: {checks['retrieval_ties_in_top100']}")
    print(f"[phase4] train: {P4_STEPS} steps x {RS_TRAIN} rows, vocab "
          f"{TRAIN_VOCAB} per field; loss {[round(v, 5) for v in losses]}")
    print(f"[phase4] f32 card vs cpu, {P4_F32_STEPS} steps at vocab "
          f"{CHECK_VOCAB}, {CHECK_BATCH} rows: loss {traj} (worst gap "
          f"{worst:.3f} of the tolerance); parameters (median gap, share "
          f"beyond {PARAM_FAR}, largest gap): "
          f"{json.dumps({k: [float(f'{x:.3g}') for x in v] for k, v in pg.items() if v[2] > 0})}")
    print(f"[phase4] other archs serve_bulk seconds "
          f"{json.dumps({k: round(v, 4) for k, v in other.items()})}")
    print(f"[phase4] seconds={json.dumps({k: round(v, 4) for k, v in secs.items()})}")
    print(f"[phase4] peak device memory GB per stage="
          f"{json.dumps({k: round(v, 3) for k, v in peaks.items()})}")
    print(f"[phase4] launches serve={serve_launches} train={train_launches}")
    return {fwd: serve_launches.get(fwd, 0) + train_launches.get(fwd, 0),
            bwd: train_launches.get(bwd, 0)}


# ---------------------------------------------------------------------------
# Phase 5: the dense LM serve slice at full width
# ---------------------------------------------------------------------------

def lm_tokens(cfg, g: torch.Generator, B: int, S: int, dev) -> torch.Tensor:
    return torch.randint(0, cfg.vocab_size, (B, S), generator=g, device=dev)


def random_caches(cfg, B: int, T: int, g: torch.Generator, dev) -> dict:
    """(L, B, T, Hkv, hd) bf16 caches of N(0, 1) values from ``g``, drawn
    layer by layer (no f32 temporary of a cache's size)."""
    shape = (cfg.n_layers, B, T, cfg.n_kv_heads, cfg.resolved_head_dim)
    caches = {n: torch.empty(shape, dtype=torch.bfloat16, device=dev)
              for n in ("k", "v")}
    for c in caches.values():
        for layer in c:
            layer.normal_(generator=g)
    return caches


def attention_share_ms(cfg, caches: dict, cache_len: int,
                       g: torch.Generator) -> float:
    """CUDA-event time of the attention launches of one decode step (all
    layers, random queries) on these caches: the attention part of a
    step, the rest being everything else."""
    B, hd = caches["k"].shape[1], cfg.resolved_head_dim
    q = torch.randn((B, 1, cfg.n_heads, hd), generator=g,
                    device=caches["k"].device).to(torch.bfloat16)

    def run():
        for i in range(cfg.n_layers):
            FA.flash_attention(q, caches["k"][i], caches["v"][i],
                               causal=False, scale=hd ** -0.5,
                               kv_len=cache_len + 1)
    return time_ms(run, 3)


def near(a: torch.Tensor, b: torch.Tensor, tol: float) -> float:
    """``max |a - b| / (tol * max |b|)``: at most 1 passes."""
    a, b = a.float().cpu(), b.float().cpu()
    return float((a - b).abs().max()) / (tol * float(b.abs().max()))


def phase5(seed: int, dev) -> dict:
    """llama3.2-3b at full width: prefill_32k (B 1), 16 greedy decode
    steps from its cache, decode_32k (B 8), long_500k (B 1); gemma-2b
    prefill at 8k and 16 decode steps; then llama at 2 layers card vs CPU
    in f32 and the prefill/decode consistency on the card in bf16.
    Returns the flash-attention launches of the serve stages."""
    cfg = LLAMA
    secs, peaks, launches, notes = {}, {}, {}, {}
    g = torch.Generator(dev).manual_seed(seed + 50)
    hd, L = cfg.resolved_head_dim, cfg.n_layers

    def begin(name=None):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if name:
            common.reset_launches()          # a serve stage starts here
        return time.perf_counter()

    def stage(name, t0, serve=True):
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        peaks[name] = torch.cuda.max_memory_allocated() / 1e9
        if serve:
            launches[name] = {k: v for k, v in common.launch_counts().items()
                              if k.startswith("flash_attention") and v}

    # --- 1. init: 14.43 GB of f32 params -----------------------------------
    t = begin()
    params = LM.init_params(cfg, generator=torch.Generator(dev).manual_seed(
        seed), device=dev)
    stage("init", t, serve=False)
    n_bytes = sum(x.numel() * x.element_size()
                  for x in R.flatten_params(params).values())
    check(abs(n_bytes - 4 * cfg.n_params()) == 0,
          f"llama params {n_bytes} bytes, want {4 * cfg.n_params()}")

    # --- 2. prefill_32k at B 1 -------------------------------------------
    S = LM_SH["prefill_32k"]["seq_len"]
    prompt = lm_tokens(cfg, g, P5_PREFILL_B, S, dev)
    t = begin("prefill_32k")
    last, caches = lm_prefill_step(params, cfg, prompt)
    stage("prefill_32k", t)
    check(last.shape == (P5_PREFILL_B, cfg.vocab_size)
          and bool(torch.isfinite(last).all()), "prefill logits")
    for c in caches.values():
        check(c.shape == (L, P5_PREFILL_B, S, cfg.n_kv_heads, hd)
              and c.dtype == torch.bfloat16 and bool(torch.isfinite(c).all()),
              "prefill caches")

    # --- 3. generate: 16 greedy steps from the prompt's cache -------------
    gen = {n: torch.empty((L, P5_PREFILL_B, S + GEN_STEPS, cfg.n_kv_heads,
                           hd), dtype=torch.bfloat16, device=dev)
           for n in ("k", "v")}
    for n in gen:
        gen[n][:, :, :S] = caches[n]
    del caches
    torch.cuda.empty_cache()
    tok = torch.argmax(last, dim=-1, keepdim=True)
    out_tokens, step_s = [], []
    t = begin("generate")
    for i in range(GEN_STEPS):
        t1 = time.perf_counter()
        logits, gen = LM.decode_step(params, cfg, tok, gen, S + i)
        tok = torch.argmax(logits, dim=-1, keepdim=True)
        out_tokens.append(int(tok[0, 0]))          # syncs
        step_s.append(time.perf_counter() - t1)
    stage("generate", t)
    check(bool(torch.isfinite(logits).all())
          and all(0 <= x < cfg.vocab_size for x in out_tokens),
          "generated tokens")
    notes["generate_s_per_token"] = statistics.median(step_s[1:])
    notes["generate_attention_ms"] = attention_share_ms(cfg, gen, S + 8, g)
    del gen, last, logits
    torch.cuda.empty_cache()

    # --- 4. decode_32k at B 8: one step at cache_len 32,767 ---------------
    T = LM_SH["decode_32k"]["seq_len"]
    t = begin()
    caches = random_caches(cfg, P5_DECODE_B, T, g, dev)
    stage("decode_32k_fill", t, serve=False)
    tok = lm_tokens(cfg, g, P5_DECODE_B, 1, dev)
    t = begin("decode_32k")
    logits, caches = lm_decode_step(params, cfg, caches, tok)
    stage("decode_32k", t)
    check(logits.shape == (P5_DECODE_B, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "decode_32k logits")
    torch.cuda.synchronize()
    reps = []
    for _ in range(P5_DECODE_REPS):
        t1 = time.perf_counter()
        again, caches = lm_decode_step(params, cfg, caches, tok)
        torch.cuda.synchronize()
        reps.append(time.perf_counter() - t1)
    notes["decode_32k_repeat_bitwise"] = bool(torch.equal(again, logits))
    check(near(again, logits, 1e-3) <= 1, "decode_32k is not repeatable")
    notes["decode_32k_step_s"] = reps
    notes["decode_32k_attention_ms"] = attention_share_ms(
        cfg, caches, T - 1, g)
    del caches, logits, again
    torch.cuda.empty_cache()

    # --- 5. long_500k at B 1: one step at cache_len 524,287 ---------------
    T = LM_SH["long_500k"]["seq_len"]
    need = 2 * L * T * cfg.n_kv_heads * hd * 2 / 1e9
    t = begin()
    try:
        caches = random_caches(cfg, 1, T, g, dev)
        stage("long_500k_fill", t, serve=False)
        tok = lm_tokens(cfg, g, 1, 1, dev)
        t = begin("long_500k")
        logits, caches = lm_decode_step(params, cfg, caches, tok)
        stage("long_500k", t)
    except torch.cuda.OutOfMemoryError as e:
        raise AssertionError(
            f"long_500k does not fit: caches {need:.2f} GB beside "
            f"{n_bytes / 1e9:.2f} GB of params, "
            f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated of "
            f"{torch.cuda.get_device_properties(dev).total_memory / 1e9:.2f}"
            f" GB: {e}") from e
    check(logits.shape == (1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "long_500k logits")
    reps = []
    for _ in range(P5_LONG_REPS):
        t1 = time.perf_counter()
        logits, caches = lm_decode_step(params, cfg, caches, tok)
        torch.cuda.synchronize()
        reps.append(time.perf_counter() - t1)
    notes["long_500k_step_s"] = reps
    notes["long_500k_attention_ms"] = attention_share_ms(cfg, caches, T - 1,
                                                         g)
    del caches, logits, params
    torch.cuda.empty_cache()

    # --- 6. gemma-2b at full width: prefill at 8k, 16 decode steps --------
    gcfg = GEMMA
    t = begin()
    gparams = LM.init_params(gcfg, generator=torch.Generator(
        dev).manual_seed(seed + 1), device=dev)
    stage("gemma_init", t, serve=False)
    S = P5_GEMMA_SEQ
    t = begin("gemma_prefill_8k")
    last, caches = lm_prefill_step(gparams, gcfg, lm_tokens(gcfg, g, 1, S,
                                                            dev))
    stage("gemma_prefill_8k", t)
    check(bool(torch.isfinite(last).all()), "gemma prefill logits")
    gen = {n: torch.nn.functional.pad(c, (0, 0, 0, 0, 0, GEN_STEPS))
           for n, c in caches.items()}
    del caches
    tok = torch.argmax(last, dim=-1, keepdim=True)
    t = begin("gemma_generate")
    for i in range(GEN_STEPS):
        logits, gen = LM.decode_step(gparams, gcfg, tok, gen, S + i)
        tok = torch.argmax(logits, dim=-1, keepdim=True)
    stage("gemma_generate", t)
    check(bool(torch.isfinite(logits).all()), "gemma decode logits")
    del gparams, gen, last, logits
    torch.cuda.empty_cache()

    # --- 7. card vs CPU: llama at full width, 2 layers, f32 ---------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = begin()
    ccfg = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    p_dev = LM.init_params(ccfg, generator=torch.Generator(dev).manual_seed(
        seed + 2), device=dev)
    p_cpu = {k: ([{n: x.cpu() for n, x in lp.items()} for lp in v]
                 if k == "layers" else v.cpu()) for k, v in p_dev.items()}
    toks = lm_tokens(ccfg, g, CHECK_LM_B, CHECK_LM_S, dev)
    gaps, out, nxt = {}, {}, None
    for side, p, d in (("card", p_dev, dev), ("cpu", p_cpu, "cpu")):
        last, caches = LM.prefill(p, ccfg, toks.to(d))
        caches = {n: torch.nn.functional.pad(c, (0, 0, 0, 0, 0, 1))
                  for n, c in caches.items()}
        if nxt is None:                     # the card's pick, on both sides
            nxt = torch.argmax(last, dim=-1, keepdim=True).cpu()
        dec, caches = LM.decode_step(p, ccfg, nxt.to(d), caches, CHECK_LM_S)
        out[side] = (last, dec, caches)
    for i, name in enumerate(("prefill_logits", "decode_logits")):
        gaps[name] = near(out["card"][i], out["cpu"][i], 1.0)
        check(close(out["card"][i].cpu(), out["cpu"][i], CARD_CPU_LM_REL),
              f"card vs CPU {name}: worst gap {gaps[name]:.3g} of the "
              f"largest")
    for n in ("k", "v"):
        check(close(out["card"][2][n].cpu(), out["cpu"][2][n],
                    CARD_CPU_LM_REL), f"card vs CPU caches {n}")
        gaps[f"caches_{n}"] = near(out["card"][2][n], out["cpu"][2][n], 1.0)
    del p_cpu, out
    # prefill / decode consistency on the card in bf16
    bcfg = dataclasses.replace(ccfg, dtype="bfloat16")
    toks = lm_tokens(bcfg, g, 2, 16, dev)
    full = LM.forward(p_dev, bcfg, toks)
    last, caches = LM.prefill(p_dev, bcfg, toks, block_q=8)
    gaps["bf16_prefill_vs_forward"] = near(last, full[:, -1], BF16_LM_TOL)
    caches = {n: torch.nn.functional.pad(c, (0, 0, 0, 0, 0, 16))
              for n, c in caches.items()}
    nxt = torch.argmax(last, dim=-1, keepdim=True)
    dec, caches = LM.decode_step(p_dev, bcfg, nxt, caches, 16)
    full2 = LM.forward(p_dev, bcfg, torch.cat([toks, nxt], dim=1))
    gaps["bf16_decode_vs_forward"] = near(dec, full2[:, -1], BF16_LM_TOL)
    check(gaps["bf16_prefill_vs_forward"] <= 1
          and gaps["bf16_decode_vs_forward"] <= 1,
          f"bf16 prefill/decode consistency on the card: {gaps}")
    stage("card_vs_cpu", t, serve=False)
    del p_dev
    torch.cuda.empty_cache()

    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count

    def add(d, more):
        for k, v in more.items():
            d[k] = d.get(k, 0) + v
        return d

    def per_step(c, B, kv):
        """Launches of one decode step by kernel: one per layer, plus a
        merge per layer when the kv range is split."""
        kernel, splits = FA.plan(B, 1, c.n_heads, c.n_kv_heads, kv, n_sm,
                                 D=c.resolved_head_dim)
        return {kernel: c.n_layers,
                **({"flash_attention_merge": c.n_layers} if splits > 1
                   else {})}

    def steps(c, B, kv0):
        want = {}
        for i in range(GEN_STEPS):
            add(want, per_step(c, B, kv0 + i + 1))
        return want
    S, Sg = LM_SH["prefill_32k"]["seq_len"], P5_GEMMA_SEQ
    want = {"prefill_32k": {"flash_attention": L},
            "generate": steps(cfg, P5_PREFILL_B, S),
            "decode_32k": per_step(cfg, P5_DECODE_B,
                                   LM_SH["decode_32k"]["seq_len"]),
            "long_500k": per_step(cfg, 1, LM_SH["long_500k"]["seq_len"]),
            "gemma_prefill_8k": {"flash_attention": gcfg.n_layers},
            "gemma_generate": steps(gcfg, 1, Sg)}
    for name, n in want.items():
        # the bf16 serve stages run the tensor-core kernels, never the
        # FP32-pipe flash_attention_f32
        check(launches[name] == n, f"{name}: flash-attention launches "
              f"{launches[name]}, want {n}")
    print(f"[phase5] llama3.2-3b: {L} layers, d {cfg.d_model}, {cfg.n_heads}"
          f" heads over {cfg.n_kv_heads}, head dim {hd}, ff {cfg.d_ff}, "
          f"vocab {cfg.vocab_size}, f32 params ({n_bytes / 1e9:.3f} GB), "
          f"bf16 compute; gemma-2b: {gcfg.n_layers} layers, head dim "
          f"{gcfg.resolved_head_dim}, MQA")
    print(f"[phase5] seconds={json.dumps({k: round(v, 4) for k, v in secs.items()})}")
    print(f"[phase5] peak device memory GB per stage="
          f"{json.dumps({k: round(v, 3) for k, v in peaks.items()})}")
    print(f"[phase5] generate: {GEN_STEPS} tokens {out_tokens}; seconds per "
          f"token {[round(v, 5) for v in step_s]} (median after the first "
          f"{notes['generate_s_per_token']:.5f}); attention of one step "
          f"(CUDA events) {notes['generate_attention_ms']:.4f} ms")
    for name in ("decode_32k", "long_500k"):
        s_ = statistics.median(notes[f"{name}_step_s"])
        a_ms = notes[f"{name}_attention_ms"]
        print(f"[phase5] {name}: step seconds "
              f"{[round(v, 5) for v in notes[f'{name}_step_s']]}; attention "
              f"{a_ms:.4f} ms of the median {s_ * 1e3:.4f} ms, the rest "
              f"{s_ * 1e3 - a_ms:.4f} ms")
    print(f"[phase5] decode_32k repeated steps bitwise equal: "
          f"{notes['decode_32k_repeat_bitwise']}")
    print(f"[phase5] card vs CPU (2 layers, f32, B {CHECK_LM_B}, S "
          f"{CHECK_LM_S}) and bf16 consistency, gap / tolerance: "
          f"{json.dumps({k: float(f'{v:.3g}') for k, v in gaps.items()})}")
    print(f"[phase5] launches per stage={json.dumps(launches)}")
    total = {}
    for per in launches.values():
        add(total, per)
    return total


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
    logs = common.build(["rq_assign", "queue_gather", "ppr_walk",
                         "fused_contrastive", "embedding_bag",
                         "flash_attention"])
    print(f"[phase0] built {sorted(logs)} in "
          f"{time.perf_counter() - t:.2f} s")
    for kname, log in logs.items():
        fn = ""
        for line in log.splitlines():
            if "Function properties for" in line:
                fn = line.split("for", 1)[1].strip()
            elif "registers" in line or "spill" in line:
                print(f"[phase0] {kname} {fn}: {line.strip()}")
    fa_lib = ctypes.CDLL(str(common.library_path("flash_attention")))
    for kname, dec in (("tile (fa_wgmma at D 64-256, fa_mma at D 32)",
                        0), ("decode (fa_decode)", 1)):
        print(f"[phase0] flash_attention {kname} dynamic shared memory "
              f"bytes by head dim: " + ", ".join(
                  f"D {d}: {fa_lib.flash_attention_smem(dec, d)}"
                  for d in FA.HEAD_DIMS))

    g = torch.Generator(device=dev).manual_seed(args.seed)
    rows = [phase1_rq_assign(g, dev, peaks), phase1_queue_gather(g, dev, peaks),
            phase1_ppr_walk(g, dev, peaks),
            *phase1_fused_contrastive(g, dev, peaks),
            *phase1_embedding_bag(g, dev, peaks)]
    rows += phase1_flash_attention(g, dev, peaks)
    t = time.perf_counter()
    launches = phase2(args.seed, dev)
    print(f"[phase2] wall {time.perf_counter() - t:.2f} s")
    launches3 = phase3(args.seed, dev)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    launches4 = phase4(args.seed, dev)
    print(f"[phase4] wall {time.perf_counter() - t:.2f} s")
    torch.cuda.empty_cache()             # Phase 4's tables took 66.56 GB
    t = time.perf_counter()
    launches5 = phase5(args.seed, dev)
    print(f"[phase5] wall {time.perf_counter() - t:.2f} s")
    for r in rows:
        r["launches"] = next(ls[r["name"]] for ls in (
            {n: launches[n] for n in SLICE1}, launches4, launches5,
            launches3) if r["name"] in ls)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
