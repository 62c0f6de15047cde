#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) once on one GPU.

    python3 chip_smoke.py [--seed 0]
    python3 chip_smoke.py --selection-sweep STEPS   # Phase 3's RQ check
    python3 chip_smoke.py --contrastive-only   # Phase 1's fused_contrastive
    python3 chip_smoke.py --attention-only     # Phase 1's flash_attention
    python3 chip_smoke.py --decode-only REPS   # Phase 5's decode steps

Phase 0 prints the card (``nvidia-smi`` name and power limit) and
builds every CUDA kernel from ``src/repro_torch/csrc`` with nvcc, one
process per source, all at once.  Phase 1 holds each kernel against its
plain PyTorch version on the card, at the shapes the main path gives it,
and times both with CUDA events (for ``ppr_walk``, ``queue_gather``,
``fused_contrastive`` and ``flash_attention`` also the device's own time,
with the card kept busy before the first event); ``ppr_walk`` also at
its edge shapes (dangling starts, restart 1.0, one walker of one step,
the largest trace, D2 100 and 8) and ``queue_gather`` at its own (empty
rings, no seed in the recency window, a window that needs whole rings,
one repeated item, the largest R and k, K 15 and 1, unknown clusters,
ids above 2^24, a repeat), each bitwise.  The ``fused_contrastive``
backward must repeat bitwise and hold against its plain version at its
edge shapes in both types (one row, one negative, scalar-load widths,
Phase 8d's d 24, the old kernel's largest row block and widest row,
rows off 16-byte alignment, the register path's widest row); Phase 0
holds its shared memory against the wrapper's count.  The
flash-attention kernels fold their own kv splits in one launch: at 2, 5
and 11 forced splits on all three kernels, and at the split main-path
shapes (decode_32k, long_500k), the output is also held against
``merge_ref`` of the partials the same launch returns, and at the
main-path shapes a second launch must give the same bits.  The
attention backward (``flash_attention_bwd``: a dq pass, then a dkdv
pass) runs at lm_loss's shapes, the reduced one (B 4, S 64, 4 heads, D
32, f32), olmo-1b, llama3.2-3b and gemma-2b (B 1, S 4,096; bf16), an
f32 case at D 128 and ragged tiles (S a multiple of no tile) at D 32, 64
and 256, on the output and lse of the forward's training
route: dQ, dK and dV against autograd of ``chunked_attention_ref`` on
the card and against the closed form ``attention_bwd_ref`` (per entry
against the sums of the terms' magnitudes, and norm-wise over each
block of 64 positions of a head, also on dO weighted by position, with
a planted lost 64-row tile and a lost split partial that must read
above that limit), a second launch bitwise, at olmo-1b's shape also
the dkdv pass at 4 forced splits a key tile (held the same way, and
bitwise repeated), the lse against the plain one, the grad-off forward
bitwise equal to the training route's output; it prints the dkdv plan
(``bwd_plan``) and device ms beside a FLOP bound of 10 D per kept
(query, key) pair and SDPA's forward and backward under autograd, and
checks the F1 guard (every case the backward does not take raises under
grad).
``--attention-only`` runs only the forward's checks, then prints the
whole op's times and a hash of its output at decode_32k and long_500k
and hashes of the forced-split outputs, then the backward's checks.
``--decode-only REPS`` prints the same whole-op lines, then runs only
Phase 5's decode_32k and long_500k steps, each timed REPS times, with a
hash of their logits; it calls only the model's and
``flash_attention``'s entry points, so that two trees can be compared in
one call on one card.

Phase 2 runs the publish-and-serve path at the full width of the
``rankgraph2`` configuration (bf16 compute, d 256, 4 heads, hidden
1024, K_IMP 50, K' 10, RQ codebooks 5000 x 50 = 250,000 clusters) on
1,048,576 users and 262,144 items with random weights from ``--seed``:
``embed_all`` for both node types, ``build_snapshot`` (rq_assign
kernel), a ``ClusterQueueStore`` fed 8,388,608 events over two hours,
then ``serve_batch`` (queue_gather kernel) for 8 batches of 512 requests
and one of 262,144, and checks what comes out.  It then serves the bulk
batch once more piece by piece, each piece synced, and prints where its
host time goes.

Phase 3 runs the construct-and-train path, ``run_pipeline``, at the same
width on a topic-clustered one-day log of 262,144 users and 65,536
items made with numpy: ``build_graph`` on the host, the PPR tables
(ppr_walk kernel, 4,096 starts per launch), 20 train steps of 10,922
edges per type (the fused_contrastive forward and backward kernels, 7
of each per step), then ``embed_all`` and ``assign_codes`` (rq_assign).
It re-runs the PPR stage piece by piece and prints where its time goes
(host adjacency build, uniforms, copies, launches, top-k), and checks
the traces and tables against the numpy walker and top-k, the losses,
that every parameter moved, the launch counts, one step's losses on the
card against the CPU (the CPU on the card's RQ selections, which bf16
rounding flips for some rows in some trained states), and the
embeddings.  In f32 it runs
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
decode on ``flash_attention_decode`` with a split kv range, folded in
the same launch (one launch a layer); the f32 check runs
``flash_attention_f32``.  It checks shapes and finite values, the launch
counts by kernel, llama at 2 layers card vs CPU in f32 (prefill logits,
caches, one decode step within 1e-3), and the prefill/decode consistency
on the card in bf16.

Phase 6 runs the hour-level refresh cycle at the same width on Phase
3's log: ``build_graph(keep_state=True)`` and the device PPR tables on
the events of the first 23 hours, then ``incremental_refresh`` (device
backend: the ppr_walk kernel re-walks the affected nodes) with the
trailing hour plus fresh events of 1,024 new users and on 2,048 new
items (both id spaces grow) and the grown features as ``prev_emb``
(the Group-2 fill), then 10 train steps on the refreshed graph
(fused_contrastive), the burst's closing ``reset_dead_codes`` on a
freshly embedded probe of 512 nodes, and the repair-path reset with the
probe's code counts (``assign_codes``: rq_assign, before and after),
one train step and one ``make_eval_step`` after it.  It prints the
refresh's seconds (the report's pieces, and ``ppr_refresh`` re-run
piece by piece, each synced, its launches in CUDA events), the touched
and affected shares and the Group-2 rows filled, and checks: the
refreshed graph (every edge set, both ``group1`` masks) bitwise equal
to a from-scratch rebuild on the merged log, the affected table rows
equal to the rebuild's and the others to the remapped old tables, the
re-walked traces of a sample of starts equal to the numpy walker's; the
reset bitwise equal to the same call on a CPU copy of the state, the
``Parameter`` objects, live codebook rows, every other parameter, the
optimizer's state, histograms and pool unchanged, every probe row whose
layer-0 code moves moved to a revived code, finite losses after it, and
the eval step equal to ``forward_losses(train=False)``.

Phase 7 runs the lifecycle loop at the same width on Phase 6's
refreshed graph, tables and grown feature tables (no second build),
through the entry points a user calls: ``LifecycleRuntime.run_cycle``
(10-step bursts of 10,922 edges per type, cut from 50; the gate with
every floor at 0, so both swaps happen, on 25 recall queries, cut from
400: on the index these bursts publish, one layer-0 list holds nearly
every user, so each query ranks them all, and the whole script must fit
its limit on a slow host; snapshots in a temporary
directory), ``SwapServer.ingest`` / ``serve_batch`` and
``recover_serving``.  The gate's world is a next-day log made with numpy
from Phase 3's topic model (the same users' home topics, Poisson(2)
events each; no published source): its first 15 minutes are cycle 1's
refresh delta and the live traffic, the rest the ground truth.  Cycle 0
trains, publishes (``embed_all``, ``rq_assign``, the I2I KNN, the gate)
and brings serving up; the server ingests day 0's last two hours and the
15 minutes, serves 8 x 512 requests and 262,144 (``queue_gather``);
cycle 1 refreshes on the device backend (``ppr_walk``), trains,
publishes and swaps (ring replay, post-swap probe); the server serves
again; a fresh runtime on the same directory recovers.  It checks: no
stage failed or degraded, versions 1 and 2 on disk, the swap's replayed
and stale events against the ring counted in numpy, every response's
version, 512 bulk rows of each serve stage bitwise against the plain
version, 4,096 published codes against ``rq_assign``'s plain version
(near ties aside), version 2's gate recomputed on CPU copies equal to
the report's, the recovered snapshot bitwise equal to version 2, the trace's
stage spans under each ``lifecycle.cycle``, and the launches of the five
main-path kernels.

Phase 8 runs serving scale-out right after Phase 2, on its snapshot,
embeddings and event stream, in four parts.  8a feeds the 8,388,608
events into four stores on the card: unsharded direct, unsharded with
a delta run of 512 (the reference's depth, ``delta_cap``), 4 shards
direct and 4 shards with the delta run (``ShardedQueueStore``, every
shard on the one card), serves 8 x 512 and 262,144 requests on each
(``queue_gather``, one launch a shard), and checks: the seeds, unions
and cursors bitwise equal across the four, 512 bulk rows equal to the
plain ``queue_gather`` on the CPU, one launch a shard for each serve
batch, the ``.shard{i}`` ingest counters summing to the aggregate.  8b
is ``benchmarks/serving_scaleout.py``'s shard measurement on the card
(C 4,096, Q 256, delta 512, 200,000 users, 1,000,000 items, 4 x 100,000
warm events, mixed cycles of 12,000 events and a 2,048-user retrieve at
k 32, shards 1/2/4, best of 12 interleaved rounds; each round's events
go to all three stores, whose rows must be equal); it prints the times
and the scaling and gates nothing.  8c builds version 2 with
``build_snapshot`` from Phase 2's embeddings plus noise (rq_assign),
pushes every 8th batch of the stream (1,048,576 events, half of them
older than the recency window) through two ``SwapServer`` instances, one with
4 shards and the delta run and one unsharded direct, swaps both to
version 2 and checks their swap accounting against the ring counted in
numpy, and their served rows and versions equal.  8d runs
``run_chaos`` (``default_specs()``, 6 cycles, its small world) on the
card and checks the four invariants, every required fault site, a
crash and a recovery, and prints the span tree that
``repro_torch.obs.report`` renders from its trace.

Phase 9 runs LM training at the full width of ``olmo-1b`` (16 layers, d
2,048, 16 heads at head dim 128, ff 8,192, vocab 50,304, f32 params,
bf16 compute, each layer rematerialised) with random weights from
``--seed``: three AdamW steps (lr 1e-3, as ``run_lm``) of ``lm_loss`` on
one batch of B 1 x S 4,096 tokens (train_4k's global batch of 256 x
4,096 cut to one sequence).  It checks that the loss is finite and falls
on the repeated batch, that every parameter gets a finite, non-zero
gradient, and each step's launches by kernel (the forward with lse, the
remat recompute, the two backward passes); it prints the step's split
(forward, backward, optimizer), attention's own time in CUDA events and
the peak memory beside the bytes it reckons.  Then two layers of
olmo-1b, llama3.2-3b and gemma-2b at full width (B 1, S 256; 128 for
gemma's 256,000 vocab): in f32 the loss and every gradient on the card
against the CPU's plain attention within ``close(..., 1e-3)``, and in
bf16 against the plain attention on the card (loss within 2^-7, each
gradient within 2^-4 norm-wise: bf16 rounds at other places through
both layers, so no per-entry bound holds).

Each path's launch counts are zeroed just before it runs and read just
after: ``rq_assign`` and ``queue_gather`` report Phase 2's,
``ppr_walk`` and ``fused_contrastive_*`` Phase 3's, ``embedding_bag_*``
Phase 4's serve and train stages, ``flash_attention*`` Phase 5's serve
stages; Phase 6's launches of ``rq_assign``, ``ppr_walk`` and
``fused_contrastive_*``, Phase 7's of those and ``queue_gather``,
Phase 8's of ``queue_gather``, ``rq_assign`` and
``fused_contrastive_*``, and Phase 9's main run's of ``flash_attention``
and ``flash_attention_bwd_*`` are added to those.  Every kernel in the
list must have launched on its path.

The second-to-last line is a JSON object listing every ported kernel
(launches on the main path, error against the plain version, times and
the card's bound), and the whole attention backward beside its two
passes (``flash_attention_bwd``: its launches are the dq pass's, one a
backward; its bound the function's 10 D a kept pair; SDPA's backward as
its library time); the last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or without the rest of
the repository beside it, the script fails before printing any result.
"""
from __future__ import annotations

import argparse
import copy
import ctypes
import dataclasses
import hashlib
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs.base import (LM_SHAPES,  # noqa: E402
                                      RANKGRAPH2_SHAPES, RECSYS_SHAPES,
                                      get_arch)
from repro_torch.configs.rankgraph2 import CONFIG  # noqa: E402
from repro_torch.core import model as M  # noqa: E402
from repro_torch.core.graph_builder import (EngagementLog,  # noqa: E402
                                            build_graph)
from repro_torch.core.negatives import negative_draws  # noqa: E402
from repro_torch.core.pipeline import run_pipeline  # noqa: E402
from repro_torch.core.ppr import (_expand_affected,  # noqa: E402
                                  _topk_from_counts,
                                  _topk_from_counts_device, _walk_numpy,
                                  adjacency_to_device,
                                  build_padded_hetero_adj,
                                  global_visit_mass, walk_uniforms)
from repro_torch.core.rq_index import (RQState, assign_codes,  # noqa: E402
                                       codebooks_module, dead_code_reset,
                                       init_rq, layer_books,
                                       per_code_counts)
from repro_torch.core.serving import (ClusterQueueStore,  # noqa: E402
                                      ShardedQueueStore)
from repro_torch.core.trainer import (FeatureStore, embed_all,  # noqa: E402
                                      forward_losses, init_state,
                                      loss_directions, make_eval_step,
                                      make_train_step, named_params,
                                      reset_dead_codes)
from repro_torch.data.edge_dataset import (EdgeDataset,  # noqa: E402
                                           NeighborTables,
                                           build_neighbor_tables,
                                           incremental_refresh)
from repro_torch.data.synthetic import SyntheticWorld  # noqa: E402
from repro_torch.faults import (REQUIRED_SITES,  # noqa: E402
                                default_specs, run_chaos)
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.embedding_bag import (  # noqa: E402
    embedding_bag as EB)
from repro_torch.kernels.embedding_bag.ref import (  # noqa: E402
    embedding_bag_bwd_ref, embedding_bag_ref)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention as FA, ops as FA_OPS)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_bwd_ref, attention_ref, block_gap, chunked_attention_ref,
    merge_ref)
from repro_torch.kernels.fused_contrastive import (  # noqa: E402
    fused_contrastive as FC)
from repro_torch.kernels.fused_contrastive.ref import (  # noqa: E402
    bwd_ref, fwd_ref)
from repro_torch.kernels.ppr_walk import ppr_walk as PW  # noqa: E402
from repro_torch.kernels.ppr_walk.ops import (  # noqa: E402
    ppr_walk as ppr_walk_op)
from repro_torch.kernels.ppr_walk.ref import (  # noqa: E402
    last_valid_cols as ppr_last_valid_cols, ppr_walk_ref)
from repro_torch.kernels.queue_gather import queue_gather as QG  # noqa: E402
from repro_torch.kernels.queue_gather import ops as QG_OPS  # noqa: E402
from repro_torch.kernels.queue_gather.ref import (  # noqa: E402
    dup_of_earlier, queue_gather_ref, ring_window)
from repro_torch.kernels.rq_assign import rq_assign as RQA  # noqa: E402
from repro_torch.kernels.rq_assign.ref import rq_assign_ref  # noqa: E402
from repro_torch.launch.steps import (lm_decode_step,  # noqa: E402
                                      lm_prefill_step, recsys_retrieval_step,
                                      recsys_serve_step, recsys_train_step,
                                      top_k)
from repro_torch.lifecycle import (LifecycleConfig,  # noqa: E402
                                   LifecycleRuntime)
from repro_torch.lifecycle.publish import (build_snapshot,  # noqa: E402
                                           encode_corpus, evaluate_snapshot,
                                           snapshot_health)
from repro_torch.lifecycle.swap import SwapServer  # noqa: E402
from repro_torch.models.lm import model as LM  # noqa: E402
from repro_torch.models.recsys import models as R  # noqa: E402
from repro_torch.obs import MemorySink, Telemetry  # noqa: E402
from repro_torch.obs.report import render  # noqa: E402
from repro_torch.optim.optimizers import (adamw,  # noqa: E402
                                          apply_updates,
                                          rankgraph2_optimizer)

N_USERS, N_ITEMS = 1_048_576, 262_144
N_EVENTS, INGEST_BATCH, SPAN_S = 8_388_608, 65_536, 7200.0
T0 = 1.7e9                   # Phase 2's first event (unix seconds)
QUEUE_LEN, RECENCY_S, N_RECENT, K_UNION, I2I_K = 256, 3600.0, 8, 32, 16
SHAPES = {s.name: s.dims for s in RANKGRAPH2_SHAPES}
P99_BATCH = SHAPES["serve_p99"]["batch"]       # 512
BULK_BATCH = SHAPES["serve_bulk"]["batch"]     # 262,144
P99_REPS = 8
RQ_ROWS = 65_536             # rq_assign_corpus chunk on the main path
QG_CLUSTERS = 250_000        # 5000 x 50 RQ clusters
NEAR_TIE = 1e-4              # |d2 gap| <= NEAR_TIE * (1 + |d2|)
RQ_OFFSET = 4133             # a chunk start that is not a multiple of 128
RQ_EDGES = (                 # (what, rows, d, codebook sizes)
    ("B 65,573", RQ_ROWS + 37, 256, (5000, 50)),
    ("B 1", 1, 256, (5000, 50)),
    ("n 129, 1 and 50", 4133, 256, (129, 1, 50)),
    ("d 36, L 3", 8192, 36, (300, 77, 5)),
    ("d 260, L 8", 8192, 260, (200, 100, 64, 50, 33, 17, 2, 1)),
    (f"d {RQA.D_MAX}, the largest", 8192, RQA.D_MAX, (1000, 50)),
)
PPR_DEG = 32                 # max_deg_per_type: D2 = 64
PPR_STARTS = 4096            # starts per walk chunk on the main path
PPR_NODES = 1_310_720        # adjacency rows of the Phase 1 walk
BIG_NODES = (1 << 24) + 4096  # a walk over ids above 2^24
PPR_EDGE_NODES = 65_536      # adjacency rows of the D2 100 and 8 walks
PPR_BIG_TRACE_STARTS = 64    # starts of the largest-trace walk
LEAD_CYCLES = 2_000_000      # time_ms(lead=True): about 1 ms of spinning
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
P6_CUT_S = 82_800.0          # Phase 6's initial build: events up to 23 h
P6_NEW_USERS, P6_NEW_ITEMS = 1024, 2048   # grown in the delta
P6_ITEM_EVENTS = 4           # Poisson mean of a new item's events
P6_STEPS = 10                # the train burst on the refreshed graph
P6_TRACES = 4096             # re-walked starts held against numpy
EMBED_BATCH = 2048           # the lifecycle's embed batch (probe embeds)
P7_STEPS = 10                # steps a lifecycle burst, cut from 50
P7_QUERIES = 25              # the gate's recall queries, cut from 400
P7_EVENTS = 2                # Poisson mean of a user's next-day events
P7_DELTA_S = 900.0           # the next day's first 15 minutes
P7_RECENCY_S, P7_RING = 7200.0, 1 << 20
P7_TAIL_S = 7200.0           # day 0's last two hours, ingested live
P7_SAMPLE = 512              # served rows held against the plain version
P7_CODE_SAMPLE = 4096        # published codes held against the plain version
P8_DELTA = 512               # the reference's delta depth (serving_scaleout)
P8_SHARDS = 4
P8_SWAP_EVERY = 8            # 8c's ring: every 8th batch of Phase 2's stream
P8_NOISE = 0.02              # 8c: version 2's embedding perturbation
P8_CHAOS_CYCLES = 6
# 8a's mixed traffic: rounds of one ingest of P8_MIX_EVENTS (four delta
# runs of 512, so every serve after it finds a pending run) and one
# serve_p99 batch, as a swap server drains its ring between serves
P8_MIX_ROUNDS, P8_MIX_EVENTS = 32, 2_048
P8_TREE_LINES = 16
SO_USERS, SO_ITEMS = 200_000, 1_000_000      # 8b: the reference's shape
SO_C, SO_WARM, SO_E, SO_ROUNDS = 4096, 100_000, 12_000, 12
SNAP_FIELDS = ("user_codes", "item_codes", "user_clusters", "member_ptr",
               "member_ids", "coarse_codebook", "i2i")
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
OLMO = get_arch("olmo-1b").config   # bf16 compute, f32 params, remat
P9_B, P9_S = 1, 4096         # one sequence of train_4k's 256 x 4,096
P9_STEPS, P9_LR = 3, 1e-3    # AdamW as run_lm
P9_CHECK_LAYERS = 2
P9_CHECK_S = {"olmo-1b": 256, "llama3.2-3b": 256, "gemma-2b": 128}
P9_BF16_LOSS = 2.0 ** -7     # bf16, kernels vs plain attention: the loss
P9_BF16_NORM = 2.0 ** -4     # ... and each gradient, norm-wise


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


def time_ms(fn, reps: int, lead: bool = False) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs, after one
    warm-up run.  The card is idle when the first event is recorded, so
    the time includes what the host spends in ``fn`` before its first
    launch; with ``lead`` the card first spins for about a millisecond
    (``torch.cuda._sleep``), which hides that host time and leaves the
    device's own."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if lead:
            torch.cuda._sleep(LEAD_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def host_ms(fn, reps: int) -> float:
    """Host time of one call of ``fn``: ``reps`` calls back to back on
    the host clock, the card not waited for (their launches queue)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t
    torch.cuda.synchronize()
    return t / reps * 1e3


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

def rq_inputs(g: torch.Generator, B: int, d: int, sizes, dev):
    x = torch.randn((B, d), generator=g, device=dev)
    x = x / x.norm(dim=1, keepdim=True)
    books = [torch.randn((n, d), generator=g, device=dev) * (0.1 / (l + 1))
             for l, n in enumerate(sizes)]
    return x, books


def near_ties(x, ck, cp, books, what: str) -> int:
    """Every row where codes ``ck`` differ from the plain version's
    ``cp`` must be a near-tie at its first differing layer: the two
    codes' squared distances to the residual (in f64) within
    ``NEAR_TIE * (1 + d2)``.  Returns the number of such rows."""
    near = 0
    for row in torch.nonzero(~(ck == cp).all(dim=1)).flatten().tolist():
        r = x[row].double()
        for l, C in enumerate(books):
            a, b = int(ck[row, l]), int(cp[row, l])
            if a != b:
                da = float(((r - C[a].double()) ** 2).sum())
                db = float(((r - C[b].double()) ** 2).sum())
                check(abs(da - db) <= NEAR_TIE * (1 + abs(db)),
                      f"rq_assign {what} row {row} layer {l}: code {a} "
                      f"(d2 {da}) vs plain {b} (d2 {db}) is not a near-tie")
                near += 1
                break
            r = r - C[a].double()
    return near


def rq_held(x, books, what: str):
    """Hold ``rq_assign`` against ``rq_assign_ref`` on (x, books): every
    differing row a near-tie at its first differing layer, recon within
    1e-6 on matching rows, and exact ties broken to the lowest index.
    Returns the kernel's (codes, recon), near-tie rows, recon error and
    tied rows."""
    ck, rk = RQA.rq_assign(x, books)
    cp, rp = rq_assign_ref(x, books)
    torch.cuda.synchronize()
    same = (ck == cp).all(dim=1)
    near = near_ties(x, ck, cp, books, what)
    err = float((rk[same] - rp[same]).abs().max()) if same.any() else 0.0
    check(err <= 1e-6, f"rq_assign {what}: recon differs on matching rows: "
          f"{err}")
    # exact ties: in the first layer with two codes or more, copy the
    # most chosen code to another index; every row that chose it must
    # take the lower of the two, none the higher (the residual entering
    # that layer is unchanged, so the two distances are bitwise equal)
    l0 = next(l for l, C in enumerate(books) if C.shape[0] > 1)
    last = books[l0].shape[0] - 1
    top = int(torch.mode(ck[:, l0]).values)
    other = last if top != last else 0
    tied = [b.clone() for b in books]
    tied[l0][other] = tied[l0][top]
    ct, _ = RQA.rq_assign(x, tied)
    lo, hi = min(top, other), max(top, other)
    n_tied = int((ct[:, l0] == lo).sum())
    check(n_tied > 0 and not bool((ct[:, l0] == hi).any()),
          f"rq_assign {what} does not break exact ties to the lowest index")
    return ck, rk, near, err, n_tied


def phase1_rq_assign(g: torch.Generator, dev, peaks) -> dict:
    d = CONFIG.d_embed
    sizes = CONFIG.rq.codebook_sizes
    x, books = rq_inputs(g, RQ_ROWS, d, sizes, dev)
    ck, rk, near, err, n_tied = rq_held(x, books, "main shape")
    # bitwise: a chunk that starts mid-block, and a repeat
    s = RQ_OFFSET
    cs, rs = RQA.rq_assign(x[s:], books)
    check(torch.equal(cs, ck[s:]) and torch.equal(rs, rk[s:]),
          f"rq_assign(x[{s}:]) differs from rq_assign(x)[{s}:]")
    c2, r2 = RQA.rq_assign(x, books)
    check(torch.equal(c2, ck) and torch.equal(r2, rk),
          "rq_assign does not repeat bitwise")
    for what, B, de, sz in RQ_EDGES:
        xe, be = rq_inputs(g, B, de, sz, dev)
        _, _, ne, ee, te = rq_held(xe, be, what)
        err = max(err, ee)
        print(f"[phase1] rq_assign edge {what}: rows={B} d={de} books={sz} "
              f"near_tie_rows={ne} recon_max_abs_err={ee:.3g} "
              f"exact_tie_rows={te} (lowest index kept)")
    ms = time_ms(lambda: RQA.rq_assign(x, books), 10)
    plain_ms = time_ms(lambda: rq_assign_ref(x, books), 3)
    # x @ C_0^T alone in cuBLAS SGEMM (TF32 off, PyTorch's default): what
    # this card's FP32 GEMM reaches at the cross term's shape.  Not the
    # same function (no norms, no argmin, no second layer), so it is no
    # library_ms.
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    sgemm_ms = time_ms(lambda: x @ books[0].T, 10)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    n_sum = sum(sizes)
    L = len(books)
    ops = 2.0 * RQ_ROWS * d * n_sum
    nbytes = 4.0 * (2 * RQ_ROWS * d + n_sum * d + RQ_ROWS * L)
    bound_ms = max(ops / peaks[0], nbytes / peaks[1]) * 1e3
    bound_by = "operations" if ops / peaks[0] >= nbytes / peaks[1] \
        else "bytes"
    tflops = ops / ms * 1e-9
    print(f"[phase1] rq_assign rows={RQ_ROWS} books={sizes}"
          f" near_tie_rows={near} recon_max_abs_err={err:.3g} "
          f"exact_tie_rows={n_tied} (lowest index kept) "
          f"offset_{s}_bitwise=True repeat_bitwise=True "
          f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"bound_ms={bound_ms:.4f} ({bound_by}) tflops={tflops:.2f} "
          f"fp32_peak_share={tflops * 1e12 / peaks[0]:.3f} "
          f"sgemm_ms={sgemm_ms:.4f} (x @ C_0.T, TF32 off)")
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


def qg_held(case: str, items, times, cursor, cl, i2i, cutoff: float,
            R: int, k: int):
    """Hold ``queue_gather`` on these inputs bitwise against
    ``queue_gather_ref``.  Returns the kernel's (seeds, union)."""
    sk, uk = QG.queue_gather(items, times, cursor, cl, i2i, cutoff=cutoff,
                             n_recent=R, k=k)
    sp, up = queue_gather_ref(items, times, cursor, cl, i2i, cutoff=cutoff,
                              n_recent=R, k=k)
    torch.cuda.synchronize()
    check(torch.equal(sk, sp) and torch.equal(uk, up),
          f"queue_gather ({case}) differs from its plain version")
    return sk, uk


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
    del base, narrow, wide
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
        sk, uk = qg_held(f"B {B}", items, times, cursor, cl, i2i, cutoff,
                         N_RECENT, K_UNION)
        def run():
            return QG.queue_gather(items, times, cursor, cl, i2i,
                                   cutoff=cutoff, n_recent=N_RECENT,
                                   k=K_UNION)

        ms, device_ms = time_ms(run, 20), time_ms(run, 20, lead=True)
        plain_ms = time_ms(lambda: queue_gather_ref(
            items, times, cursor, cl, i2i, cutoff=cutoff,
            n_recent=N_RECENT, k=K_UNION), 3)
        nbytes = queue_gather_bytes(items, times, cursor, cl, i2i, cutoff,
                                    N_RECENT, K_UNION)
        bound_ms = nbytes / peaks[1] * 1e3
        rpw, blocks = QG.launch_plan(
            B, torch.cuda.get_device_properties(dev).multi_processor_count)
        print(f"[phase1] queue_gather C={C} Q={Q} B={B} R={N_RECENT} "
              f"k={K_UNION} K={K} requests_per_warp={rpw} blocks={blocks} "
              f"bitwise_equal=True kernel_ms={ms:.4f} "
              f"device_ms={device_ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={bound_ms:.5f} (bytes {nbytes:.0f}; "
              f"{nbytes / 1e6 / device_ms:.1f} GB/s of device time)")
        out[B] = (0, ms, plain_ms, bound_ms)
        if B == BULK_BATCH:
            s2, u2 = run()
            check(torch.equal(s2, sk) and torch.equal(u2, uk),
                  "queue_gather does not repeat bitwise")
    qg_edges(g, dev, items, times, cursor, i2i, cutoff)
    err, ms, plain_ms, bound_ms = out[BULK_BATCH]
    return dict(name="queue_gather", route="cuda",
                source="src/repro_torch/csrc/queue_gather.cu",
                replaces="src/repro/kernels/queue_gather/queue_gather.py:134",
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes", library_ms=None)


def qg_edges(g: torch.Generator, dev, items, times, cursor, i2i,
             cutoff: float) -> None:
    """``queue_gather`` at its edge shapes, each bitwise against the
    plain version at B 4,096 on the Phase 1 rings: every ring empty,
    rings of 255 (row starts off 16 bytes), a cutoff above every time, a recency window that passes 3% (the scan
    reads whole rings), rings of one repeated item, the largest R, k and
    a wider table (R 32, k 256, K 64), K 15 and K 1 (scalar row loads),
    R 1 k 1, every cluster unknown, and ids above 2^24 in the rings and
    the table (a table of 2^24 + 262,144 rows)."""
    C, Q = items.shape
    N = i2i.shape[0]
    B, R, k = 4096, N_RECENT, K_UNION
    cl = torch.randint(0, C, (B,), generator=g, device=dev,
                       dtype=torch.int32)
    def table(K, n=N, lo=0):
        t = torch.randint(lo, lo + N, (n, K), generator=g, device=dev,
                          dtype=torch.int32)
        return torch.where(torch.rand((n, K), generator=g, device=dev)
                           < 0.05, -1, t)

    held = []
    def hold(case, *a):
        sk, uk = qg_held(case, *a)
        held.append(f"{case} (seeds {float((sk >= 0).float().mean()):.3f}, "
                    f"union {float((uk >= 0).float().mean()):.3f} filled)")

    hold("every ring empty", items, times, torch.zeros_like(cursor), cl,
         i2i, cutoff, R, k)
    hold("Q 255", items[:, 1:].contiguous(),
         times[:, 1:].contiguous(), cursor, cl, i2i, cutoff, R, k)
    hold("cutoff above every time", items, times, cursor, cl, i2i,
         SPAN_S + 1.0, R, k)
    hold("3% window", items, times, cursor, cl, i2i, SPAN_S * 0.97, R, k)
    hold("one repeated item", torch.full_like(items, 7), times, cursor, cl,
         i2i, cutoff, R, k)
    hold("R 32 k 256 K 64", items, times, cursor, cl, table(64), cutoff,
         QG.MAX_R, QG.MAX_K)
    hold("K 15", items, times, cursor, cl, table(15), cutoff, R, k)
    hold("K 1", items, times, cursor, cl, table(1), cutoff, R, k)
    hold("R 1 k 1", items, times, cursor, cl, i2i, cutoff, 1, 1)
    off = torch.randint(0, 1 << 20, (B,), generator=g, device=dev,
                        dtype=torch.int32)
    unknown = torch.where(off % 2 == 0, -1 - off, C + off)
    hold("every cluster -1 or >= C", items, times, cursor, unknown, i2i,
         cutoff, R, k)
    big = table(I2I_K, n=BIG_ID + N, lo=BIG_ID)
    hold("ids above 2^24", torch.where(items >= 0, items + BIG_ID, -1),
         times, cursor, cl, big, cutoff, R, k)
    del big
    torch.cuda.empty_cache()
    print(f"[phase1] queue_gather edge shapes (B {B}) bitwise equal to the "
          f"plain version: {'; '.join(held)}; "
          f"B {BULK_BATCH} repeated bitwise")


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
    id of the walker's row.  A random 4-byte read moves at least a
    32-byte sector, so no walk comes near this bound."""
    return float(4 * n * W * 2 * L + 4 * n + 2 * 4 * n * W * L
                 + 8 * n * W * L)


def ppr_held(case: str, layout, nbrs, cum, last, starts, u,
             restart: float):
    """Hold the ``ppr_walk`` kernel on ``layout`` bitwise against
    ``ppr_walk_ref`` on (nbrs, cum), counts summing to the trace length
    in every row.  Returns the kernel's (visited, counts)."""
    vk, ck = PW.ppr_walk(layout, starts, u, restart=restart)
    vp, cp = ppr_walk_ref(nbrs, cum, starts, u, restart=restart, last=last)
    torch.cuda.synchronize()
    check(torch.equal(vk, vp) and torch.equal(ck, cp),
          f"ppr_walk ({case}) differs from its plain version")
    check(bool((ck.sum(dim=1) == u.shape[1] * u.shape[2] // 2).all()),
          f"ppr_walk ({case}) counts do not sum to the trace length")
    return vk, ck


def phase1_ppr_walk(g: torch.Generator, dev, peaks) -> dict:
    W, L, D2 = CONFIG.ppr_walks, CONFIG.ppr_len, 2 * PPR_DEG
    restart = CONFIG.ppr_restart
    out = {}
    for case, N, lo in (("1.3M nodes", PPR_NODES, 0),
                        ("ids above 2^24", BIG_NODES, 1 << 24)):
        nbrs, cum = random_adjacency(g, N, D2, dev, lo=lo)
        last = ppr_last_valid_cols(cum)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        layout = PW.walk_layout(nbrs, cum, last)
        b.record()
        b.synchronize()
        layout_ms = a.elapsed_time(b)
        starts = torch.randint(lo, N, (PPR_STARTS,), generator=g,
                               device=dev, dtype=torch.int32)
        u = torch.rand((PPR_STARTS, W, 2 * L), generator=g, device=dev)
        vk, _ = ppr_held(case, layout, nbrs, cum, last, starts, u, restart)
        if lo:
            check(int(vk.min()) >= lo, "big-id walk left the top ids")
        def walk():
            return PW.ppr_walk(layout, starts, u, restart=restart)

        ms, device_ms = time_ms(walk, 20), time_ms(walk, 20, lead=True)
        plain_ms = time_ms(lambda: ppr_walk_ref(
            nbrs, cum, starts, u, restart=restart, last=last), 3)
        nbytes = ppr_walk_bytes(PPR_STARTS, W, L)
        bound_ms = nbytes / peaks[1] * 1e3
        moved = float((vk != starts.repeat_interleave(W * L).view_as(vk)
                       ).float().mean())
        print(f"[phase1] ppr_walk {case}: N={N} D2={D2} starts="
              f"{PPR_STARTS} walks={W} len={L} bitwise_equal=True "
              f"max_id={int(vk.max())} share_away_from_start={moved:.4f} "
              f"kernel_ms={ms:.4f} device_ms={device_ms:.4f} "
              f"plain_ms={plain_ms:.4f} "
              f"bound_ms={bound_ms:.5f} (bytes {nbytes:.0f}) "
              f"walk_layout_ms={layout_ms:.4f} (once per adjacency)")
        out[case] = (ms, plain_ms, bound_ms)
        if not lo:
            ppr_edges(g, dev, nbrs, cum, last, layout, starts, u)
        del nbrs, cum, last, layout
        torch.cuda.empty_cache()
    ms, plain_ms, bound_ms = out["1.3M nodes"]
    return dict(name="ppr_walk", route="cuda",
                source="src/repro_torch/csrc/ppr_walk.cu",
                replaces="src/repro/kernels/ppr_walk/ppr_walk.py:106",
                max_abs_err=0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes", library_ms=None)


def ppr_edges(g: torch.Generator, dev, nbrs, cum, last, layout, starts,
              u) -> None:
    """``ppr_walk`` at its edge shapes, each bitwise against the plain
    version: on the 1.3M-node adjacency, starts on dangling rows, restart
    1.0 (timed: every step goes home and reads no adjacency, so this is
    the walk's floor of uniforms, hash count and writes), one walker of
    one step, and the largest trace (1,024 walkers of 12 steps); then
    widths D2 100 and 8 on adjacencies of their own."""
    W, L, restart = CONFIG.ppr_walks, CONFIG.ppr_len, CONFIG.ppr_restart
    n = PPR_STARTS
    dang = torch.nonzero(cum[:, -1] <= 0).flatten()[:n].to(torch.int32)
    vk, ck = ppr_held("dangling starts", layout, nbrs, cum, last, dang,
                      u[:len(dang)], restart)
    check(bool((vk == dang[:, None]).all()) and bool((ck[:, 0] == W * L)
                                                      .all()),
          "ppr_walk from a dangling start left it")
    vk, ck = ppr_held("restart 1.0", layout, nbrs, cum, last, starts, u,
                      1.0)
    check(bool((vk == starts[:, None]).all()), "restart 1.0 left home")
    def home():
        return PW.ppr_walk(layout, starts, u, restart=1.0)

    home_ms, home_device_ms = time_ms(home, 20), time_ms(home, 20, lead=True)
    u1 = torch.rand((n, 1, 2), generator=g, device=dev)
    ppr_held("W 1 L 1", layout, nbrs, cum, last, starts, u1, restart)
    big = torch.rand((PPR_BIG_TRACE_STARTS, PW.MAX_WALKS, 2 * 12),
                     generator=g, device=dev)
    ppr_held("W 1024 L 12", layout, nbrs, cum, last,
             starts[:PPR_BIG_TRACE_STARTS], big, restart)
    cases = [f"dangling starts ({len(dang)})", "restart 1.0", "W 1 L 1",
             f"W {PW.MAX_WALKS} L 12 (S {PW.MAX_WALKS * 12}, "
             f"{PW.smem_bytes(PW.MAX_WALKS * 12)} B shared)"]
    del big
    for D2 in (100, 8):
        nb2, cum2 = random_adjacency(g, PPR_EDGE_NODES, D2, dev)
        last2 = ppr_last_valid_cols(cum2)
        st2 = torch.randint(0, PPR_EDGE_NODES, (n,), generator=g,
                            device=dev, dtype=torch.int32)
        ppr_held(f"D2 {D2}", PW.walk_layout(nb2, cum2, last2), nb2, cum2,
                 last2, st2, u, restart)
        cases.append(f"D2 {D2} (N {PPR_EDGE_NODES})")
    print(f"[phase1] ppr_walk edge shapes bitwise equal to the plain "
          f"version, counts summing to S: {'; '.join(cases)}; restart 1.0 "
          f"at the main shape (no adjacency read) kernel_ms={home_ms:.4f} "
          f"device_ms={home_device_ms:.4f}")


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


def cf_inputs(g: torch.Generator, B: int, N: int, d: int, dtype, dev,
              offset: int = 0) -> tuple:
    """Unit-norm src, dst (B, d) and negs (B, N, d) of ``dtype``, and
    cotangents gm, gi at a batch mean's scale, N(0, 1) / B.  With
    ``offset`` each of the three lies ``offset`` elements into its
    storage, so its rows are not 16-byte aligned."""
    def unit(*shape):
        x = torch.randn(shape, generator=g, device=dev)
        x = (x / x.norm(dim=-1, keepdim=True)).to(dtype)
        if not offset:
            return x
        flat = torch.empty(x.numel() + offset, dtype=dtype, device=dev)
        view = flat[offset:].view(shape)
        view.copy_(x)
        return view
    gm = torch.randn(B, generator=g, device=dev) / B
    gi = torch.randn(B, generator=g, device=dev) / B
    return unit(B, d), unit(B, d), unit(B, N, d), gm, gi


def cf_bwd_held(what: str, src, dst, negs, gm, gi, m: float, tau: float
                ) -> float:
    """Hold the backward kernel against ``bwd_ref`` on the forward's
    s_pos and lse (``close``: f32 within 1e-4 relative, bf16 within one
    bf16 rounding, 2^-7): gradients in the input type.  Returns the
    largest absolute error."""
    sp, lse = fwd_ref(src, dst, negs, margin=m, tau=tau)[2:]
    bk = FC.fused_contrastive_bwd(src, dst, negs, gm, gi, sp, lse,
                                  margin=m, tau=tau)
    bp = bwd_ref(src, dst, negs, gm, gi, sp, lse, margin=m, tau=tau)
    torch.cuda.synchronize()
    rel = 1e-4 if src.dtype == torch.float32 else 2.0 ** -7
    err = 0.0
    for a, b in zip(bk, bp):
        check(a.dtype == src.dtype and a.shape == b.shape,
              f"fused_contrastive backward ({what}): gradient type or "
              f"shape is not the input's")
        err = max(err, float((a.float() - b).abs().max()))
        check(close(a, b, rel), f"fused_contrastive backward ({what}, "
              f"{src.dtype}) off the plain one")
    return err


def cf_edges(g: torch.Generator, dev, dtype, m: float, tau: float) -> None:
    """The backward at its edge shapes, each against ``bwd_ref``: one
    row; one negative; rows of no whole 16-byte units (scalar loads: N 7
    at d 100 in bf16, 102 in f32; N 3 at d 33); Phase 8d's N 16, d 24;
    the old kernel's largest f32 row block (N 224, d 256); rows one
    element off 16-byte alignment; the register path's widest row (d
    1024 in bf16, 512 in f32); and the largest d the old kernel took, at
    N 1 (23,242 in bf16, 19,369 in f32: the wide kernel).  Each line
    names the kernel's plan (``FC.bwd_plan``)."""
    es = torch.finfo(dtype).bits // 8
    old_d_max = (232448 - 4 * 5) // (8 + es)
    d_odd = 100 if es == 2 else 102       # no whole 16-byte units a row
    d_reg = 32 * 4 * 16 // es             # 4 units of 16 bytes a lane
    cases = (("one row", 1, CONFIG.n_negatives, CONFIG.d_embed, 0),
             ("one negative", 4096, 1, CONFIG.d_embed, 0),
             (f"d {d_odd}, scalar loads", 4096, 7, d_odd, 0),
             ("d 33, scalar loads", 4096, 3, 33, 0),
             ("Phase 8d's", 4096, 16, 24, 0),
             ("the old kernel's largest f32 block", 2048, 224, 256, 0),
             ("rows off 16-byte alignment", 1024, CONFIG.n_negatives,
              CONFIG.d_embed, 1),
             ("the register path's widest row", 512, 16, d_reg, 0),
             ("the old kernel's largest d", 64, 1, old_d_max, 0))
    done = []
    for what, B, N, d, off in cases:
        plan = FC.bwd_plan(N, d, dtype, aligned=not off)
        err = cf_bwd_held(what, *cf_inputs(g, B, N, d, dtype, dev, off),
                          m, tau)
        done.append(f"{what} (B {B}, N {N}, d {d}; {plan.path}, vpl "
                    f"{plan.vpl}, {plan.warps} warps): max_abs_err "
                    f"{err:.3g}")
    torch.cuda.empty_cache()
    name = str(dtype).replace("torch.", "")
    print(f"[phase1] fused_contrastive backward {name} edge "
          f"shapes held against the plain version: " + "; ".join(done))


def phase1_fused_contrastive(g: torch.Generator, dev, peaks) -> list:
    """Forward and backward kernels against the plain versions in f32
    and bf16 at the train step's shapes, timed as the wrapper's call
    (``kernel_ms``) and on the device alone (``device_ms``), with the
    share of the bound each reaches.  Tolerances (``close``): f32 and
    bf16 forward outputs and f32 gradients within 1e-4 relative (the
    same f32 arithmetic summed in another order); bf16 gradients within
    one bf16 rounding, 2^-7 relative, of the plain f32 result.  The
    backward must also repeat bitwise, and hold at its edge shapes
    (``cf_edges``)."""
    B, N, d = CF_ROWS, CONFIG.n_negatives, CONFIG.d_embed
    m, tau = CONFIG.margin, CONFIG.tau
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        src, dst, negs, gm, gi = cf_inputs(g, B, N, d, dtype, dev)
        fk = FC.fused_contrastive_fwd(src, dst, negs, margin=m, tau=tau)
        fp = fwd_ref(src, dst, negs, margin=m, tau=tau)
        torch.cuda.synchronize()
        f_err = max(float((a - b).abs().max()) for a, b in zip(fk, fp))
        for a, b in zip(fk, fp):
            check(close(a, b, 1e-4),
                  f"fused_contrastive forward ({dtype}) off the plain one")
        b_err = cf_bwd_held("main shape", src, dst, negs, gm, gi, m, tau)

        def fwd():
            return FC.fused_contrastive_fwd(src, dst, negs, margin=m,
                                            tau=tau)

        def bwd():
            return FC.fused_contrastive_bwd(src, dst, negs, gm, gi, fp[2],
                                            fp[3], margin=m, tau=tau)

        first, again = bwd(), bwd()
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(first, again)),
              f"fused_contrastive backward ({dtype}) does not repeat "
              f"bitwise")
        del first, again
        f_ms, f_dev = time_ms(fwd, 20), time_ms(fwd, 20, lead=True)
        f_plain = time_ms(lambda: fwd_ref(src, dst, negs, margin=m,
                                          tau=tau), 5)
        b_ms, b_dev = time_ms(bwd, 20), time_ms(bwd, 20, lead=True)
        b_host = host_ms(bwd, 20)
        out = torch.empty_like(negs)    # the card's rate for these bytes
        copy_ms = time_ms(lambda: out.copy_(negs), 20, lead=True)
        del out
        b_plain = time_ms(lambda: bwd_ref(src, dst, negs, gm, gi, fp[2],
                                          fp[3], margin=m, tau=tau), 5)
        es = src.element_size()
        fb, fby = contrastive_bound(B, N, d, es, False, peaks)
        bb, bby = contrastive_bound(B, N, d, es, True, peaks)
        name = str(dtype).replace("torch.", "")
        print(f"[phase1] fused_contrastive {name} B={B} N={N} d={d}: fwd "
              f"max_abs_err={f_err:.3g} kernel_ms={f_ms:.4f} "
              f"device_ms={f_dev:.4f} plain_ms={f_plain:.4f} "
              f"bound_ms={fb:.4f} ({fby}; share {fb / f_ms:.3f}, device "
              f"{fb / f_dev:.3f}); bwd max_abs_err={b_err:.3g} "
              f"kernel_ms={b_ms:.4f} device_ms={b_dev:.4f} "
              f"plain_ms={b_plain:.4f} bound_ms={bb:.4f} ({bby}; share "
              f"{bb / b_ms:.3f}, device {bb / b_dev:.3f}) host_ms="
              f"{b_host:.4f} plan={tuple(FC.bwd_plan(N, d, dtype))}; bwd "
              f"repeats bitwise; a copy_ of negs (the backward's bulk "
              f"bytes: negs read, d_negs written) device_ms="
              f"{copy_ms:.4f}")
        rows[dtype] = (f_err, f_ms, f_dev, f_plain, fb, fby, b_err, b_ms,
                       b_dev, b_plain, bb, bby)
        del src, dst, negs, fk, fp
        torch.cuda.empty_cache()
        cf_edges(g, dev, dtype, m, tau)
    # the main path trains in bf16: its numbers go into the kernels line
    (f_err, f_ms, f_dev, f_plain, fb, fby, b_err, b_ms, b_dev, b_plain, bb,
     bby) = rows[torch.bfloat16]
    src_file = "src/repro_torch/csrc/fused_contrastive.cu"
    jax_file = "src/repro/kernels/fused_contrastive/fused_contrastive.py"
    return [dict(name="fused_contrastive_fwd", route="cuda", source=src_file,
                 replaces=f"{jax_file}:93", max_abs_err=f_err, ms=f_ms,
                 device_ms=f_dev, plain_ms=f_plain, bound_ms=fb,
                 bound_by=fby, library_ms=None),
            dict(name="fused_contrastive_bwd", route="cuda", source=src_file,
                 replaces=f"{jax_file}:118", max_abs_err=b_err, ms=b_ms,
                 device_ms=b_dev, plain_ms=b_plain, bound_ms=bb,
                 bound_by=bby, library_ms=None)]


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


def check_fa_launches(got: dict, kernel: str, what: str):
    """One launch of ``plan``'s kernel, split or not (the kernels fold
    their own splits)."""
    want = {kernel: 1}
    check(got == want, f"{what}: launches {got}, want {want}")


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def phase1_flash_attention(g: torch.Generator, dev, peaks) -> list:
    """The forward kernels (whole op: one launch, which folds its own kv
    splits when ``plan`` splits the kv range) against
    ``chunked_attention_ref`` at the main path's four launch shapes in
    bf16, and on small cases in f32 against ``attention_ref``.  bf16 runs
    the tensor-core kernels (``flash_attention`` above 16 rows per KV
    head, else ``flash_attention_decode``), f32 the FP32-pipe
    ``flash_attention_f32``; every call's launches are checked by name.
    Tolerances: bf16 outputs within one bf16 step, 2^-7 relative
    (``close``: plus 1e-4 of the largest for the entries near zero), since
    both sides compute the same f32 scores, the kernels' P.V carries P to
    about 16 bits (split in two bf16 parts), and both round once; f32
    within 3e-4 as tests/test_kernels.py holds the Pallas kernel (f32
    sums in another order).  A split launch's output is also held against
    ``merge_ref`` of the partials it returned: within one bf16 step for
    bf16 outputs (the fold's f32 sums in another order, then one
    rounding), 1e-5 for f32 ones (no rounding); and two launches must give
    the same bits, though their blocks arrive in another order."""
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
        check_fa_launches(n, planned(got.transpose(1, 2), k.transpose(1, 2),
                                     T)[0], f"f32 small case {case}")
        # the same in bf16 against the model contract's plain version
        qb, kb, vb = (x.transpose(1, 2).to(bf16) for x in (q, k, v))
        kw = dict(causal=causal, scale=D ** -0.5,
                  q_offset=T - S if causal else 0)
        gb, n = fa_launches(lambda: FA.flash_attention(qb, kb, vb, **kw))
        wb = chunked_attention_ref(qb, kb, vb, **kw)
        check(close(gb, wb, BF16_STEP), f"flash_attention small bf16 case "
              f"{case} off the plain version")
        check_fa_launches(n, planned(qb, kb, T)[0], f"bf16 small case {case}")
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
            check_fa_launches(n, planned(q, k, 700)[0], f"ragged kv_len "
                              f"({dtype}, S {S})")
            check(kernels[0] in n, f"ragged kv_len ({dtype}, S {S}): "
                  f"launches {n}, want {kernels[0]}")
            fold_tol = 1e-5 if dtype == torch.float32 else BF16_STEP
            for kernel in kernels:
                for splits in (2, 5, 11):
                    (got, part), n = fa_launches(
                        lambda: FA.flash_attention_split(
                            q, k, v, splits=splits, kernel=kernel,
                            rpt=4 if dtype == torch.float32 else None, **kw))
                    what = (f"{kernel} with {splits} forced splits ({dtype}, "
                            f"S {S}, causal={causal})")
                    check_fa_launches(n, kernel, what)
                    check(close(got, want, tol), f"{what} off the plain "
                          f"version")
                    check(close(got, merge_ref(*part, n_heads=6,
                                               dtype=torch.float32),
                                fold_tol),
                          f"{what} off merge_ref of its own partials")
    print(f"[phase1] flash_attention: {2 * len(FA_SMALL)} small cases (f32 "
          f"vs attention_ref, bf16 vs chunked_attention_ref) and ragged "
          f"kv_len / offset / forced-split cases held (f32 on "
          f"flash_attention_f32, bf16 on flash_attention and "
          f"flash_attention_decode; splits 2, 5 and 11 folded in one "
          f"launch, also against merge_ref of their partials), one launch "
          f"each as planned")

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
        check_fa_launches(n, kernel, f"flash_attention at {name}")
        want = chunked_attention_ref(q, k, v, block_q=1024 if causal else 1,
                                     **kw)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        check(got.dtype == bf16 and close(got, want, BF16_STEP),
              f"flash_attention at {name} off the plain version ({err})")
        reps = 3 if causal else 20
        ms = time_ms(lambda: FA.flash_attention(q, k, v, **kw), reps)
        dev_ms = time_ms(lambda: FA.flash_attention(q, k, v, **kw), reps,
                         lead=True)
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
            # the same split launch again, with its partials: the same
            # bits, and the output merge_ref makes of those partials
            (got2, part), n = fa_launches(lambda: FA.flash_attention_split(
                q, k, v, splits=splits, kernel=kernel, **kw))
            check_fa_launches(n, kernel, f"flash_attention_split at {name}")
            check(same_bits(got2, got), f"flash_attention at {name}: two "
                  f"launches differ")
            m_want = merge_ref(*part, n_heads=Hq, dtype=torch.float32)
            m_err = float((got2.float() - m_want).abs().max())
            check(close(got2, m_want, BF16_STEP), f"flash_attention at "
                  f"{name} off merge_ref of its own partials ({m_err})")
            f_bytes = 2 * 4.0 * sum(p.numel() for p in part)
            extra = (f" (fold: max_abs_err vs merge_ref of its partials "
                     f"{m_err:.3g}, two launches bitwise equal, fold "
                     f"bound_ms={f_bytes / peaks[1] * 1e3:.5f}: "
                     f"{f_bytes / 1e6:.4f} MB of partials written and read "
                     f"once)")
            del got2, part
        rows[name] = (err, ms, plain_ms, bound_ms, by, lib_ms, dev_ms)
        print(f"[phase1] {kernel} {name}: q {tuple(q.shape)} k/v "
              f"{tuple(k.shape)} bf16 causal={causal} splits={splits} "
              f"max_abs_err={err:.3g} kernel_ms={ms:.4f} device_ms="
              f"{dev_ms:.4f} ({rate}){extra} "
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
        err, ms, plain_ms, bound_ms, by, lib_ms, dev_ms = rows[shape]
        out.append(dict(name=kname, route="cuda", source=src_file,
                        replaces=jax_file, max_abs_err=err, ms=ms,
                        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                        library_ms=lib_ms, device_ms=dev_ms))
    return out


def sha16(t: torch.Tensor) -> str:
    """The first 16 hex digits of the sha256 of a tensor's bytes."""
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()[:16]


def attention_whole_op(g: torch.Generator, dev) -> None:
    """The whole op at decode_32k and long_500k: ``kernel_ms`` with the
    wrapper's host time, ``device_ms`` with the card kept busy first,
    ``host_ms``, and a hash of the output.  Inputs come from ``g``, so
    two processes given the same seed see the same ones."""
    bf16 = torch.bfloat16
    for name, B, S, Hq, Hkv, T, D, causal in FA_SHAPES:
        if name not in ("decode_32k", "long_500k"):
            continue
        q = torch.randn((B, S, Hq, D), generator=g, device=dev).to(bf16)
        k = torch.empty((B, T, Hkv, D), dtype=bf16, device=dev).normal_(
            generator=g)
        v = torch.empty((B, T, Hkv, D), dtype=bf16, device=dev).normal_(
            generator=g)
        kw = dict(causal=causal, scale=D ** -0.5, kv_len=T)
        fn = lambda: FA.flash_attention(q, k, v, **kw)  # noqa: E731
        out = fn()
        ms, dev_ms, h_ms = (time_ms(fn, 200), time_ms(fn, 200, lead=True),
                            host_ms(fn, 200))
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        kernel, splits = FA.plan(B, S, Hq, Hkv, T, n_sm, D=D)
        print(f"[ab] {name}: {kernel} splits={splits} kernel_ms={ms:.4f} "
              f"device_ms={dev_ms:.4f} host_ms={h_ms:.4f} "
              f"sha256={sha16(out)}")
        del q, k, v, out
        torch.cuda.empty_cache()


def forced_split_hashes(g: torch.Generator, dev) -> None:
    """Hashes of Phase 1's forced-split outputs (splits 2, 5 and 11 on
    each kernel, inputs from ``g``)."""
    bf16 = torch.bfloat16
    kvl = torch.tensor([1, 333, 700], dtype=torch.int32, device=dev)
    hashes = []
    for dtype, S, kernels in ((torch.float32, 5, ("flash_attention_f32",)),
                              (bf16, 5, ("flash_attention_decode",
                                         "flash_attention")),
                              (bf16, 50, ("flash_attention",))):
        q = torch.randn((3, S, 6, 64), generator=g, device=dev).to(dtype)
        k = torch.randn((3, 700, 2, 64), generator=g, device=dev).to(dtype)
        v = torch.randn((3, 700, 2, 64), generator=g, device=dev).to(dtype)
        for causal in (False, True):
            kw = dict(causal=causal, q_offset=600, kv_len=kvl, scale=0.125)
            for kernel in kernels:
                for splits in (2, 5, 11):
                    out = FA.flash_attention_split(
                        q, k, v, splits=splits, kernel=kernel,
                        rpt=4 if dtype == torch.float32 else None, **kw)[0]
                    hashes.append(sha16(out))
                    print(f"[ab] forced {dtype} S {S} causal={causal} "
                          f"{kernel} splits={splits} sha256={hashes[-1]}")
    whole = hashlib.sha256("".join(hashes).encode()).hexdigest()[:16]
    print(f"[ab] forced splits: {len(hashes)} outputs, sha256 of their "
          f"hashes {whole}")


FA_BWD_SHAPES = (
    # (name, B, S, Hq, Hkv, D, dtype): lm_loss's causal self-attention
    ("reduced", 4, 64, 4, 4, 32, torch.float32),   # run_lm's reduced cut
    ("olmo-1b", 1, 4096, 16, 16, 128, torch.bfloat16),
    ("llama3.2-3b", 1, 4096, 24, 8, 128, torch.bfloat16),
    ("gemma-2b", 1, 4096, 8, 1, 256, torch.bfloat16),
    ("f32 olmo heads", 1, 256, 16, 16, 128, torch.float32),  # Phase 9's check
    # ragged tiles (S a multiple of no tile) at the other head dims
    ("ragged bf16 D 64", 2, 77, 6, 2, 64, torch.bfloat16),
    ("ragged bf16 D 32", 3, 100, 4, 1, 32, torch.bfloat16),
    ("ragged bf16 D 256", 1, 70, 8, 1, 256, torch.bfloat16),
    ("ragged f32 D 256", 1, 70, 8, 1, 256, torch.float32),
)
BWD_BF16_TOL, BWD_F32_TOL = 2.0 ** -6, 1e-5   # of M: tests/..._bwd.py
# block_gap's limits: above the sound kernels' reading (bf16 about 2^-8:
# P, dS and the result each rounded once; f32 about sqrt(n) 2^-24), below
# what a lost or repeated tile reads (planted_faults: 2^-5 or more at
# every FA_BWD_SHAPES shape on the position-weighted dO)
BWD_GAP_TOL = {torch.bfloat16: 2.0 ** -6, torch.float32: 2.0 ** -13}


def within_terms(got, want, mag, tol: float) -> float:
    """The largest |got - want| / M, M the sums of the magnitudes of each
    result's terms (``attention_bwd_ref(absolute=True)``); 0 where M is
    0 and the two agree."""
    err = (got.float() - want.float()).abs()
    return float(torch.where(err == 0, 0.0, err / mag).max())


BWD_FORCED_SPLITS = 4        # the forced-splits check's ranges a key tile


def planted_faults(q, k, v, o, do, lse_h, scale, grads, plan) -> dict:
    """The backward's (dq, dk, dv) with terms taken out, as a lost tile or
    a lost split would leave them.  "tile": key tile 0 of the dq pass (64
    keys) out of the last 64 rows of query head 0's dQ (a row's loop over
    ~S / 64 key tiles one short, or a stage of its ring slipped), and the
    last 64-row tile of KV group 0's flattened (position, head) rows out
    of key tile 0's dK and dV (the far end of the dkdv pass's row loop).
    "split": the rows of key tile 0's last split out of its dK and dV (a
    partial the fold lost), the split from ``plan`` where it splits key
    tile 0, else from ``BWD_FORCED_SPLITS``.  The terms are the closed
    form's P and dS over those rows and keys, in f32; lse_h is (B, Hq,
    S)."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    rep = Hq // Hkv
    rows = S * rep

    def terms(pos, heads, keys):
        kr, vr = (x[0, keys].float()[:, heads // rep].transpose(0, 1)
                  for x in (k, v))                       # (n, keys, D)
        qr, dor, orow = (x[0, pos, heads].float() for x in (q, do, o))
        s = torch.einsum("nd,nkd->nk", qr, kr) * scale
        p = torch.where(keys[None] <= pos[:, None],
                        torch.exp(s - lse_h[0, heads, pos][:, None]), 0.0)
        dp = torch.einsum("nd,nkd->nk", dor, vr)
        ds = p * (dp - (dor * orow).sum(dim=-1, keepdim=True))
        return p, ds, kr, qr, dor

    def lose_rows(dk, dv, r, keys):
        p, ds, _, qr, dor = terms(r // rep, r % rep, keys)
        dk[0, keys, 0] -= scale * torch.einsum("nk,nd->kd", ds, qr)
        dv[0, keys, 0] -= torch.einsum("nk,nd->kd", p, dor)

    dev = q.device
    dq, dk, dv = (x.float().clone() for x in grads)
    pos = torch.arange(max(S - 64, 0), S, device=dev)
    _, ds, kr, _, _ = terms(pos, torch.zeros_like(pos),
                            torch.arange(min(64, S), device=dev))
    dq[0, pos, 0] -= scale * torch.einsum("nk,nkd->nd", ds, kr)
    keys = torch.arange(min(plan.key_tile, S), device=dev)
    last = (-(-rows // plan.row_tile) - 1) * plan.row_tile
    lose_rows(dk, dv, torch.arange(last, rows, device=dev), keys)
    out = {"tile": (dq, dk, dv)}
    if len(plan.ranges[0]) < 2:
        plan = FA.bwd_plan(B, S, Hq, Hkv, D, 132, splits=BWD_FORCED_SPLITS)
    lo, hi = plan.ranges[0][-1]
    dk, dv = (x.float().clone() for x in grads[1:])
    lose_rows(dk, dv, torch.arange(lo * plan.row_tile,
                                   min(hi * plan.row_tile, rows), device=dev),
              keys)
    out["split"] = (grads[0].float(), dk, dv)
    return out


def attention_bwd_work(B, S, Hq, Hkv, D, esize, per_pair) -> tuple:
    """(operations, bytes) of the causal backward: ``per_pair`` D per kept
    (query, key) pair; q, k, v, o, dO and lse read once, dq, dk, dv
    written once."""
    ops = per_pair * D * S * (S + 1) / 2 * B * Hq
    nbytes = esize * (4.0 * B * S * Hq * D + 4.0 * B * S * Hkv * D) \
        + 4.0 * B * S * Hq
    return ops, nbytes


def sdpa_train_library(q, k, v, do, scale):
    """SDPA (``enable_gqa``, causal) forward and backward under autograd
    on the same inputs: (forward + backward ms, backward ms), or (None,
    None) where no fused backend takes it (f32: the math backend)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2)
    backends = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                SDPBackend.CUDNN_ATTENTION]
    if q.dtype == torch.float32:
        backends.append(SDPBackend.MATH)

    def fwd():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, scale=scale, enable_gqa=True)
    try:
        with sdpa_kernel(backends):
            both = time_ms(lambda: torch.autograd.grad(
                fwd(), (qt, kt, vt), dot), 5)
            out = fwd()
            bwd = time_ms(lambda: torch.autograd.grad(
                out, (qt, kt, vt), dot, retain_graph=True), 5)
    except RuntimeError as e:
        print(f"[phase1] SDPA refuses this backward: "
              f"{str(e).splitlines()[0]}")
        return None, None
    return both, bwd


def fa_bwd_guard(dev) -> None:
    """F1 on the card: under grad every case the backward does not take
    raises, naming it; what lm_loss calls returns an output whose
    ``grad_fn`` is ``FlashAttention``'s."""
    bf16 = torch.bfloat16

    def t(S, H, D=64, grad=True):
        return torch.randn((1, S, H, D), device=dev, dtype=bf16,
                           requires_grad=grad)
    q, k = t(32, 4), t(32, 2)
    cases = (("causal=False", lambda: FA.flash_attention(
                q, k, k, causal=False, scale=0.125)),
             ("q_offset 4", lambda: FA.flash_attention(
                 q, k, k, causal=True, scale=0.125, q_offset=4)),
             ("a kv_len", lambda: FA.flash_attention(
                 q, k, k, causal=True, scale=0.125, kv_len=20)),
             ("32 queries over 48 keys", lambda: FA.flash_attention(
                 q, t(48, 2), t(48, 2), causal=True, scale=0.125)),
             ("head dim 48", lambda: FA.flash_attention(
                 t(32, 4, 48), t(32, 2, 48), t(32, 2, 48), causal=True,
                 scale=0.125)),
             ("no backward", lambda: FA.flash_attention_split(
                 q, k, k, causal=True, scale=0.125, splits=2)))
    for what, fn in cases:
        try:
            fn()
        except (NotImplementedError, RuntimeError) as e:
            check(what in str(e), f"F1 guard ({what}) raised {e!r}")
        else:
            raise AssertionError(f"F1 guard: {what} did not raise")
    out = FA.flash_attention(q, k, k, causal=True, scale=0.125)
    check(type(out.grad_fn).__name__ == "FlashAttentionBackward",
          f"lm_loss's case: grad_fn {out.grad_fn}")
    print(f"[phase1] F1 guard on the card: {len(cases)} refused cases "
          f"raised naming the case; lm_loss's case returns an output "
          f"with grad_fn {type(out.grad_fn).__name__}")


def fa_bwd_forced(q, k, v, o, do, lse, scale, grads, plain, mag, tol,
                  gtol) -> str:
    """The dkdv pass at ``BWD_FORCED_SPLITS`` ranges a key tile (the fold
    in every group): dK and dV against the closed form per entry (within
    ``tol`` of M) and by block gap (within ``gtol``), dQ bitwise the
    planned run's, and a second launch bitwise equal.  Returns the
    printed note."""
    f1 = FA.flash_attention_bwd(q, k, v, o, do, lse, scale=scale,
                                splits=BWD_FORCED_SPLITS)
    f2 = FA.flash_attention_bwd(q, k, v, o, do, lse, scale=scale,
                                splits=BWD_FORCED_SPLITS)
    check(all(same_bits(a, b) for a, b in zip(f1, f2)), f"backward at "
          f"{BWD_FORCED_SPLITS} forced splits: two launches differ")
    check(same_bits(f1[0], grads[0]), "forced splits moved dQ")
    errs = [within_terms(f, w, m, tol) for f, w, m in zip(f1[1:], plain[1:],
                                                          mag[1:])]
    gaps = [block_gap(f, w) for f, w in zip(f1[1:], plain[1:])]
    check(max(errs) <= tol and max(gaps) <= gtol, f"backward at "
          f"{BWD_FORCED_SPLITS} forced splits: dK, dV off the closed form by "
          f"{errs} of M, block gaps {gaps}")
    moved = max(float((a.float() - b.float()).abs().max())
                for a, b in zip(f1[1:], grads[1:]))
    return (f"; at {BWD_FORCED_SPLITS} forced splits dK, dV {errs[0]:.3g}, "
            f"{errs[1]:.3g} of M, block gaps {gaps[0]:.3g}, {gaps[1]:.3g}, "
            f"two launches bitwise equal, at most {moved:.3g} from the "
            f"planned run's")


def phase1_flash_attention_bwd(g: torch.Generator, dev, peaks) -> list:
    """The backward (``flash_attention_bwd``: the dq pass, then the dkdv
    pass, twice at head dim 256) at lm_loss's shapes (``FA_BWD_SHAPES``),
    on the forward's output and lse from the training route
    (``flash_attention_lse``, which must repeat bitwise: remat runs it
    again): dQ, dK and dV against autograd of
    ``chunked_attention_ref`` on the card and against the closed form
    ``attention_bwd_ref``, each within ``BWD_BF16_TOL`` (bf16) or
    ``BWD_F32_TOL`` (f32) of M, the sums of the magnitudes of each
    result's terms (tests/test_torch_flash_attention_bwd.py argues both),
    and each within ``BWD_GAP_TOL`` by ``block_gap``, the norm-wise gap
    of each block of 64 positions of a head, on this dO and on dO
    weighted by position (every row's share of a key's sums about 1/S);
    a tile's terms, or a split's partial, taken out of the weighted
    result (``planted_faults``) must read above that limit; a second
    launch must give the same bits; at olmo-1b's shape the dkdv pass at
    ``BWD_FORCED_SPLITS`` ranges a key tile too (``fa_bwd_forced``);
    the forward's lse within
    1e-5 of the plain one; the grad-off forward (``plan``'s launch, the
    same kernel at one split) bitwise equal to the training route's
    output.  Prints device ms against a FLOP bound of 10 D per kept
    (query, key) pair (the five products) and the design's 14 D (both
    passes recompute S and dP), and SDPA's forward and backward under
    autograd.  Then the F1 guard on the card (``fa_bwd_guard``)."""
    out = {}
    for name, B, S, Hq, Hkv, D, dtype in FA_BWD_SHAPES:
        f32 = dtype == torch.float32
        scale = D ** -0.5
        q = torch.randn((B, S, Hq, D), generator=g, device=dev).to(dtype)
        k = torch.randn((B, S, Hkv, D), generator=g, device=dev).to(dtype)
        v = torch.randn((B, S, Hkv, D), generator=g, device=dev).to(dtype)
        do = torch.randn((B, S, Hq, D), generator=g, device=dev).to(dtype)
        (o, lse), n = fa_launches(lambda: FA.flash_attention_lse(
            q, k, v, scale=scale))
        kernel = FA.train_plan(dtype)[0]
        check_fa_launches(n, kernel, f"training forward at {name}")
        o2, lse2 = FA.flash_attention_lse(q, k, v, scale=scale)
        check(same_bits(o2, o) and same_bits(lse2, lse), f"training forward "
              f"at {name}: two launches differ (remat recomputes it)")
        del o2, lse2
        with torch.no_grad():
            n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
            planned = FA.plan(B, S, Hq, Hkv, S, n_sm, D=D, dtype=dtype)
            o_off = FA.flash_attention(q, k, v, causal=True, scale=scale)
        if planned == FA.train_plan(dtype):
            check(same_bits(o_off, o), f"{name}: the grad-off forward and the "
                  f"training route's output differ")
        o_ref, lse_ref = chunked_attention_ref(q, k, v, causal=True,
                                               scale=scale, return_lse=True)
        lse_h = FA.lse_by_head(lse, Hq)
        lse_err = float((lse_h - lse_ref).abs().max())
        check(close(lse_h, lse_ref, 1e-5), f"{name}: lse off the plain "
              f"lse ({lse_err})")
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = FA.bwd_plan(B, S, Hq, Hkv, D, n_sm)
        (grads, n) = fa_launches(lambda: FA.flash_attention_bwd(
            q, k, v, o, do, lse, scale=scale))
        pre = "flash_attention_bwd_f32_" if f32 else "flash_attention_bwd_"
        want_n = {pre + "dq": 1, pre + "dkdv": 1 if f32 or D <= 128 else 2}
        check(n == want_n, f"backward at {name}: launches {n}, want {want_n}")
        again = FA.flash_attention_bwd(q, k, v, o, do, lse, scale=scale)
        check(all(same_bits(a, b) for a, b in zip(grads, again)),
              f"backward at {name}: two launches differ")
        del again
        tol = BWD_F32_TOL if f32 else BWD_BF16_TOL
        args = (q, k, v, o, do, lse_h)
        plain = attention_bwd_ref(*args, scale=scale)
        mag = attention_bwd_ref(*args, scale=scale, absolute=True)
        qr, kr, vr = (x.detach().clone().requires_grad_() for x in (q, k, v))
        chunked_attention_ref(qr, kr, vr, causal=True,
                              scale=scale).backward(do)
        errs = {}
        for gname, got, w_plain, w_auto, m in zip(
                ("dq", "dk", "dv"), grads, plain, (qr.grad, kr.grad, vr.grad),
                mag):
            check(got.dtype == dtype and bool(torch.isfinite(got).all()),
                  f"{name}: {gname} not finite {dtype}")
            e1 = within_terms(got, w_plain, m, tol)
            e2 = within_terms(got, w_auto, m, tol)
            check(e1 <= tol and e2 <= tol, f"{name}: {gname} off the plain "
                  f"versions by {e1:.3g} / {e2:.3g} of M (tolerance "
                  f"{tol:.3g})")
            errs[gname] = (e1, e2, float((got.float() - w_auto.float()
                                          ).abs().max()))
        gaps = {gname: (block_gap(got, w_plain), block_gap(got, w_auto))
                for gname, got, w_plain, w_auto in zip(
                    ("dq", "dk", "dv"), grads, plain,
                    (qr.grad, kr.grad, vr.grad))}
        forced = ""
        if name == "olmo-1b":
            forced = fa_bwd_forced(q, k, v, o, do, lse, scale, grads, plain,
                                   mag, tol, BWD_GAP_TOL[dtype])
        del plain, mag, qr, kr, vr
        # dO weighted by position: a row's share of a key's sums is then
        # about 1/S at every position, so a lost row tile shows in dK, dV
        w = torch.arange(1, S + 1, device=dev, dtype=torch.float32) / S
        dow = (do.float() * w[None, :, None, None]).to(dtype)
        grads_w = FA.flash_attention_bwd(q, k, v, o, dow, lse, scale=scale)
        want_w = attention_bwd_ref(q, k, v, o, dow, lse_h, scale=scale)
        faults = planted_faults(q, k, v, o, dow, lse_h, scale, grads_w,
                                plan)
        gtol = BWD_GAP_TOL[dtype]
        for gname, got, want, bad, lost in zip(
                ("dq", "dk", "dv"), grads_w, want_w, faults["tile"],
                faults["split"]):
            gaps[gname] += (block_gap(got, want), block_gap(bad, want),
                            block_gap(lost, want))
            sound = max(gaps[gname][:3])
            check(sound <= gtol, f"{name}: {gname} off the plain versions by "
                  f"a block gap of {sound:.3g} (limit {gtol:.3g})")
            check(gaps[gname][3] > gtol, f"{name}: a lost tile in {gname} "
                  f"reads {gaps[gname][3]:.3g}, within the limit {gtol:.3g}")
            check(gname == "dq" or gaps[gname][4] > gtol, f"{name}: a lost "
                  f"split partial in {gname} reads {gaps[gname][4]:.3g}, "
                  f"within the limit {gtol:.3g}")
        del dow, grads_w, want_w, faults
        bwd = lambda: FA.flash_attention_bwd(q, k, v, o, do, lse,  # noqa
                                             scale=scale)
        reps = 20 if S >= 1024 else 50
        ms, dev_ms = time_ms(bwd, reps), time_ms(bwd, reps, lead=True)
        dq = lambda: FA.bwd_dq(q, k, v, o, do, lse, scale=scale)  # noqa
        di = dq()[1]
        dkdv = lambda: FA.bwd_dkdv(q, k, v, do, lse, di,  # noqa: E731
                                   scale=scale)
        dq_ms, dkdv_ms = time_ms(dq, reps), time_ms(dkdv, reps)
        dq_dev, dkdv_dev = (time_ms(dq, reps, lead=True),
                            time_ms(dkdv, reps, lead=True))
        plain_ms = time_ms(lambda: attention_bwd_ref(*args, scale=scale), 2)
        both_ms, sdpa_bwd_ms = sdpa_train_library(q, k, v, do, scale)
        peak = peaks[0] if f32 else peaks[2]
        esize = q.element_size()
        bounds = {}
        for what, per_pair in (("10 D", 10), ("dq 6 D", 6), ("dkdv 8 D", 8)):
            ops, nbytes = attention_bwd_work(B, S, Hq, Hkv, D, esize,
                                             per_pair)
            t_o, t_b = ops / peak, nbytes / peaks[1]
            bounds[what] = (max(t_o, t_b) * 1e3,
                            "operations" if t_o >= t_b else "bytes", ops)
        design_ops = attention_bwd_work(B, S, Hq, Hkv, D, esize, 14)[0]
        b_ms, b_by, b_ops = bounds["10 D"]
        print(f"[phase1] flash_attention_bwd {name}: q {tuple(q.shape)} k/v "
              f"{tuple(k.shape)} {str(dtype).replace('torch.', '')} causal; "
              f"launches {n}; vs the closed form / autograd of "
              f"chunked_attention_ref, of M: " + ", ".join(
                  f"{k_} {a:.3g} / {b:.3g} (max_abs_err {c:.3g})"
                  for k_, (a, b, c) in errs.items())
              + f" (tolerance {tol:.3g}); block gap (64 positions of a "
              f"head) vs the closed form / autograd / on dO by position, "
              f"and on dO by position a planted lost tile and a lost split "
              f"partial (dK, dV): " + ", ".join(
                  f"{k_} {a:.3g} / {b:.3g} / {c:.3g}, faults {f:.3g}"
                  + ("" if k_ == "dq" else f", {f2:.3g}")
                  for k_, (a, b, c, f, f2) in gaps.items())
              + f" (limit {gtol:.3g}); "
              + ("the f32 dkdv pass: 16-key blocks, no splits" if f32 else
                 f"dkdv plan {plan.key_tile} keys a block, {plan.blocks} "
                 f"blocks a (b, KV head), at most {plan.splits} splits")
              + f"{forced}; two launches bitwise equal (the "
              f"forward's too); lse max_abs_err {lse_err:.3g}; "
              f"kernel_ms={ms:.4f} device_ms={dev_ms:.4f} (dq pass "
              f"{dq_ms:.4f}, device {dq_dev:.4f}, bound "
              f"{bounds['dq 6 D'][0]:.4f}; dkdv pass {dkdv_ms:.4f}, device "
              f"{dkdv_dev:.4f}, bound {bounds['dkdv 8 D'][0]:.4f}); "
              f"bound_ms={b_ms:.4f} ({b_by}; 10 D a kept pair, "
              f"{b_ops / 1e12:.4f} TFLOP; {b_ops / dev_ms / 1e9:.1f} "
              f"TFLOP/s, {b_ops / dev_ms / 1e9 / (peak / 1e12):.1%} of the "
              f"peak); the design's 14 D {design_ops / 1e12:.4f} TFLOP "
              f"({design_ops / peak * 1e3:.4f} ms at the peak); "
              f"plain_ms={plain_ms:.4f}; SDPA forward+backward "
              f"{both_ms} ms, backward {sdpa_bwd_ms} ms")
        out[name] = dict(err=max(c for _, _, c in errs.values()), ms=ms,
                         dev_ms=dev_ms, dq_ms=dq_ms, dkdv_ms=dkdv_ms,
                         dq_dev=dq_dev, dkdv_dev=dkdv_dev,
                         plain_ms=plain_ms, bounds=bounds, sdpa=both_ms,
                         sdpa_bwd=sdpa_bwd_ms, gaps=gaps)
        del q, k, v, do, o, lse, o_off, o_ref, lse_ref, grads
        torch.cuda.empty_cache()
    fa_bwd_guard(dev)
    r = out["olmo-1b"]
    src = "src/repro_torch/csrc/flash_attention_bwd.cu"
    ref = "src/repro/models/lm/model.py:152"
    # the whole backward (both passes: one dq launch each) beside the
    # passes, with the function's 10 D bound and SDPA's backward
    return [dict(name="flash_attention_bwd", route="cuda", source=src,
                 replaces=ref, max_abs_err=r["err"], ms=r["ms"],
                 plain_ms=r["plain_ms"], bound_ms=r["bounds"]["10 D"][0],
                 bound_by=r["bounds"]["10 D"][1], library_ms=r["sdpa_bwd"],
                 device_ms=r["dev_ms"], counter="flash_attention_bwd_dq"),
            dict(name="flash_attention_bwd_dq", route="cuda", source=src,
                 replaces=ref, max_abs_err=r["err"], ms=r["dq_ms"],
                 plain_ms=r["plain_ms"], bound_ms=r["bounds"]["dq 6 D"][0],
                 bound_by=r["bounds"]["dq 6 D"][1], library_ms=None,
                 device_ms=r["dq_dev"]),
            dict(name="flash_attention_bwd_dkdv", route="cuda", source=src,
                 replaces=ref, max_abs_err=r["err"], ms=r["dkdv_ms"],
                 plain_ms=r["plain_ms"],
                 bound_ms=r["bounds"]["dkdv 8 D"][0],
                 bound_by=r["bounds"]["dkdv 8 D"][1], library_ms=None,
                 device_ms=r["dkdv_dev"])]


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


def event_batches(rng: np.random.Generator):
    """Phase 2's engagement stream: N_EVENTS events in batches of
    INGEST_BATCH, uniform users and items, timestamps over SPAN_S seconds
    from T0 in time order.  Yields (users, items, timestamps)."""
    n_batches = N_EVENTS // INGEST_BATCH
    dt = SPAN_S / n_batches
    for b in range(n_batches):
        ts = T0 + dt * (b + np.sort(rng.random(INGEST_BATCH)))
        yield (rng.integers(0, N_USERS, INGEST_BATCH),
               rng.integers(0, N_ITEMS, INGEST_BATCH), ts)


def serve_split(store, users, now: float, i2i) -> tuple:
    """``serve_batch``'s pieces for one batch, each synced: host
    ``clusters_of``, the cluster ids masked and cast to int32 on the host,
    their copy to the card, the ``queue_gather`` op (CUDA-event time, the
    wrapper's host time included, and host time), the ``.cpu()`` of seeds
    and union, and their int64 cast.  Returns (seconds by piece, kernel
    ms, seeds, union)."""
    sec = {}
    t = time.perf_counter()
    cl, known = store.clusters_of(users)
    sec["clusters_of"] = time.perf_counter() - t
    t = time.perf_counter()
    cl32 = np.where(known, cl, -1).astype(np.int32)
    sec["mask_int32"] = time.perf_counter() - t
    t = time.perf_counter()
    cl_t = torch.as_tensor(cl32).to(store.device)
    torch.cuda.synchronize()
    sec["ids_to_card"] = time.perf_counter() - t
    st = store._state
    i2i_t = store._i2i_device(i2i)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t = time.perf_counter()
    a.record()
    s, u = QG_OPS.queue_gather(st["items"], st["times"], st["total"], cl_t,
                               i2i_t, cutoff=store.rel_cutoff(now),
                               n_recent=N_RECENT, k=K_UNION)
    b.record()
    b.synchronize()
    sec["queue_gather"] = time.perf_counter() - t
    kernel_ms = a.elapsed_time(b)
    t = time.perf_counter()
    s, u = s.cpu().numpy(), u.cpu().numpy()
    sec["to_host"] = time.perf_counter() - t
    t = time.perf_counter()
    s, u = s.astype(np.int64), u.astype(np.int64)
    sec["int64_cast"] = time.perf_counter() - t
    return sec, kernel_ms, s, u


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
    for batch in event_batches(rng):
        store.ingest(*batch)
    torch.cuda.synchronize()
    secs["ingest"] = time.perf_counter() - t

    now = T0 + SPAN_S
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
    # build_snapshot's card share: its two corpus encodes (rq_assign), once
    # more after the count, in CUDA-event time
    encode_ms = time_ms(lambda: [encode_corpus(rq, e, cfg.rq.codebook_sizes)
                                 for e in (user_emb, item_emb)], 3)
    # serve_bulk's pieces: the bulk batch once more, each piece synced
    split, split_kernel_ms, s_split, u_split = serve_split(
        store, users, now, snap.i2i)
    check(np.array_equal(s_split, s) and np.array_equal(u_split, u),
          "serve split: the re-served bulk batch differs")

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
    print(f"[phase2] serve split (batch {BULK_BATCH}, host seconds, each "
          f"piece synced): "
          f"{json.dumps({k_: round(v, 6) for k_, v in split.items()})}; "
          f"queue_gather "
          f"{split_kernel_ms:.4f} ms in CUDA events; pieces sum "
          f"{sum(split.values()):.4f} s of serve_bulk's "
          f"{secs['serve_bulk']:.4f} s")
    print(f"[phase2] snapshot_health={json.dumps(health)}")
    print(f"[phase2] build_snapshot's encodes (rq_assign, "
          f"{launches['rq_assign']} launches) {encode_ms:.4f} ms of "
          f"{secs['build_snapshot'] * 1e3:.4f} ms")
    print(f"[phase2] embed card-bf16 vs cpu-f32 max_abs_err={emb_err:.4g}; "
          f"peak device memory {peak_gb:.3f} GB; launches={launches}")
    return launches, dict(snap=snap, user_emb=user_emb, item_emb=item_emb,
                          rq=rq)


# ---------------------------------------------------------------------------
# Phase 3: the construct-and-train slice at full width
# ---------------------------------------------------------------------------

def topic_model(rng: np.random.Generator):
    """Phase 3's topic model, the first draws of ``default_rng(seed)``:
    each topic's items (a block of ``P3_ITEMS // N_TOPICS`` in a
    permutation, in popularity-rank order), the global popularity order,
    and each user's home topic."""
    topic_items = rng.permutation(P3_ITEMS)
    global_items = rng.permutation(P3_ITEMS)
    home = rng.integers(0, N_TOPICS, P3_USERS)
    return topic_items, global_items, home


def topic_events(rng: np.random.Generator, model, per_user: np.ndarray):
    """``per_user[u]`` events of each user: HOME_SHARE on items of the
    home topic, the rest on any item, both Zipf-1.1 by popularity; event
    types 0-3 with probabilities 0.7 / 0.15 / 0.1 / 0.05.  Returns
    (users, items, event types)."""
    topic_items, global_items, home = model
    ni = P3_ITEMS
    per_topic = ni // N_TOPICS

    def zipf_cdf(n):
        p = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** 1.1
        return np.cumsum(p / p.sum())

    users = np.repeat(np.arange(P3_USERS, dtype=np.int64), per_user)
    n_ev = len(users)
    r_loc = np.minimum(np.searchsorted(zipf_cdf(per_topic),
                                       rng.random(n_ev)), per_topic - 1)
    r_glob = np.minimum(np.searchsorted(zipf_cdf(ni), rng.random(n_ev)),
                        ni - 1)
    items = np.where(rng.random(n_ev) < HOME_SHARE,
                     topic_items[home[users] * per_topic + r_loc],
                     global_items[r_glob]).astype(np.int64)
    etype = rng.choice(4, n_ev, p=[0.7, 0.15, 0.1, 0.05]).astype(np.int32)
    return users, items, etype


def make_log_world(seed: int) -> SyntheticWorld:
    """A topic-clustered engagement log of one day, made with numpy: each
    user has a home topic (N_TOPICS topics of equal item count) and
    Poisson(EVENTS_PER_USER) events (``topic_events``); timestamps over
    one day; standard-normal features."""
    rng = np.random.default_rng(seed)
    nu, ni = P3_USERS, P3_ITEMS
    model = topic_model(rng)
    per_user = np.maximum(rng.poisson(EVENTS_PER_USER, nu), 1)
    users, items, etype = topic_events(rng, model, per_user)
    ts = rng.random(len(users)) * 86400.0
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
    negative draws, at CHECK_ROWS edges per type.  The CPU takes the
    card's RQ selections (``rq_codes``): the biased selection (Eq. 13)
    is an argmax of ``p_soft / phat``, and in some trained states bf16
    rounding of the embeddings flips it for up to a fifth of the rows,
    so that ``rq_contrastive`` compares other reconstructions
    (``--selection-sweep`` prints how often and how far).  Under
    "cpu_own" are the CPU's losses with its own selections, and under
    "rows_own" the share of endpoint rows whose selections differ."""
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
    out, codes = {}, None
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    with torch.no_grad():
        for key, d, params, c, pool, rq, pin in (
                (str(dev), dev, st.params, cfg, st.pool, st.rq_state, False),
                ("cpu", "cpu", cpu_params, cfg32, cpu_pool, cpu_rq, True),
                ("cpu_own", "cpu", cpu_params, cfg32, cpu_pool, cpu_rq,
                 False)):
            tasks, aux = forward_losses(
                params, c, batch[d], pool, rq, draws=draws,
                rq_codes=codes.cpu() if pin else None,
                features=FeatureStore(ds[d].user_feat, ds[d].item_feat))
            out[key] = {k: float(v) for k, v in tasks.items()}
            if codes is None:
                codes = aux["codes"]
            elif not pin:
                out["rows_own"] = float(
                    (aux["codes"] != codes.cpu()).any(dim=1)
                    .to(torch.float32).mean())
    return out


def selection_sweep(seed: int, dev, steps: int) -> None:
    """Phase 3's ``run_pipeline``, then ``steps`` more train steps; at
    each of the ``steps + 1`` states ``card_vs_cpu_losses`` and the worst
    gap over the tasks (of Phase 3's tolerance) with the CPU on the
    card's RQ selections, as Phase 3 holds it, and on its own, beside
    the share of rows whose selections differ."""
    cfg = CONFIG
    world = make_log_world(seed)
    res = run_pipeline(world, cfg, steps=P3_STEPS, batch_per_type=CF_ROWS,
                       pool_size=P3_POOL, seed=seed, device=dev)
    ds = EdgeDataset(res.tables, world.user_feat, world.item_feat,
                     k_train=cfg.k_train, device=dev, g=res.graph)
    step_fn = make_train_step(cfg, rankgraph2_optimizer(),
                              features=FeatureStore(ds.user_feat,
                                                    ds.item_feat))
    per_type = {et: CF_ROWS for et in ("uu", "ui", "ii")}
    over = {"pinned": 0, "own": 0}
    for t in range(P3_STEPS, P3_STEPS + steps + 1):
        losses = card_vs_cpu_losses(res, world, seed, dev)
        card = losses[str(dev)]
        gap = {k: within(card, losses[c], CARD_CPU_REL, CARD_CPU_ABS)
               for k, c in (("pinned", "cpu"), ("own", "cpu_own"))}
        for k in over:
            over[k] += gap[k] > 1
        print(f"[sweep] after {t} steps: worst gap {gap['pinned']:.3f} of "
              f"the tolerance on the card's selections, {gap['own']:.3f} "
              f"on the CPU's own, which differ in "
              f"{losses['rows_own']:.4f} of the rows; rq_contrastive card "
              f"{card['rq_contrastive']:.5f}, cpu "
              f"{losses['cpu']['rq_contrastive']:.5f}, cpu own "
              f"{losses['cpu_own']['rq_contrastive']:.5f}", flush=True)
        if t < P3_STEPS + steps:
            step_fn(res.state, ds.sample_batch(t, seed, per_type),
                    generator=torch.Generator(dev).manual_seed(1000 + t))
    print(f"[sweep] states over the tolerance, of {steps + 1}: "
          f"{over['pinned']} on the card's selections, {over['own']} on "
          f"the CPU's own")


def synced(fn):
    """``fn()`` and its host seconds, the card synced before and after."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    return r, time.perf_counter() - t


def walk_split(dadj, starts: np.ndarray, cfg, seed: int, dev):
    """``_walk_device`` over ``starts`` re-run piece by piece: the host
    ``walk_uniforms`` of every chunk, the chunks' host-to-device copies
    and the ``ppr_walk`` launches (device time: CUDA events around each,
    the card kept busy ahead so that the op's host time, reported beside
    it, does not count).  Returns visited, counts (int32 on the card) and
    the split."""
    W, L = cfg.ppr_walks, cfg.ppr_len
    n = len(starts)
    vis = torch.empty((n, W * L), dtype=torch.int32, device=dev)
    cnt = torch.empty_like(vis)
    rows = max(1, (1 << 18) // W)           # _walk_device's chunk
    uni_s = copy_s = call_s = 0.0
    events = []
    for lo in range(0, n, rows):
        hi = min(n, lo + rows)
        u, s = synced(lambda: walk_uniforms(seed, starts[lo:hi], W, L,
                                            dadj.n_users))
        uni_s += s
        (u, st), s = synced(lambda: (
            torch.from_numpy(u).to(dev),
            torch.from_numpy(starts[lo:hi].astype(np.int32)).to(dev)))
        copy_s += s
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        torch.cuda._sleep(LEAD_CYCLES)      # hides the host's call time
        ev[0].record()
        t = time.perf_counter()
        v, c = ppr_walk_op(dadj.nbrs, dadj.cum, st, u,
                           restart=cfg.ppr_restart, last=dadj.last,
                           layout=dadj.layout)
        call_s += time.perf_counter() - t
        ev[1].record()
        events.append(ev)
        vis[lo:hi], cnt[lo:hi] = v, c
    torch.cuda.synchronize()
    return vis, cnt, {
        "walk_uniforms_host_s": round(uni_s, 4),
        "uniforms_to_card_s": round(copy_s, 4),
        "chunks": len(events),
        "launches_ms": round(sum(x.elapsed_time(y) for x, y in events), 4),
        "op_calls_host_s": round(call_s, 4)}


def ppr_split(g, cfg, seed: int, dev):
    """The ``ppr`` stage of ``run_pipeline`` (``precompute_ppr_neighbors``
    with the device backend) re-run piece by piece, a sync after each:
    the host adjacency build, its copy to the card (with ``last`` and the
    kernel's ``walk_layout``, also timed alone by CUDA events), the walk
    (``walk_split``), and the top-k (global visit mass, device top-k,
    tables to the host).  Returns the host adjacency, the split
    (seconds; the launches and the layout in ms; the tables under
    "users" and "items"), visited and counts."""
    adj, adj_s = synced(lambda: build_padded_hetero_adj(g, PPR_DEG))
    dadj, to_card_s = synced(lambda: adjacency_to_device(adj, dev))
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    PW.walk_layout(dadj.nbrs, dadj.cum, dadj.last)
    b.record()
    b.synchronize()
    layout_ms = a.elapsed_time(b)
    n = adj.n_nodes
    starts = np.arange(n, dtype=np.int64)
    vis, cnt, walk = walk_split(dadj, starts, cfg, seed, dev)

    def topk():
        glob = torch.bincount(vis.reshape(-1).to(torch.int64), minlength=n
                              ).to(torch.float64).cpu().numpy()
        u_, i_ = _topk_from_counts_device(
            vis, cnt, torch.from_numpy(starts).to(dev), cfg.k_imp,
            g.n_users, 0.5, glob)
        return u_.cpu().numpy(), i_.cpu().numpy()

    (users, items), topk_s = synced(topk)
    split = {"adjacency_host_s": round(adj_s, 4),
             "adjacency_to_card_s": round(to_card_s, 4),
             "walk_layout_ms": round(layout_ms, 4), **walk,
             "topk_s": round(topk_s, 4),
             "users": users, "items": items}
    return adj, split, vis, cnt


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

    # the ppr stage again, piece by piece (split below); its traces of
    # 4,096 starts against the numpy walker, its device tables and the
    # numpy top-k on the same visits and counts against the stage's
    adj, split, vis, cnt = ppr_split(g, cfg, seed, dev)
    check(np.array_equal(split.pop("users"), res.tables.user_nbrs)
          and np.array_equal(split.pop("items"), res.tables.item_nbrs),
          "the re-walk's device top-k differs from the ppr stage's tables")
    starts = np.arange(n_nodes, dtype=np.int64)
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
          f"(worst gap {worst:.3f} of the tolerance; the CPU on the "
          f"card's RQ selections. With its own, which differ in "
          f"{losses['rows_own']:.4f} of the endpoint rows: "
          f"{json.dumps({k: round(losses['cpu_own'][k], 5) for k in cpu if k.startswith('rq_')})}, "
          f"not held)")
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
    split_s = sum(v for k, v in split.items() if k.endswith("_s"))
    print(f"[phase3] ppr split (the stage's pieces, each synced; host "
          f"seconds, the launches' device ms): {json.dumps(split)}; sum "
          f"{split_s + split['launches_ms'] / 1e3:.4f} s against the "
          f"stage's ppr {res.seconds['ppr']:.4f} s")
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


class Stages:
    """Phase 5's stage clock: each stage's seconds on the host clock
    after a sync, its peak device memory, and for a serve stage its
    flash-attention launches (counted from 0 at its start)."""

    def __init__(self):
        self.secs, self.peaks, self.launches = {}, {}, {}

    def begin(self, name=None):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if name:
            common.reset_launches()          # a serve stage starts here
        return time.perf_counter()

    def stage(self, name, t0, serve=True):
        torch.cuda.synchronize()
        self.secs[name] = time.perf_counter() - t0
        self.peaks[name] = torch.cuda.max_memory_allocated() / 1e9
        if serve:
            self.launches[name] = {
                k: v for k, v in common.launch_counts().items()
                if k.startswith("flash_attention") and v}


def fa_step_launches(c, B: int, kv: int, n_sm: int) -> dict:
    """Flash-attention launches of one decode step by kernel: one per
    layer, split or not (the kernel folds its own splits)."""
    kernel, _ = FA.plan(B, 1, c.n_heads, c.n_kv_heads, kv, n_sm,
                        D=c.resolved_head_dim)
    return {kernel: c.n_layers}


def decode_stages(params, cfg, g: torch.Generator, dev, clk: Stages,
                  notes: dict, reps=(P5_DECODE_REPS, P5_LONG_REPS)) -> None:
    """Phase 5's decode_32k (B 8) and long_500k (B 1) stages: one decode
    step on random caches from ``g``, then ``reps`` more steps each, each
    synced and timed on the host clock, and the attention of one step in
    CUDA events.  Fills ``notes``: the step seconds, the attention ms,
    whether decode_32k's repeats are bitwise equal, and a hash of each
    stage's logits."""
    hd, L = cfg.resolved_head_dim, cfg.n_layers

    # --- decode_32k at B 8: one step at cache_len 32,767 ------------------
    T = LM_SH["decode_32k"]["seq_len"]
    t = clk.begin()
    caches = random_caches(cfg, P5_DECODE_B, T, g, dev)
    clk.stage("decode_32k_fill", t, serve=False)
    tok = lm_tokens(cfg, g, P5_DECODE_B, 1, dev)
    t = clk.begin("decode_32k")
    logits, caches = lm_decode_step(params, cfg, caches, tok)
    clk.stage("decode_32k", t)
    check(logits.shape == (P5_DECODE_B, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "decode_32k logits")
    notes["decode_32k_sha256"] = sha16(logits)
    torch.cuda.synchronize()
    secs = []
    for _ in range(reps[0]):
        t1 = time.perf_counter()
        again, caches = lm_decode_step(params, cfg, caches, tok)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t1)
    notes["decode_32k_repeat_bitwise"] = bool(torch.equal(again, logits))
    check(near(again, logits, 1e-3) <= 1, "decode_32k is not repeatable")
    notes["decode_32k_step_s"] = secs
    notes["decode_32k_attention_ms"] = attention_share_ms(
        cfg, caches, T - 1, g)
    del caches, logits, again
    torch.cuda.empty_cache()

    # --- long_500k at B 1: one step at cache_len 524,287 ------------------
    T = LM_SH["long_500k"]["seq_len"]
    need = 2 * L * T * cfg.n_kv_heads * hd * 2 / 1e9
    t = clk.begin()
    try:
        caches = random_caches(cfg, 1, T, g, dev)
        clk.stage("long_500k_fill", t, serve=False)
        tok = lm_tokens(cfg, g, 1, 1, dev)
        t = clk.begin("long_500k")
        logits, caches = lm_decode_step(params, cfg, caches, tok)
        clk.stage("long_500k", t)
    except torch.cuda.OutOfMemoryError as e:
        n_bytes = sum(x.numel() * x.element_size()
                      for x in R.flatten_params(params).values())
        raise AssertionError(
            f"long_500k does not fit: caches {need:.2f} GB beside "
            f"{n_bytes / 1e9:.2f} GB of params, "
            f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated of "
            f"{torch.cuda.get_device_properties(dev).total_memory / 1e9:.2f}"
            f" GB: {e}") from e
    check(logits.shape == (1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "long_500k logits")
    notes["long_500k_sha256"] = sha16(logits)
    secs = []
    for _ in range(reps[1]):
        t1 = time.perf_counter()
        logits, caches = lm_decode_step(params, cfg, caches, tok)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t1)
    notes["long_500k_step_s"] = secs
    notes["long_500k_attention_ms"] = attention_share_ms(cfg, caches, T - 1,
                                                         g)
    del caches, logits
    torch.cuda.empty_cache()


def print_decode(notes: dict, tag: str) -> None:
    for name in ("decode_32k", "long_500k"):
        s_ = statistics.median(notes[f"{name}_step_s"])
        a_ms = notes[f"{name}_attention_ms"]
        print(f"[{tag}] {name}: step seconds "
              f"{[round(v, 5) for v in notes[f'{name}_step_s']]}; attention "
              f"{a_ms:.4f} ms of the median {s_ * 1e3:.4f} ms, the rest "
              f"{s_ * 1e3 - a_ms:.4f} ms; logits sha256 "
              f"{notes[f'{name}_sha256']}")
    print(f"[{tag}] decode_32k repeated steps bitwise equal: "
          f"{notes['decode_32k_repeat_bitwise']}")


def decode_only(seed: int, dev, reps: int) -> None:
    """The whole attention op at decode_32k and long_500k, then Phase 5's
    decode stages alone (llama3.2-3b at full width, params from ``seed``
    as in Phase 5), each step timed ``reps`` times; checks one attention
    launch a layer."""
    attention_whole_op(torch.Generator(device=dev).manual_seed(seed), dev)
    cfg, clk, notes = LLAMA, Stages(), {}
    params = LM.init_params(cfg, generator=torch.Generator(dev).manual_seed(
        seed), device=dev)
    decode_stages(params, cfg, torch.Generator(dev).manual_seed(seed + 50),
                  dev, clk, notes, reps=(reps, reps))
    del params
    torch.cuda.empty_cache()
    print(f"[decode] seconds={json.dumps({k: round(v, 4) for k, v in clk.secs.items()})}")
    print_decode(notes, "decode")
    print(f"[decode] launches per stage={json.dumps(clk.launches)}")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, B in (("decode_32k", P5_DECODE_B), ("long_500k", 1)):
        want = fa_step_launches(cfg, B, LM_SH[name]["seq_len"], n_sm)
        check(clk.launches[name] == want, f"{name}: flash-attention launches "
              f"{clk.launches[name]}, want {want}")


def phase5(seed: int, dev) -> dict:
    """llama3.2-3b at full width: prefill_32k (B 1), 16 greedy decode
    steps from its cache, decode_32k (B 8), long_500k (B 1); gemma-2b
    prefill at 8k and 16 decode steps; then llama at 2 layers card vs CPU
    in f32 and the prefill/decode consistency on the card in bf16.
    Returns the flash-attention launches of the serve stages."""
    cfg = LLAMA
    clk, notes = Stages(), {}
    secs, peaks, launches = clk.secs, clk.peaks, clk.launches
    begin, stage = clk.begin, clk.stage
    g = torch.Generator(dev).manual_seed(seed + 50)
    hd, L = cfg.resolved_head_dim, cfg.n_layers

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

    # --- 4-5. decode_32k at B 8, long_500k at B 1 -------------------------
    decode_stages(params, cfg, g, dev, clk, notes)
    del params
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
        return fa_step_launches(c, B, kv, n_sm)

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
    print_decode(notes, "phase5")
    print(f"[phase5] card vs CPU (2 layers, f32, B {CHECK_LM_B}, S "
          f"{CHECK_LM_S}) and bf16 consistency, gap / tolerance: "
          f"{json.dumps({k: float(f'{v:.3g}') for k, v in gaps.items()})}")
    print(f"[phase5] launches per stage={json.dumps(launches)}")
    total = {}
    for per in launches.values():
        add(total, per)
    return total

# ---------------------------------------------------------------------------
# Phase 9: LM training at full olmo-1b width
# ---------------------------------------------------------------------------

def lm_grads(params, cfg, toks) -> tuple:
    """(loss, {name: gradient}) of ``lm_loss`` on ``toks``; the gradients
    are taken off the parameters."""
    flat = LM.named_params(params)
    loss = LM.lm_loss(params, cfg, toks)
    loss.backward()
    grads = {k: p.grad for k, p in flat.items()}
    for p in flat.values():
        p.grad = None
    return loss.detach(), grads


def trainable(params) -> dict:
    for p in LM.named_params(params).values():
        p.requires_grad_(True)
    return params


def norm_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b||, in f32."""
    b = b.float()
    return float((a.float() - b).norm() / b.norm().clamp_min(1e-30))


def phase9_checks(seed: int, dev) -> dict:
    """Two layers of olmo-1b, llama3.2-3b and gemma-2b at full width,
    random weights from ``seed``, B 1 x ``P9_CHECK_S`` tokens: in f32 the
    loss and every gradient on the card (the kernels: ``flash_attention_f32``
    with lse and the f32 backward passes) against the CPU (the plain
    attention under autograd) by ``close(card, cpu, CARD_CPU_LM_REL)``;
    in bf16 the loss within ``P9_BF16_LOSS`` relative and every gradient
    within ``P9_BF16_NORM`` norm-wise of the same step with the plain
    attention on the card (module docstring of Phase 9's rule).  Returns
    the largest gap / tolerance of each check."""
    gaps = {}
    for arch, S in P9_CHECK_S.items():
        base = get_arch(arch).config
        cfg = dataclasses.replace(base, n_layers=P9_CHECK_LAYERS,
                                  dtype="float32")
        g = torch.Generator(dev).manual_seed(seed + 90)
        params = trainable(LM.init_params(cfg, generator=g, device=dev))
        toks = lm_tokens(cfg, g, 1, S, dev)
        common.reset_launches()
        loss, grads = lm_grads(params, cfg, toks)
        torch.cuda.synchronize()
        n = {k: v for k, v in common.launch_counts().items() if v}
        want = {"flash_attention_f32": 2 * cfg.n_layers,
                "flash_attention_bwd_f32_dq": cfg.n_layers,
                "flash_attention_bwd_f32_dkdv": cfg.n_layers}
        check(n == want, f"{arch} f32 step: launches {n}, want {want}")
        cpu = trainable({k: ([{n_: t.detach().cpu() for n_, t in lp.items()}
                              for lp in v] if k == "layers"
                             else v.detach().cpu())
                         for k, v in params.items()})
        c_loss, c_grads = lm_grads(cpu, cfg, toks.cpu())
        worst = abs(float(loss) - float(c_loss)) / (
            CARD_CPU_LM_REL * abs(float(c_loss)) + 1e-4 * abs(float(c_loss)))
        check(close(loss.cpu(), c_loss, CARD_CPU_LM_REL),
              f"{arch} f32 loss card {float(loss)} cpu {float(c_loss)}")
        for name, gr in grads.items():
            check(bool(torch.isfinite(gr).all()) and float(gr.abs().max()) > 0,
                  f"{arch} f32 gradient of {name} not finite or zero")
            check(close(gr.cpu(), c_grads[name], CARD_CPU_LM_REL),
                  f"{arch} f32 gradient of {name} off the CPU's "
                  f"({float((gr.cpu() - c_grads[name]).abs().max()):.3g})")
            b = c_grads[name]
            rel = float(((gr.cpu() - b).abs() / (CARD_CPU_LM_REL * b.abs()
                                                 + 1e-4 * b.abs().max()
                                                 ).clamp_min(1e-30)).max())
            worst = max(worst, rel)
        gaps[f"{arch} f32 card vs cpu"] = worst
        del params, cpu, grads, c_grads
        torch.cuda.empty_cache()

        # bf16: the kernels against the plain attention, both on the card
        cfg = dataclasses.replace(base, n_layers=P9_CHECK_LAYERS)
        g = torch.Generator(dev).manual_seed(seed + 91)
        params = trainable(LM.init_params(cfg, generator=g, device=dev))
        toks = lm_tokens(cfg, g, 1, S, dev)
        loss, grads = lm_grads(params, cfg, toks)
        kernel_attention = LM.chunked_attention
        LM.chunked_attention = chunked_attention_ref
        try:
            p_loss, p_grads = lm_grads(params, cfg, toks)
        finally:
            LM.chunked_attention = kernel_attention
        lg = abs(float(loss) - float(p_loss)) / abs(float(p_loss))
        check(lg <= P9_BF16_LOSS, f"{arch} bf16 loss kernel {float(loss)} "
              f"plain {float(p_loss)}")
        worst = 0.0
        for name, gr in grads.items():
            ng = norm_gap(gr, p_grads[name])
            check(bool(torch.isfinite(gr).all()) and ng <= P9_BF16_NORM,
                  f"{arch} bf16 gradient of {name}: norm gap {ng:.3g}")
            worst = max(worst, ng)
        gaps[f"{arch} bf16 loss"] = lg / P9_BF16_LOSS
        gaps[f"{arch} bf16 gradients"] = worst / P9_BF16_NORM
        del params, grads, p_grads
        torch.cuda.empty_cache()
    return gaps


def phase9(seed: int, dev) -> dict:
    """LM training at full olmo-1b width (module docstring).  Returns the
    main run's launches."""
    cfg = OLMO
    check(cfg.remat and cfg.dtype == "bfloat16"
          and cfg.param_dtype == "float32", f"olmo-1b config {cfg}")
    t = time.perf_counter()
    g = torch.Generator(dev).manual_seed(seed + 9)
    params = trainable(LM.init_params(cfg, generator=g, device=dev))
    flat = LM.named_params(params)
    toks = lm_tokens(cfg, g, P9_B, P9_S, dev)
    opt = adamw(P9_LR)
    st = opt.init(flat)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    n_par = sum(p.numel() for p in flat.values())
    reckon = {"params": 4 * n_par / 1e9, "gradients": 4 * n_par / 1e9,
              "adamw_moments": 8 * n_par / 1e9,
              "f32_logits": 4 * P9_B * P9_S * cfg.vocab_size / 1e9}
    torch.cuda.reset_peak_memory_stats()
    common.reset_launches()
    losses, split, per_step = [], [], []
    for step in range(P9_STEPS):
        before = common.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = LM.lm_loss(params, cfg, toks)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        grads = {k: p.grad for k, p in flat.items()}
        if step == 0:
            for name, gr in grads.items():
                check(bool(torch.isfinite(gr).all())
                      and float(gr.abs().max()) > 0,
                      f"olmo step 0: gradient of {name} not finite or zero")
        upd, st = opt.update(grads, st, flat)
        apply_updates(flat, upd)
        del upd, grads
        for p in flat.values():
            p.grad = None
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        losses.append(loss.item())
        split.append((t1 - t0, t2 - t1, t3 - t2))
        after = common.launch_counts()
        per_step.append({k: n - before.get(k, 0) for k, n in after.items()
                         if n != before.get(k, 0)})
    launches = {k: v for k, v in common.launch_counts().items() if v}
    peak = torch.cuda.max_memory_allocated() / 1e9
    L = cfg.n_layers
    want = {"flash_attention": 2 * L, "flash_attention_bwd_dq": L,
            "flash_attention_bwd_dkdv": L}
    for i, n in enumerate(per_step):
        check(n == want, f"olmo step {i}: launches {n}, want {want} (the "
              f"forward with lse, the remat recompute, the backward passes)")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"olmo losses {losses} do not fall on the repeated batch")
    # attention's own time at the step's shape, in CUDA events
    hd, H = cfg.resolved_head_dim, cfg.n_heads
    q, k, v, do = (torch.randn((P9_B, P9_S, H, hd), generator=g, device=dev
                               ).to(torch.bfloat16) for _ in range(4))
    o, lse = FA.flash_attention_lse(q, k, v, scale=hd ** -0.5)
    f_ms = time_ms(lambda: FA.flash_attention_lse(q, k, v, scale=hd ** -0.5),
                   10, lead=True)
    b_ms = time_ms(lambda: FA.flash_attention_bwd(q, k, v, o, do, lse,
                                                  scale=hd ** -0.5), 10,
                   lead=True)
    del q, k, v, do, o, lse, params, flat, st
    torch.cuda.empty_cache()
    attn = 2 * L * f_ms + L * b_ms
    med = sorted(sum(x) for x in split)[len(split) // 2]
    t = time.perf_counter()
    gaps = phase9_checks(seed, dev)
    check_s = time.perf_counter() - t
    print(f"[phase9] olmo-1b at full width: {L} layers, d {cfg.d_model}, "
          f"{H} heads at D {hd}, ff {cfg.d_ff}, vocab {cfg.vocab_size}, f32 "
          f"params ({n_par} = {reckon['params']:.3f} GB), bf16 compute, "
          f"remat; one batch of B {P9_B} x S {P9_S} from the seed (train_4k's "
          f"global batch of 256 x 4,096 cut to one sequence), {P9_STEPS} "
          f"AdamW steps at lr {P9_LR}; init {init_s:.2f} s")
    print(f"[phase9] bytes reckoned: " + ", ".join(
        f"{k} {v:.3f} GB" for k, v in reckon.items())
        + f"; peak device memory {peak:.3f} GB")
    print(f"[phase9] losses {[round(x, 6) for x in losses]} (falling on the "
          f"repeated batch); step seconds (forward, backward, optimizer) "
          f"{[tuple(round(x, 4) for x in sp) for sp in split]}, median step "
          f"{med:.4f} s ({P9_B * P9_S / med:.0f} tokens/s)")
    print(f"[phase9] launches per step {per_step[0]} (forward with lse "
          f"{L}, remat recompute {L}, backward passes {L} + {L}); attention "
          f"of a step (CUDA events, device time at the step's shape): "
          f"forward {f_ms:.4f} ms x {2 * L} + backward {b_ms:.4f} ms x {L} "
          f"= {attn:.2f} ms ({attn / 1e3 / med:.1%} of the median step)")
    print(f"[phase9] 2-layer checks in {check_s:.2f} s, gap / tolerance: "
          f"{json.dumps({k_: float(f'{v_:.3g}') for k_, v_ in gaps.items()})}")
    return launches


# ---------------------------------------------------------------------------
# Phase 6: the hour-level refresh cycle and the dead-code reset
# ---------------------------------------------------------------------------

def refresh_logs(world: SyntheticWorld, seed: int):
    """Phase 3's one-day log split for the refresh: the old log (events up
    to P6_CUT_S) and the delta, which is the trailing hour plus fresh
    events of P6_NEW_USERS new users (Poisson(EVENTS_PER_USER / 24)
    events each, at least one, on items drawn from the hour's events)
    and on P6_NEW_ITEMS new items (Poisson(P6_ITEM_EVENTS) events each,
    at least one, by users drawn from the hour's events), event types
    as in the log; then the merged log and the feature tables grown by
    standard-normal rows for the new nodes.  Made with numpy from
    ``seed``.  Returns (old, delta, merged, user_feat, item_feat,
    fresh events)."""
    cfg = CONFIG
    log = world.day0
    nu, ni = log.n_users, log.n_items
    nu2, ni2 = nu + P6_NEW_USERS, ni + P6_NEW_ITEMS
    rng = np.random.default_rng((seed, 6))
    m = log.timestamp <= P6_CUT_S
    old = EngagementLog(log.user_id[m], log.item_id[m], log.event_type[m],
                        log.timestamp[m], nu, ni)
    hour = log.window(86400.0, 3600.0)
    fu = np.repeat(np.arange(nu, nu2, dtype=np.int64), np.maximum(
        rng.poisson(EVENTS_PER_USER / 24, P6_NEW_USERS), 1))
    fi = rng.choice(hour.item_id, len(fu))
    gi = np.repeat(np.arange(ni, ni2, dtype=np.int64), np.maximum(
        rng.poisson(P6_ITEM_EVENTS, P6_NEW_ITEMS), 1))
    gu = rng.choice(hour.user_id, len(gi))
    n_fresh = len(fu) + len(gi)
    fresh = (np.r_[fu, gu], np.r_[fi, gi],
             rng.choice(4, n_fresh, p=[0.7, 0.15, 0.1, 0.05]
                        ).astype(np.int32),
             P6_CUT_S + (1.0 - rng.random(n_fresh)) * 3600.0)
    delta = EngagementLog(*(np.r_[a, b] for a, b in zip(
        (hour.user_id, hour.item_id, hour.event_type, hour.timestamp),
        fresh)), nu2, ni2)
    merged = EngagementLog(*(np.r_[a, b] for a, b in zip(
        (old.user_id, old.item_id, old.event_type, old.timestamp),
        (delta.user_id, delta.item_id, delta.event_type,
         delta.timestamp))), nu2, ni2)
    user_feat = np.concatenate([world.user_feat, rng.standard_normal(
        (P6_NEW_USERS, cfg.d_user_feat), np.float32)])
    item_feat = np.concatenate([world.item_feat, rng.standard_normal(
        (P6_NEW_ITEMS, cfg.d_item_feat), np.float32)])
    return old, delta, merged, user_feat, item_feat, n_fresh


def refresh_split(g_new, t_old, cfg, dev):
    """``incremental_refresh``'s ``ppr_refresh`` re-run piece by piece, a
    sync after each: the host adjacency build, the change detection with
    the reverse BFS, the adjacency's copy to the card (``last`` and
    ``walk_layout``), the walk of the affected ids (``walk_split``) and
    the top-k (the spliced traces and their global mass on the host, the
    device top-k, the rows back to the host).  Returns the host
    adjacency, the affected ids, the split (host seconds, the launches'
    device ms) and the tables before the Group-2 fill."""
    st = t_old.ppr
    adj, adj_s = synced(lambda: build_padded_hetero_adj(
        g_new, st.max_deg_per_type))
    nu, old_nu = g_new.n_users, st.n_users
    n = adj.n_nodes

    def remap(a):
        return np.where(a >= old_nu, a + (nu - old_nu), a)

    def detect():
        old_pos = remap(np.arange(st.nbrs.shape[0]))
        changed = np.ones(n, bool)
        changed[old_pos] = ((adj.nbrs[old_pos] != remap(st.nbrs)).any(1)
                            | (adj.cum[old_pos] != st.cum).any(1))
        return old_pos, np.flatnonzero(
            _expand_affected(adj.nbrs, changed, st.walk_len - 1))

    (old_pos, ids), detect_s = synced(detect)
    dadj, to_card_s = synced(lambda: adjacency_to_device(adj, dev))
    vis, cnt, walk = walk_split(dadj, ids, cfg, st.seed, dev)

    def topk():
        visited = np.empty((n, vis.shape[1]), np.int64)
        visited[old_pos] = remap(st.visited)
        visited[ids] = vis.cpu().numpy()
        u, i = _topk_from_counts_device(
            vis, cnt, torch.from_numpy(ids).to(dev), st.k_imp, nu,
            st.hub_alpha, global_visit_mass(visited, n))
        tables = []
        for old_rows, new_rows in ((t_old.user_nbrs, u), (t_old.item_nbrs, i)):
            rows = np.full((n, st.k_imp), -1, np.int64)
            rows[old_pos] = remap(old_rows)
            rows[ids] = new_rows.cpu().numpy()
            tables.append(rows)
        return tables

    (users, items), topk_s = synced(topk)
    split = {"adjacency_host_s": round(adj_s, 4),
             "detect_and_bfs_s": round(detect_s, 4),
             "adjacency_to_card_s": round(to_card_s, 4), **walk,
             "topk_s": round(topk_s, 4)}
    return adj, ids, split, users, items


def layer_codes(flat: torch.Tensor, sizes) -> np.ndarray:
    """(B,) flat cluster ids -> (B, L) per-layer codes, on the host."""
    flat = flat.cpu().numpy()
    out = []
    for n in reversed(sizes):
        out.append(flat % n)
        flat = flat // n
    return np.stack(out[::-1], axis=1)


def probe_embeddings(state, cfg, ds, n_users: int, n_items: int, seed: int,
                     step: int) -> np.ndarray:
    """The reset's probe, as the JAX lifecycle runtime draws it:
    ``cfg.rq.reset_probe`` node ids from ``default_rng((seed, 91,
    step))``, freshly embedded (users, then items), as f32 numpy."""
    rng = np.random.default_rng((seed, 91, step))
    ids = np.sort(rng.choice(n_users + n_items,
                             min(cfg.rq.reset_probe, n_users + n_items),
                             replace=False))
    parts = [embed_all(state.params, cfg, ds, node_type=t, ids=sel,
                       batch=min(EMBED_BATCH, len(sel)))
             for t, sel in ((M.USER, ids[ids < n_users]),
                            (M.ITEM, ids[ids >= n_users])) if len(sel)]
    return torch.cat(parts).float().cpu().numpy()


def phase6(seed: int, dev) -> dict:
    cfg = CONFIG
    t = time.perf_counter()
    world = make_log_world(seed)
    old, delta, merged, user_feat, item_feat, n_fresh = refresh_logs(
        world, seed)
    del world
    log_s = time.perf_counter() - t
    nu, ni, nu2, ni2 = old.n_users, old.n_items, delta.n_users, delta.n_items
    n2 = nu2 + ni2
    print(f"[phase6] logs (no cut: Phase 3's log at full size): old "
          f"{len(old.user_id)} events up to {P6_CUT_S:.0f} s on {nu} users "
          f"and {ni} items; delta {len(delta.user_id)} events (the trailing "
          f"hour's {len(delta.user_id) - n_fresh}, {n_fresh} fresh ones of "
          f"{P6_NEW_USERS} new users and on {P6_NEW_ITEMS} new items); "
          f"made in {log_s:.2f} s")
    knobs = dict(alpha_pop=cfg.alpha_pop, c_u=cfg.c_u, c_i=cfg.c_i,
                 k_cap=cfg.k_cap, seed=seed)
    walk = dict(k_imp=cfg.k_imp, n_walks=cfg.ppr_walks,
                walk_len=cfg.ppr_len, restart=cfg.ppr_restart, seed=seed)
    prev_emb = np.concatenate([user_feat, item_feat])

    # the initial build on the first 23 hours (set-up, not the path)
    g_old, build_s = synced(lambda: build_graph(old, keep_state=True,
                                                **knobs))
    t_old, tables_s = synced(lambda: build_neighbor_tables(
        g_old, backend="device", device=dev, keep_state=True, **walk))

    # --- Phase 6's path: refresh, burst, closing reset, repair reset ---
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    common.reset_launches()
    (g_new, t_new, rep), refresh_s = synced(lambda: incremental_refresh(
        g_old, t_old, delta, prev_emb=prev_emb, backend="device",
        device=dev))
    ids = rep["affected_nodes"]
    ds = EdgeDataset(t_new, user_feat, item_feat, k_train=cfg.k_train,
                     device=dev, g=g_new)
    feats = FeatureStore(ds.user_feat, ds.item_feat)
    state, opt = init_state(cfg, generator=torch.Generator().manual_seed(
        seed), pool_size=P3_POOL, device=dev)
    step_fn = make_train_step(cfg, opt, features=feats)
    per_type = {et: CF_ROWS for et in ("uu", "ui", "ii")}
    t = time.perf_counter()
    history = []
    for s_ in range(P6_STEPS):
        state, m = step_fn(state, ds.sample_batch(s_, seed, per_type),
                           generator=torch.Generator(dev).manual_seed(
                               1000 + s_))
        history.append({k: float(v) for k, v in m.items()})
    burst_s = time.perf_counter() - t
    # the closing pass of the burst (lifecycle runtime: after the final
    # step of every burst when reset_every > 0)
    probe = probe_embeddings(state, cfg, ds, nu2, ni2, seed, P6_STEPS)
    state, rep_close = reset_dead_codes(state, probe, cfg, seed=seed,
                                        step=P6_STEPS)
    # the repair path: usage from the probe's published codes
    sizes = cfg.rq.codebook_sizes
    probe_dev = torch.from_numpy(probe).to(dev)
    before = layer_codes(assign_codes(state.params["rq"], probe_dev, cfg.rq),
                         sizes)
    usage = per_code_counts(before, sizes)
    books = state.params["rq"]["codebooks"]
    cpu_rq = codebooks_module([books[f"layer{l}"].detach().cpu().clone()
                               for l in range(len(sizes))])
    rs = state.rq_state
    cpu_state = RQState(tuple(h.cpu() for h in rs.hists),
                        tuple(u.cpu() for u in rs.usage), rs.ptr, rs.filled)
    objs = named_params(state.params)
    params_before = {k: p.detach().clone() for k, p in objs.items()}
    opt_before = copy.deepcopy(state.opt_state)
    hists_before = [h.clone() for h in rs.hists]
    pool_before = copy.deepcopy(state.pool)
    t = time.perf_counter()
    state, rep_repair = reset_dead_codes(state, probe, cfg, seed=seed,
                                         step=P6_STEPS + 1, usage=usage)
    repair_s = time.perf_counter() - t
    after = layer_codes(assign_codes(state.params["rq"], probe_dev, cfg.rq),
                        sizes)
    # the reset's guarantees, before anything trains on
    check(all(a is b for a, b in zip(named_params(state.params).values(),
                                     objs.values())),
          "the reset replaced a Parameter object")
    revived = []
    for name, p in named_params(state.params).items():
        same = (p.detach() == params_before[name]).reshape(p.shape[0], -1) \
            .all(dim=1) if p.dim() else (p.detach() == params_before[name])
        if name.startswith("rq.codebooks."):
            revived.append((~same).cpu().numpy())
            check(int((~same).sum()) == rep_repair["reset_" + name[-6:]],
                  f"{name}: {int((~same).sum())} rows changed, report "
                  f"{rep_repair}")
        else:
            check(bool(same.all()), f"the reset changed {name}")

    def same_tree(a, b):
        if isinstance(a, torch.Tensor):
            return torch.equal(a, b)
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same_tree(a[k], b[k])
                                                for k in a)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(map(same_tree, a, b))
        return a == b

    check(same_tree(state.opt_state, opt_before),
          "the reset changed the optimizer's state")
    check(state.rq_state.hists is rs.hists
          and all(torch.equal(a, b) for a, b in zip(rs.hists, hists_before))
          and (state.rq_state.ptr, state.rq_state.filled)
          == (rs.ptr, rs.filled), "the reset changed the RQ histograms")
    check(same_tree(dataclasses.asdict(state.pool),
                    dataclasses.asdict(pool_before)),
          "the reset changed the pool")
    # the same call on a CPU copy of the state: bitwise equal
    cpu_new, cpu_rs, cpu_rep = dead_code_reset(
        cpu_rq, cpu_state, probe, cfg.rq, seed=seed, step=P6_STEPS + 1,
        usage=usage)
    check(cpu_rep == rep_repair, f"reset report: card {rep_repair}, cpu "
          f"{cpu_rep}")
    for l in range(len(sizes)):
        check(torch.equal(books[f"layer{l}"].detach().cpu(),
                          cpu_new["codebooks"][f"layer{l}"])
              and torch.equal(state.rq_state.usage[l].cpu(),
                              cpu_rs.usage[l]),
              f"layer {l}: the card's reset differs from the CPU's")
    moved = before[:, 0] != after[:, 0]
    check(bool(revived[0][after[moved, 0]].all()),
          "a probe row moved between two live layer-0 codes")
    # one train step and one eval step after the reset
    state, m_after = step_fn(state, ds.sample_batch(P6_STEPS, seed,
                                                    per_type),
                             generator=torch.Generator(dev).manual_seed(
                                 1000 + P6_STEPS))
    ebatch = ds.sample_batch(P6_STEPS + 1, seed, per_type)
    draws = draws_for(cfg, state.pool, ebatch, CF_ROWS,
                      torch.Generator().manual_seed(seed + 13))
    ev = make_eval_step(cfg, features=feats)(state, ebatch, draws=draws)
    torch.cuda.synchronize()
    launches = common.launch_counts()        # Phase 6's path ends here
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ev = {k: float(v) for k, v in ev.items()}
    m_after = {k: float(v) for k, v in m_after.items()}

    # --- checks ----------------------------------------------------------
    want = {"ppr_walk": -(-len(ids) // PPR_STARTS),
            "fused_contrastive_fwd": 7 * (P6_STEPS + 2),
            "fused_contrastive_bwd": 7 * (P6_STEPS + 1), "rq_assign": 2}
    for name, n in want.items():
        check(launches.get(name, 0) == n,
              f"{name}: {launches.get(name, 0)} launches, expected {n}")
    for i, h in enumerate(history + [m_after]):
        check(all(np.isfinite(v) for v in h.values()),
              f"burst step {i}: non-finite metrics {h}")
    check(all(np.isfinite(v) for v in ev.values()),
          f"eval after the reset: non-finite {ev}")
    with torch.no_grad():
        ref, _ = forward_losses(state.params, cfg, ebatch, state.pool,
                                state.rq_state, features=feats,
                                train=False, draws=draws)
    check(all(float(ref[k]) == ev[k] for k in ref) and set(ref) == set(ev),
          "the eval step differs from forward_losses(train=False)")
    check(sum(rep_repair.values()) > 0, "the repair reset revived nothing")

    # the refresh's ppr stage again, piece by piece; its tables equal the
    # refresh's on every row but the same-type rows of the affected
    # Group-2 nodes, which the fill writes
    adj, ids_split, split, users, items = refresh_split(g_new, t_old, cfg,
                                                        dev)
    fill_u = np.zeros(n2, bool)
    fill_u[ids[ids < nu2]] = ~g_new.group1_users[ids[ids < nu2]]
    fill_i = np.zeros(n2, bool)
    fill_i[ids[ids >= nu2]] = ~g_new.group1_items[ids[ids >= nu2] - nu2]
    check(np.array_equal(ids_split, ids)
          and np.array_equal(users[~fill_u], t_new.user_nbrs[~fill_u])
          and np.array_equal(items[~fill_i], t_new.item_nbrs[~fill_i]),
          "the re-run's pieces differ from incremental_refresh")
    # re-walked traces against the numpy walker on the new adjacency
    rng = np.random.default_rng(seed + 6)
    fresh_ids = np.r_[np.arange(nu, nu2), nu2 + np.arange(ni, ni2)]
    edge = min(512, len(ids) // 4)      # first and last, new, random
    n_new = min(512, len(fresh_ids))
    n_rand = max(0, min(len(ids), P6_TRACES - 2 * edge - n_new))
    sample = np.unique(np.r_[ids[:edge], ids[-edge:],
                             rng.choice(fresh_ids, n_new, replace=False),
                             rng.choice(ids, n_rand, replace=False)])
    check(np.isin(fresh_ids, ids).all(), "a new node was not re-walked")
    ref_vis = _walk_numpy(adj, sample, n_walks=cfg.ppr_walks,
                          walk_len=cfg.ppr_len, restart=cfg.ppr_restart,
                          seed=seed, chunk=1 << 18)
    check(np.array_equal(t_new.ppr.visited[sample], ref_vis),
          "re-walked traces differ from the numpy walker's")

    # a from-scratch rebuild on the merged log
    g_full, full_build_s = synced(lambda: build_graph(merged, **knobs))
    t_full, full_tables_s = synced(lambda: build_neighbor_tables(
        g_full, prev_emb=prev_emb, backend="device", device=dev, **walk))
    for et in ("ui", "uu", "ii"):
        a, b = getattr(g_new, et), getattr(g_full, et)
        check(all(np.array_equal(getattr(a, f), getattr(b, f))
                  and getattr(a, f).dtype == getattr(b, f).dtype
                  for f in ("src", "dst", "weight")),
              f"refreshed {et} edges differ from the rebuild's")
    check(np.array_equal(g_new.group1_users, g_full.group1_users)
          and np.array_equal(g_new.group1_items, g_full.group1_items),
          "refreshed group1 masks differ from the rebuild's")
    am = np.zeros(n2, bool)
    am[ids] = True
    old_pos = np.where(np.arange(nu + ni) >= nu, np.arange(nu + ni)
                       + (nu2 - nu), np.arange(nu + ni))
    carried = ~am[old_pos]
    for what, a, b, o in (("user", t_new.user_nbrs, t_full.user_nbrs,
                           t_old.user_nbrs),
                          ("item", t_new.item_nbrs, t_full.item_nbrs,
                           t_old.item_nbrs)):
        check(np.array_equal(a[am], b[am]),
              f"affected {what} rows differ from the rebuild's")
        check(np.array_equal(a[old_pos[carried]],
                             np.where(o >= nu, o + (nu2 - nu), o)[carried]),
              f"carried {what} rows differ from the remapped old tables")

    g2 = (int(fill_u.sum()), int(fill_i.sum()))
    sec = {k: round(v, 4) for k, v in rep["seconds"].items()}
    print(f"[phase6] initial build (23 h): construct {build_s:.4f} s, "
          f"tables {tables_s:.4f} s; edges "
          f"{json.dumps({et: len(getattr(g_old, et)) for et in ('ui', 'uu', 'ii')})}")
    print(f"[phase6] incremental_refresh {refresh_s:.4f} s (synced; report "
          f"{json.dumps(sec)}, refresh_seconds "
          f"{rep['refresh_seconds']:.4f}); touched users "
          f"{len(rep['touched_users'])} of {nu2} "
          f"({len(rep['touched_users']) / nu2:.4f}), items "
          f"{len(rep['touched_items'])} of {ni2} "
          f"({len(rep['touched_items']) / ni2:.4f}); affected nodes "
          f"{len(ids)} of {n2} ({len(ids) / n2:.4f}); Group-2 rows filled "
          f"{g2[0]} users, {g2[1]} items; edges "
          f"{json.dumps({et: len(getattr(g_new, et)) for et in ('ui', 'uu', 'ii')})}")
    split_s = sum(v for k, v in split.items() if k.endswith("_s"))
    print(f"[phase6] ppr_refresh split (re-run piece by piece, each synced; "
          f"host seconds, the launches' device ms): {json.dumps(split)}; sum "
          f"{split_s + split['launches_ms'] / 1e3:.4f} s against the "
          f"report's ppr_refresh {rep['seconds']['ppr_refresh']:.4f} s")
    print(f"[phase6] rebuild on the merged log: construct {full_build_s:.4f}"
          f" s, tables {full_tables_s:.4f} s; edge sets and group1 masks "
          f"bitwise equal to the refresh's; affected rows equal the "
          f"rebuild's, {int(carried.sum())} carried rows the remapped old "
          f"tables; traces of {len(sample)} re-walked starts bitwise equal "
          f"to the numpy walker")
    print(f"[phase6] burst: {P6_STEPS} steps x {3 * CF_ROWS} edges in "
          f"{burst_s:.4f} s; total {[round(h['total'], 4) for h in history]}")
    print(f"[phase6] closing reset {json.dumps(rep_close)}; repair reset "
          f"(usage = the probe's code counts) {json.dumps(rep_repair)} in "
          f"{repair_s:.4f} s, equal to the CPU's; {int(moved.sum())} of "
          f"{len(probe)} probe rows moved layer-0 code, all to revived "
          f"codes; live rows, other parameters, optimizer state bit-"
          f"unchanged")
    print(f"[phase6] after the reset: train step total {m_after['total']:.5f}"
          f", eval {json.dumps({k: round(v, 5) for k, v in ev.items()})} "
          f"(equal to forward_losses(train=False)); peak device memory "
          f"{peak_gb:.3f} GB; launches={launches}")
    return launches, dict(g=g_new, tables=t_new, user_feat=user_feat,
                          item_feat=item_feat, merged=merged)


# ---------------------------------------------------------------------------
# Phase 7: the lifecycle loop at full width
# ---------------------------------------------------------------------------

def next_day(seed: int, n_users: int, n_items: int):
    """The next day's log, made with numpy from Phase 3's topic model:
    the same users' home topics (``topic_model`` of ``default_rng(seed)``)
    and a separate stream, ``default_rng((seed, 7))``: Poisson(P7_EVENTS)
    events per user of Phase 3's log (``topic_events``), timestamps over
    the day after day 0, in time order, ids in the grown spaces.  Returns
    (the first P7_DELTA_S seconds: cycle 1's refresh delta and the live
    traffic; the rest: the gate's next-day ground truth)."""
    model = topic_model(np.random.default_rng(seed))
    rng = np.random.default_rng((seed, 7))
    users, items, etype = topic_events(rng, model,
                                       rng.poisson(P7_EVENTS, P3_USERS))
    ts = 86400.0 + rng.random(len(users)) * 86400.0
    o = np.argsort(ts, kind="stable")
    users, items, etype, ts = users[o], items[o], etype[o], ts[o]
    early = ts < 86400.0 + P7_DELTA_S

    def log(m):
        return EngagementLog(users[m], items[m], etype[m], ts[m], n_users,
                             n_items)

    return log(early), log(~early)


def spans_by_cycle(sink) -> list:
    """Per ``lifecycle.cycle`` span of the trace: its direct children by
    name (seconds), and the children of its ``lifecycle.swap``."""
    recs = [json.loads(ln) for ln in sink.lines]
    spans = [r for r in recs if r["type"] == "span"]
    out = []
    for cyc in (r for r in spans if r["name"] == "lifecycle.cycle"):
        kids = {r["name"]: r for r in spans
                if r["parent_id"] == cyc["span_id"]}
        swap = kids.get("lifecycle.swap")
        swap_kids = ([r["name"] for r in spans
                      if r["parent_id"] == swap["span_id"]]
                     if swap else [])
        out.append(({k: v["dur_s"] for k, v in kids.items()}, swap_kids,
                    cyc["dur_s"]))
    return out


def codes_held(rt) -> int:
    """A sample of P7_CODE_SAMPLE user codes of the live snapshot must
    equal ``rq_assign``'s plain version on the runtime's embeddings but
    for near ties (Phase 1's rule).  Returns the near-tie rows."""
    snap = rt.server.handle.acquire().snapshot
    user = rt._last_user_emb
    idx = np.sort(np.random.default_rng(snap.version).choice(
        snap.n_users, P7_CODE_SAMPLE, replace=False))
    x = user[torch.from_numpy(idx).to(user.device)].float()
    books = [c.detach().float() for c in layer_books(
        rt.state.params["rq"], len(snap.codebook_sizes))]
    cp, _ = rq_assign_ref(x, books)
    ck = torch.from_numpy(snap.user_codes[idx]).to(x.device)
    return near_ties(x, ck, cp.to(ck.dtype), books,
                     f"v{snap.version} published codes")


def gate_recheck(rt, world) -> None:
    """The live snapshot's gate metrics recomputed on CPU copies of the
    snapshot and the runtime's embeddings (the users' RQ reconstruction
    encoded again: ``rq_assign`` repeats bitwise) must equal the
    report's."""
    snap = rt.server.handle.acquire().snapshot
    cpu = dataclasses.replace(snap, **{f: getattr(snap, f).copy()
                                       for f in SNAP_FIELDS})
    user, item = rt._last_user_emb, rt._last_item_emb
    _, _, recon = encode_corpus(rt.state.params["rq"], user,
                                snap.codebook_sizes,
                                chunk=rt.lcfg.encode_chunk)
    lc = rt.lcfg
    m = evaluate_snapshot(cpu, user.cpu(), recon.cpu(), world,
                          recall_k=lc.recall_k, n_queries=lc.recall_queries,
                          seed=rt.seed, n_probe_factor=lc.n_probe_factor,
                          hitrate_pairs=rt._hitrate_pairs(),
                          item_emb=item.cpu())
    check(m == snap.metrics, f"v{snap.version}: the gate recomputed on CPU "
          f"copies {m} differs from the report's {snap.metrics}")


def serve_stage(server, users_p99, users_bulk, now: float, version: int):
    """8 serve_p99 batches and one serve_bulk batch through
    ``SwapServer.serve_batch`` (``queue_gather``); every response must
    carry ``version``, and P7_SAMPLE bulk rows must equal the plain
    version on the same store state.  Returns seconds per p99 batch and
    the bulk batch's."""
    p99_s, ver = [], set()
    for users in users_p99:
        t = time.perf_counter()
        _, _, v = server.serve_batch(users, now, n_recent=N_RECENT,
                                     k=K_UNION)
        p99_s.append(time.perf_counter() - t)
        ver.add(v)
    t = time.perf_counter()
    s, u, v = server.serve_batch(users_bulk, now, n_recent=N_RECENT,
                                 k=K_UNION)
    bulk_s = time.perf_counter() - t
    ver.add(v)
    check(ver == {version}, f"responses carry versions {ver}, live is "
          f"{version}")
    b = server.handle.acquire()
    st, store = b.store._state, b.store
    rows = np.random.default_rng(version).choice(len(users_bulk), P7_SAMPLE,
                                                 replace=False)
    cl, known = store.clusters_of(users_bulk[rows])
    dev = store.device
    sp, up = queue_gather_ref(
        st["items"], st["times"], st["total"],
        torch.as_tensor(np.where(known, cl, -1).astype(np.int32)).to(dev),
        torch.as_tensor(b.i2i).to(dev, torch.int32),
        cutoff=store.rel_cutoff(now), n_recent=N_RECENT, k=K_UNION)
    check(np.array_equal(s[rows], sp.cpu().numpy())
          and np.array_equal(u[rows], up.cpu().numpy()),
          f"v{version}: served rows differ from the plain version")
    check(bool((s[~store.clusters_of(users_bulk)[1]] == -1).all()),
          "unknown users got seeds")
    return p99_s, bulk_s, float((s[:, 0] >= 0).mean())


def phase7(seed: int, dev, p6: dict) -> dict:
    cfg = CONFIG
    g, tables = p6["g"], p6["tables"]
    nu, ni = g.n_users, g.n_items
    t = time.perf_counter()
    delta, day1 = next_day(seed, nu, ni)
    world = SimpleNamespace(day1=day1)
    merged = p6["merged"]
    tail = merged.timestamp > 86400.0 - P7_TAIL_S
    o = np.argsort(merged.timestamp[tail], kind="stable")
    live0 = tuple(a[tail][o] for a in (merged.user_id, merged.item_id,
                                       merged.timestamp))
    live1 = (delta.user_id, delta.item_id, delta.timestamp)
    rng = np.random.default_rng(seed + 7)
    users_p99 = [rng.integers(0, nu, P99_BATCH) for _ in range(P99_REPS)]
    users_bulk = rng.integers(0, nu, BULK_BATCH)
    users_bulk[:: 1009] = nu + 5                # post-snapshot ids
    log_s = time.perf_counter() - t
    lcfg = LifecycleConfig(
        steps_per_cycle=P7_STEPS, batch_per_type=CF_ROWS, recall_k=100,
        recall_queries=P7_QUERIES, i2i_k=I2I_K, queue_len=QUEUE_LEN,
        recency_s=P7_RECENCY_S, ring_capacity=P7_RING,
        encode_chunk=RQ_ROWS, embed_batch=EMBED_BATCH)
    print(f"[phase7] next day (no published source): {len(delta.user_id)} "
          f"events in its first {P7_DELTA_S:.0f} s (cycle 1's delta and live "
          f"traffic), {len(day1.user_id)} after them (the gate's ground "
          f"truth), made in {log_s:.2f} s; live day-0 tail "
          f"{len(live0[0])} events (last {P7_TAIL_S:.0f} s of Phase 6's "
          f"merged log); graph {nu} users, {ni} items; {lcfg}")
    sink = MemorySink()
    tel = Telemetry(sink=sink)
    launches: dict = {}

    def on_path(fn):
        """``fn()`` on Phase 7's path: its launches are added."""
        common.reset_launches()
        r = fn()
        torch.cuda.synchronize()
        for k_, v_ in common.launch_counts().items():
            launches[k_] = launches.get(k_, 0) + v_
        return r

    secs = {}
    with tempfile.TemporaryDirectory() as snap_dir:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rt, secs["runtime_init"] = synced(lambda: LifecycleRuntime(
            cfg, lcfg, g, tables, p6["user_feat"], p6["item_feat"],
            world=world, snapshot_dir=snap_dir, seed=seed, telemetry=tel,
            device=dev))
        t = time.perf_counter()
        rep1 = on_path(lambda: rt.run_cycle(now=86400.0))
        secs["cycle0"] = time.perf_counter() - t
        near1 = codes_held(rt)
        server = rt.server

        def ingest(events, batch):
            for lo in range(0, len(events[0]), batch):
                server.ingest(*(a[lo:lo + batch] for a in events))

        t = time.perf_counter()
        on_path(lambda: (ingest(live0, INGEST_BATCH), ingest(live1, 1 << 30)))
        secs["ingest"] = time.perf_counter() - t
        now = 86400.0 + P7_DELTA_S
        serve1 = on_path(lambda: serve_stage(server, users_p99, users_bulk,
                                             now, 1))
        t = time.perf_counter()
        rep2 = on_path(lambda: rt.run_cycle(delta, now=now,
                                            backend="device"))
        secs["cycle1"] = time.perf_counter() - t
        near2 = codes_held(rt)
        # the gate once more on CPU copies (v2 only: on an index whose
        # layer-0 lists hold most users, the gate ranks nearly every user
        # for each query, which costs as much as the publish itself)
        _, gate_s = synced(lambda: gate_recheck(rt, world))
        serve2 = on_path(lambda: serve_stage(server, users_p99, users_bulk,
                                             now, 2))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        versions = rt.store.versions()
        # a restart: a fresh runtime on the same directory
        rt2, secs["restart_init"] = synced(lambda: LifecycleRuntime(
            cfg, lcfg, rt.g, rt.tables, rt.user_feat, rt.item_feat,
            world=world, snapshot_dir=snap_dir, seed=seed,
            telemetry=Telemetry(enabled=False), device=dev))
        t = time.perf_counter()
        recovered = on_path(lambda: rt2.recover_serving(now=now))
        secs["recover_serving"] = time.perf_counter() - t
        live = rt.server.handle.acquire().snapshot
        back = rt2.server.handle.acquire().snapshot

    # --- checks ----------------------------------------------------------
    for i, rep in enumerate((rep1, rep2)):
        failed = [k_ for k_, v_ in rep.items()
                  if isinstance(v_, dict) and v_.get("failed")]
        check(not failed and not rep["degraded"]
              and not rep["swap"].get("skipped"),
              f"cycle {i}: failed {failed}, report {rep}")
        check(rep["publish"]["version"] == i + 1, f"cycle {i}: version "
              f"{rep['publish']['version']}")
    check(versions == [1, 2], f"the store holds versions {versions}")
    sw = rep2["swap"]
    ring_ts = np.r_[live0[2], live1[2]][-P7_RING:]
    fresh = int((ring_ts >= now - P7_RECENCY_S).sum())
    check(sw["replayed_events"] + sw["dropped_stale"] == len(ring_ts)
          and sw["replayed_events"] == fresh and sw["ring_dropped"] == 0,
          f"swap accounting {sw}: ring {len(ring_ts)} events, {fresh} in "
          f"the recency window")
    check(recovered == 2 and back.version == 2, f"recovered {recovered}")
    for f in SNAP_FIELDS:
        a, b = getattr(back, f), getattr(live, f)
        check(a.dtype == b.dtype and np.array_equal(a, b),
              f"recovered {f} differs from version 2 in memory")
    check(back.gate_metrics == live.gate_metrics, "recovered gate metrics")
    cycles = spans_by_cycle(sink)
    check(len(cycles) == 2, f"{len(cycles)} lifecycle.cycle spans")
    for (stages, swap_kids, _), want in zip(
            cycles, (("lifecycle.train", "lifecycle.publish",
                      "lifecycle.swap"),
                     ("lifecycle.refresh", "lifecycle.train",
                      "lifecycle.publish", "lifecycle.swap"))):
        check(set(want) <= set(stages) and ("lifecycle.refresh" in stages)
              == ("lifecycle.refresh" in want),
              f"cycle spans' children {sorted(stages)}, want {want}")
    check(cycles[1][1] == ["swap.build", "swap.replay", "swap.catchup",
                           "swap.flip", "swap.post_drain"],
          f"swap spans {cycles[1][1]}")
    n_users_chunks = -(-nu // RQ_ROWS) + -(-ni // RQ_ROWS)
    want = {"fused_contrastive_fwd": 7 * 2 * P7_STEPS,
            "fused_contrastive_bwd": 7 * 2 * P7_STEPS,
            "rq_assign": 2 * n_users_chunks,
            "ppr_walk": -(-rep2["refresh"]["affected_nodes"] // PPR_STARTS),
            "queue_gather": 2 * (P99_REPS + 1)}
    for name, n in want.items():
        check(launches.get(name, 0) == n,
              f"{name}: {launches.get(name, 0)} launches on Phase 7's path, "
              f"expected {n}")

    gate_keys = ("recall_exact", "recall_index", "recall_ratio",
                 "item_recall_exact", "item_recall_index",
                 "item_recall_ratio", "codebook_util_min",
                 "coarse_list_balance", "hitrate10_orig", "hitrate10_recon")
    for i, ((stages, _, cyc_s), rep, near) in enumerate(zip(
            cycles, (rep1, rep2), (near1, near2))):
        st_s = {k_.split(".", 1)[1]: round(v_, 4) for k_, v_ in stages.items()}
        print(f"[phase7] cycle {i}: {cyc_s:.4f} s, stages (span seconds) "
              f"{json.dumps(st_s)}; train {json.dumps({k_: round(v_, 4) for k_, v_ in rep['train'].items()})}")
        print(f"[phase7] cycle {i} gate (v{i + 1}): "
              f"{json.dumps({k_: rep['publish'].get(k_) for k_ in gate_keys})}"
              f"; {P7_CODE_SAMPLE} published codes equal the plain "
              f"version, {near} near ties")
    print(f"[phase7] v2's gate recomputed on CPU copies: equal to the "
          f"report's, in {gate_s:.4f} s")
    print(f"[phase7] refresh (cycle 1): {json.dumps(rep2['refresh'])}")
    print(f"[phase7] swap (cycle 1): build_ms {sw['build_ms']:.4f}, "
          f"stall_ms {sw['stall_ms']:.4f}, replayed {sw['replayed_events']:.0f}"
          f", dropped_stale {sw['dropped_stale']:.0f} of {len(ring_ts)} ring "
          f"events; bring-up (cycle 0): report "
          f"{json.dumps({k_: v_ for k_, v_ in rep1['swap'].items() if k_ != 'span_id'})}"
          f", its span {cycles[0][0]['lifecycle.swap']:.4f} s")
    for v, (p99_s, bulk_s, filled) in ((1, serve1), (2, serve2)):
        print(f"[phase7] serve v{v}: serve_p99 batch={P99_BATCH} seconds "
              f"{[round(x, 5) for x in p99_s]}; serve_bulk batch="
              f"{BULK_BATCH} {bulk_s:.5f} s, rows with a seed {filled:.4f}; "
              f"{P7_SAMPLE} bulk rows equal the plain version")
    print(f"[phase7] seconds {json.dumps({k_: round(v_, 4) for k_, v_ in secs.items()})}; "
          f"recover_serving -> v{recovered}, leaves bitwise equal to v2 in "
          f"memory; store versions {versions}; peak device memory "
          f"{peak_gb:.3f} GB; launches={launches}")
    return launches


# ---------------------------------------------------------------------------
# Phase 8: serving scale-out (delta-run ingest, shards), the sharded swap,
# chaos
# ---------------------------------------------------------------------------

def folds_of(store) -> int:
    """The folds of a non-empty delta run, summed over the partitions."""
    return sum(part.folds for part in store.partitions())


def p8_store(user_clusters, n_clusters: int, shards: int, delta: int, dev,
             tel):
    kw = dict(queue_len=QUEUE_LEN, recency_s=RECENCY_S,
              n_clusters=n_clusters, delta_cap=delta, telemetry=tel)
    if shards > 1:
        return ShardedQueueStore(user_clusters, n_shards=shards,
                                 devices=[dev], **kw)
    return ClusterQueueStore(user_clusters, device=dev, **kw)


def qg_launches() -> int:
    return common.launch_counts().get("queue_gather", 0)


def p8_serve(serve, batches, now: float) -> tuple:
    """``serve(users, now)`` on each batch: (rows, seconds per batch,
    ``queue_gather`` launches per batch)."""
    rows, secs, launches = [], [], []
    for users in batches:
        n0 = qg_launches()
        t = time.perf_counter()
        rows.append(serve(users, now))
        secs.append(time.perf_counter() - t)
        launches.append(qg_launches() - n0)
    return rows, secs, launches


def same_rows(a: list, b: list) -> bool:
    return all(len(x) == len(y) and all(np.array_equal(u, v)
                                        for u, v in zip(x, y))
               for x, y in zip(a, b)) and len(a) == len(b)


def p8_mix(store, mix, users, now: float, i2i) -> tuple:
    """8a's mixed traffic: each round ingests one chunk of ``mix`` (timed
    to a sync), then serves one ``users`` batch (``serve_batch`` returns
    host arrays, so it ends synced).  Returns (rows, ingest seconds,
    serve seconds, folds made inside the serves)."""
    rows, ingest_s, serve_s, serve_folds = [], [], [], 0
    for r, ev in enumerate(mix):
        t = time.perf_counter()
        store.ingest(*ev)
        torch.cuda.synchronize()
        ingest_s.append(time.perf_counter() - t)
        f0 = folds_of(store)
        t = time.perf_counter()
        rows.append(store.serve_batch(users[r % len(users)], now,
                                      n_recent=N_RECENT, k=K_UNION, i2i=i2i))
        serve_s.append(time.perf_counter() - t)
        serve_folds += folds_of(store) - f0
    return rows, ingest_s, serve_s, serve_folds


def ms_summary(secs: list) -> str:
    a = np.asarray(secs) * 1e3
    return (f"median {np.median(a):.4f} ms, p99 "
            f"{np.percentile(a, 99):.4f}, max {a.max():.4f}")


def phase8_stores(dev, snap, batches, users, now: float) -> None:
    """8a: Phase 2's stream into four stores on the card (direct and
    delta, unsharded and P8_SHARDS shards); their serve rows and cursors
    must be bitwise equal, 512 bulk rows equal to the plain
    ``queue_gather`` on the CPU, and the ``.shard{i}`` ingest counters
    must sum to the aggregate.  Then mixed traffic (``p8_mix``: the
    stream's last batch again, SPAN_S later, in chunks, a serve after
    each), whose rows and cursors must be equal too; its serve times give
    the delta stores' per-serve fold cost against the direct stores'."""
    ref = None
    last_u, last_i, last_t = batches[-1]
    mix = [(last_u[lo:lo + P8_MIX_EVENTS], last_i[lo:lo + P8_MIX_EVENTS],
            last_t[lo:lo + P8_MIX_EVENTS] + SPAN_S)
           for lo in range(0, P8_MIX_ROUNDS * P8_MIX_EVENTS, P8_MIX_EVENTS)]
    mix_users, mix_now = users[:-1], now + SPAN_S
    median_serve = {}
    for name, shards, delta in (("direct", 1, 0), ("delta", 1, P8_DELTA),
                                ("shards", P8_SHARDS, 0),
                                ("shards+delta", P8_SHARDS, P8_DELTA)):
        tel = Telemetry()
        store = p8_store(snap.user_clusters, snap.n_clusters, shards, delta,
                         dev, tel)
        t = time.perf_counter()
        for batch in batches:
            store.ingest(*batch)
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t
        rows, serve_s, launched = p8_serve(
            lambda u, now: store.serve_batch(u, now, n_recent=N_RECENT,
                                             k=K_UNION, i2i=snap.i2i),
            users, now)
        c = tel.snapshot()["counters"]
        check(c["serving.ingest_events"] == N_EVENTS,
              f"8a {name}: {c['serving.ingest_events']} events counted")
        if shards > 1:
            tagged = sum(c.get(f"serving.ingest_events.shard{i}", 0.0)
                         for i in range(shards))
            check(tagged == c["serving.ingest_events"],
                  f"8a {name}: shard ingest counters sum to {tagged}")
        check(launched == [shards] * len(users),
              f"8a {name}: queue_gather launches per serve batch "
              f"{launched}, want {shards}")
        if ref is None:
            ref = (rows, store.cursor.copy())
            st = store._state
            sample = np.random.default_rng(8).choice(BULK_BATCH, P7_SAMPLE,
                                                     replace=False)
            cl, known = store.clusters_of(users[-1][sample])
            sp, up = queue_gather_ref(
                st["items"].cpu(), st["times"].cpu(), st["total"].cpu(),
                torch.as_tensor(np.where(known, cl, -1).astype(np.int32)),
                torch.as_tensor(snap.i2i).to(torch.int32),
                cutoff=store.rel_cutoff(now), n_recent=N_RECENT, k=K_UNION)
            s, u = rows[-1]
            check(np.array_equal(s[sample], sp.numpy())
                  and np.array_equal(u[sample], up.numpy()),
                  "8a: bulk rows differ from the plain version on the CPU")
        else:
            check(same_rows(rows, ref[0]),
                  f"8a {name}: served rows differ from the direct store's")
            check(np.array_equal(store.cursor, ref[1]),
                  f"8a {name}: cursor differs from the direct store's")
        st = store.stats()
        folds = folds_of(store)
        print(f"[phase8a] {name}: shards {shards} delta_cap {delta}: ingest "
              f"{N_EVENTS} events {ingest_s:.4f} s, folds {folds}; serve "
              f"p99 seconds {[round(x, 5) for x in serve_s[:-1]]}, bulk "
              f"{serve_s[-1]:.5f} s; queue_gather launches per serve batch "
              f"{launched[0]}; active clusters {st['n_clusters_active']}, "
              f"delta pending {st['delta_pending']:.0f}")
        m_rows, m_ingest, m_serve, m_folds = p8_mix(store, mix, mix_users,
                                                    mix_now, snap.i2i)
        if name == "direct":
            ref = ref + (m_rows, store.cursor.copy())
        else:
            check(same_rows(m_rows, ref[2])
                  and np.array_equal(store.cursor, ref[3]),
                  f"8a {name}: mixed-traffic rows or cursor differ from the "
                  f"direct store's")
        median_serve[name] = float(np.median(m_serve))
        print(f"[phase8a] {name} mix: {P8_MIX_ROUNDS} rounds of "
              f"{P8_MIX_EVENTS} events then {P99_BATCH} requests: ingest "
              f"{ms_summary(m_ingest)}; serve {ms_summary(m_serve)}; folds "
              f"{folds_of(store) - folds}, {m_folds} of them inside serves")
        del store
        torch.cuda.empty_cache()
    filled = float((ref[0][-1][0][:, 0] >= 0).mean())
    print(f"[phase8a] the four stores' seeds and unions (8 x {P99_BATCH} and "
          f"{BULK_BATCH} requests, then the mix) and cursors are bitwise "
          f"equal; {P7_SAMPLE} bulk rows equal the plain queue_gather on the "
          f"CPU; bulk rows with a seed {filled:.4f}")
    print(f"[phase8a] mix: per-serve fold cost (median serve, delta minus "
          f"direct) unsharded "
          f"{(median_serve['delta'] - median_serve['direct']) * 1e3:.4f} ms, "
          f"{P8_SHARDS} shards "
          f"{(median_serve['shards+delta'] - median_serve['shards']) * 1e3:.4f}"
          f" ms")


def phase8_scaleout(dev) -> None:
    """8b: ``benchmarks/serving_scaleout.py::_shard_gate`` on the card:
    ``ShardedQueueStore`` at 1, 2 and 4 shards (delta_cap P8_DELTA), 4 x
    100,000 warm events, then interleaved mixed cycles (12,000 events,
    then a retrieve of 2,048 users at k 32), best of SO_ROUNDS.  Each
    round's events go to all three stores, whose retrieved rows must be
    equal (the reference draws each store's cycle apart)."""
    rng = np.random.default_rng(1)
    k, now = 32, 1e6
    uc = rng.integers(0, SO_C, SO_USERS)
    stores = {s: ShardedQueueStore(uc, n_shards=s, queue_len=QUEUE_LEN,
                                   recency_s=1e15, n_clusters=SO_C,
                                   delta_cap=P8_DELTA, devices=[dev])
              for s in (1, 2, 4)}
    for _ in range(4):
        ev = (rng.integers(0, SO_USERS, SO_WARM),
              rng.integers(0, SO_ITEMS, SO_WARM),
              np.sort(rng.uniform(0, 10_000, SO_WARM)))
        for st in stores.values():
            st.ingest(*ev)
    users = rng.integers(0, SO_USERS, 2048)
    tb = [3e6]

    def events():
        ev = (rng.integers(0, SO_USERS, SO_E), rng.integers(0, SO_ITEMS, SO_E),
              np.sort(rng.uniform(0, 1.0, SO_E)) + tb[0])
        tb[0] += 1.0
        return ev

    def mixed_cycle(st, ev):
        t0 = time.perf_counter()
        st.ingest(*ev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rows = st.retrieve_batch(users, now, k)
        return t1 - t0, time.perf_counter() - t1, rows

    for r in range(4 + SO_ROUNDS):        # 4 warm rounds, folds included
        ev = events()
        got = {s: mixed_cycle(st, ev) for s, st in stores.items()}
        check(all(np.array_equal(got[s][2], got[1][2]) for s in got),
              f"8b round {r}: the stores' retrieved rows differ")
        if r == 4:
            samples = {s: [] for s in stores}
        if r >= 4:
            for s in stores:
                samples[s].append(got[s][:2])
    rows = {}
    for s in stores:
        rows[s] = dict(ingest_ms=min(a for a, _ in samples[s]) * 1e3,
                       retrieve_ms=min(b for _, b in samples[s]) * 1e3,
                       cycles_per_s=1.0 / min(a + b for a, b in samples[s]))
    for s, r in rows.items():
        print(f"[phase8b] shards {s}: ingest {r['ingest_ms']:.4f} ms, "
              f"retrieve {r['retrieve_ms']:.4f} ms, cycles/s "
              f"{r['cycles_per_s']:.4f}, scaling "
              f"{r['cycles_per_s'] / rows[1]['cycles_per_s']:.4f} vs 1 shard")
    print(f"[phase8b] C {SO_C}, Q {QUEUE_LEN}, delta_cap {P8_DELTA}, "
          f"{SO_USERS} users, {SO_ITEMS} items, {SO_E} events a cycle, "
          f"retrieve 2048 at k {k}; best of {SO_ROUNDS} interleaved rounds; "
          f"rows equal in every round")


def phase8_swap(seed: int, dev, p2: dict, batches, users, now: float
                ) -> None:
    """8c: a ``SwapServer(n_shards=P8_SHARDS, delta_cap=P8_DELTA)`` and an
    unsharded direct one on Phase 2's snapshot take the same events, then
    ``swap_to`` a version 2 built from perturbed embeddings; their swap
    accounting, served rows and versions must be equal."""
    cfg = CONFIG
    snap1 = p2["snap"]
    g = torch.Generator(device=dev).manual_seed(seed + 8)

    def perturb(e):
        return (e.float() + P8_NOISE * torch.randn(
            e.shape, generator=g, device=dev)).to(e.dtype)

    t = time.perf_counter()
    snap2 = build_snapshot(2, perturb(p2["user_emb"]),
                           perturb(p2["item_emb"]), p2["rq"], cfg,
                           i2i_k=I2I_K)
    build_s = time.perf_counter() - t
    moved = float((snap2.user_clusters != snap1.user_clusters).mean())
    check(moved > 0, "8c: no user changed cluster in version 2")
    events = batches[::P8_SWAP_EVERY]
    ring_ts = np.concatenate([ts for _, _, ts in events])
    fresh = int((ring_ts >= now - RECENCY_S).sum())
    out = {}
    for name, shards, delta in (("shards+delta", P8_SHARDS, P8_DELTA),
                                ("direct", 1, 0)):
        server = SwapServer(snap1, queue_len=QUEUE_LEN, recency_s=RECENCY_S,
                            ring_capacity=len(ring_ts), n_shards=shards,
                            delta_cap=delta, telemetry=Telemetry(),
                            device=dev)
        t = time.perf_counter()
        for ev in events:
            server.ingest(*ev)
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t
        rep = server.swap_to(snap2, now)
        rows, serve_s, launched = p8_serve(
            lambda u, now: server.serve_batch(u, now, n_recent=N_RECENT,
                                              k=K_UNION), users, now)
        got = server.retrieve_batch(users[0], now, K_UNION)
        check(rep["replayed_events"] == fresh
              and rep["dropped_stale"] == len(ring_ts) - fresh
              and rep["ring_dropped"] == 0,
              f"8c {name}: swap accounting {rep}, {fresh} of "
              f"{len(ring_ts)} ring events fresh")
        check({v for _, _, v in rows} == {2} and got[1] == 2,
              f"8c {name}: responses not all from version 2")
        check(launched == [shards] * len(users),
              f"8c {name}: queue_gather launches per serve {launched}")
        out[name] = (rows, got, rep)
        print(f"[phase8c] {name}: ingest {len(ring_ts)} events through the "
              f"ring {ingest_s:.4f} s; swap build_ms {rep['build_ms']:.4f}, "
              f"stall_ms {rep['stall_ms']:.4f}, replayed "
              f"{rep['replayed_events']:.0f}, stale "
              f"{rep['dropped_stale']:.0f}; serve p99 seconds "
              f"{[round(x, 5) for x in serve_s[:-1]]}, bulk "
              f"{serve_s[-1]:.5f} s")
        del server
        torch.cuda.empty_cache()
    (ra, ga, pa), (rb, gb, pb) = out.values()
    check(same_rows(ra, rb) and np.array_equal(ga[0], gb[0]),
          "8c: the sharded delta server's rows differ from the direct one's")
    print(f"[phase8c] version 2 (build_snapshot {build_s:.4f} s, noise "
          f"{P8_NOISE}) moves {moved:.4f} of the users' clusters; the two "
          f"servers' swap counts, served rows and versions are equal")


def phase8_chaos(seed: int, dev) -> None:
    """8d: ``run_chaos`` with ``default_specs()`` on the card; the four
    invariants, every required site, a crash and a recovery must hold.
    Its trace is rendered with ``repro_torch.obs.report``."""
    with tempfile.TemporaryDirectory() as d:
        trace = str(Path(d) / "chaos.jsonl")
        t = time.perf_counter()
        rep = run_chaos(seed, snapshot_dir=str(Path(d) / "snaps"),
                        cycles=P8_CHAOS_CYCLES, device=dev, trace_path=trace)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        text = render([trace])
    check(all(rep["invariants"].values()),
          f"8d: invariants {rep['invariants']}")
    missing = set(REQUIRED_SITES) - set(rep["sites_injected"])
    check(not missing, f"8d: sites never injected {sorted(missing)}")
    check(len(rep["injected"]) == len(default_specs()),
          f"8d: {len(rep['injected'])} injections")
    check(rep["crashes"] >= 1 and rep["recoveries"] >= 1,
          f"8d: crashes {rep['crashes']}, recoveries {rep['recoveries']}")
    print(f"[phase8d] run_chaos({seed}) on the card: {P8_CHAOS_CYCLES} "
          f"cycles in {wall:.4f} s; invariants "
          f"{json.dumps(rep['invariants'])}; injected "
          f"{[(r['site'], r['occurrence'], r['action']) for r in rep['injected']]}"
          f"; crashes {rep['crashes']}, recoveries {rep['recoveries']}; "
          f"served versions {rep['served_versions']}, recall "
          f"{json.dumps(rep['recall_by_served'])}")
    print(f"[phase8d] counters {json.dumps(rep['counters'])}")
    lines = text.splitlines()
    top = lines[lines.index("== span tree ==") + 1:][:P8_TREE_LINES]
    print("[phase8d] span tree (repro_torch.obs.report.render), top "
          f"{len(top)} lines:")
    for line in top:
        print(f"[phase8d]   {line}")


def phase8(seed: int, dev, p2: dict) -> dict:
    rng = np.random.default_rng(seed + 1)
    t = time.perf_counter()
    batches = list(event_batches(rng))           # Phase 2's stream
    rng8 = np.random.default_rng(seed + 8)
    users = [rng8.integers(0, N_USERS, P99_BATCH) for _ in range(P99_REPS)]
    bulk = rng8.integers(0, N_USERS, BULK_BATCH)
    bulk[:: 1009] = N_USERS + 5                  # post-snapshot ids
    users.append(bulk)
    now = T0 + SPAN_S
    print(f"[phase8] Phase 2's stream ({N_EVENTS} events) made again in "
          f"{time.perf_counter() - t:.2f} s")
    secs = {}
    torch.cuda.synchronize()
    common.reset_launches()                      # Phase 8's path starts
    for name, fn in (
            ("8a", lambda: phase8_stores(dev, p2["snap"], batches, users,
                                         now)),
            ("8b", lambda: phase8_scaleout(dev)),
            ("8c", lambda: phase8_swap(seed, dev, p2, batches, users, now)),
            ("8d", lambda: phase8_chaos(seed, dev))):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t
    launches = common.launch_counts()            # Phase 8's path ends
    print(f"[phase8] seconds {json.dumps({k_: round(v_, 4) for k_, v_ in secs.items()})}; "
          f"launches={launches}")
    return launches


def print_build(logs: dict) -> None:
    """Registers, spills and stack of every kernel ``nvcc`` built."""
    for kname, log in logs.items():
        fn = ""
        for line in log.splitlines():
            if "Function properties for" in line:
                fn = line.split("for", 1)[1].strip()
            elif "registers" in line or "spill" in line:
                print(f"[phase0] {kname} {fn}: {line.strip()}")


def phase0_contrastive() -> None:
    """The backward's dynamic shared memory from the library against the
    wrapper's own count (``FC.bwd_smem_bytes``), at the main shape in
    both types and at the plan's edges."""
    lib = ctypes.CDLL(str(common.library_path("fused_contrastive")))
    lib.fused_contrastive_bwd_smem.restype = ctypes.c_size_t
    lib.fused_contrastive_bwd_smem.argtypes = [ctypes.c_int] * 3
    N, d = CONFIG.n_negatives, CONFIG.d_embed
    f32, bf16 = torch.float32, torch.bfloat16
    shapes = ((N, d, bf16), (N, d, f32), (16, 24, bf16), (7, 100, f32),
              (224, 256, f32), (1, 1, bf16), (N, 1024, bf16),
              (N, 1032, bf16), (N, 512, f32), (1, FC.D_MAX, f32))
    out = []
    for N_, d_, dt in shapes:
        got = lib.fused_contrastive_bwd_smem(N_, d_, FC._DTYPE_CODE[dt])
        plan = FC.bwd_plan(N_, d_, dt)
        check(got == FC.bwd_smem_bytes(N_, d_, dt),
              f"fused_contrastive_bwd shared memory at N {N_} d {d_} "
              f"{dt}: the wrapper's {FC.bwd_smem_bytes(N_, d_, dt)} is "
              f"not the library's {got}")
        out.append(f"N {N_} d {d_} {str(dt).replace('torch.', '')}: "
                   f"{got} ({plan.path}, "
                   f"{plan.warps} warps)")
    print("[phase0] fused_contrastive_bwd dynamic shared memory bytes a "
          "block: " + ", ".join(out) + " (the first: the main path's)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--selection-sweep", type=int, default=0,
                    metavar="STEPS",
                    help="only run Phase 3's pipeline and STEPS more "
                         "train steps, printing the card-vs-CPU loss gap "
                         "at each state with the CPU on the card's RQ "
                         "selections and on its own")
    ap.add_argument("--contrastive-only", action="store_true",
                    help="only build fused_contrastive and run its Phase 1 "
                         "checks and timings")
    ap.add_argument("--attention-only", action="store_true",
                    help="only build flash_attention and run its Phase 1 "
                         "checks and timings, then print the whole op's "
                         "times and output hashes at decode_32k and "
                         "long_500k and the forced-split outputs' hashes")
    ap.add_argument("--decode-only", type=int, default=0, metavar="REPS",
                    help="only build flash_attention, print the whole op's "
                         "lines as --attention-only does, and run Phase 5's "
                         "decode_32k and long_500k steps, each timed REPS "
                         "times")
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
    if args.selection_sweep > 0:
        common.build(["rq_assign", "ppr_walk", "fused_contrastive"])
        selection_sweep(args.seed, dev, args.selection_sweep)
        return 0
    if args.contrastive_only:
        print_build(common.build(["fused_contrastive"]))
        phase1_fused_contrastive(torch.Generator(device=dev).manual_seed(
            args.seed), dev, peaks)
        return 0
    if args.attention_only:
        print_build(common.build(["flash_attention", "flash_attention_bwd"]))
        phase1_flash_attention(torch.Generator(device=dev).manual_seed(
            args.seed), dev, peaks)
        g = torch.Generator(device=dev).manual_seed(args.seed)
        attention_whole_op(g, dev)
        forced_split_hashes(g, dev)
        phase1_flash_attention_bwd(torch.Generator(device=dev).manual_seed(
            args.seed), dev, peaks)
        return 0
    if args.decode_only > 0:
        print_build(common.build(["flash_attention"]))
        decode_only(args.seed, dev, args.decode_only)
        return 0
    t = time.perf_counter()
    logs = common.build(["rq_assign", "queue_gather", "ppr_walk",
                         "fused_contrastive", "embedding_bag",
                         "flash_attention", "flash_attention_bwd"])
    print(f"[phase0] built {sorted(logs)} in "
          f"{time.perf_counter() - t:.2f} s")
    print_build(logs)
    rq_lib = ctypes.CDLL(str(common.library_path("rq_assign")))
    rq_lib.rq_assign_smem.restype = ctypes.c_size_t
    for d in (CONFIG.d_embed, RQA.D_MAX):
        check(rq_lib.rq_assign_smem(d) == RQA.smem_bytes(d),
              f"rq_assign shared memory at d {d}: the wrapper's "
              f"{RQA.smem_bytes(d)} is not the library's "
              f"{rq_lib.rq_assign_smem(d)}")
    print(f"[phase0] rq_assign dynamic shared memory bytes: "
          f"d {CONFIG.d_embed}: {RQA.smem_bytes(CONFIG.d_embed)}, "
          f"d {RQA.D_MAX} (the largest it takes): {RQA.smem_bytes(RQA.D_MAX)}")
    pw_lib = ctypes.CDLL(str(common.library_path("ppr_walk")))
    pw_lib.ppr_walk_smem.restype = ctypes.c_size_t
    traces = (CONFIG.ppr_walks * CONFIG.ppr_len, PW.MAX_TRACE)
    for S in traces:
        check(pw_lib.ppr_walk_smem(S) == PW.smem_bytes(S),
              f"ppr_walk shared memory at S {S}: the wrapper's "
              f"{PW.smem_bytes(S)} is not the library's "
              f"{pw_lib.ppr_walk_smem(S)}")
    print("[phase0] ppr_walk dynamic shared memory bytes: " + ", ".join(
        f"S {S}: {PW.smem_bytes(S)}" for S in traces)
        + " (the main path's trace, the largest it takes)")
    qg_lib = ctypes.CDLL(str(common.library_path("queue_gather")))
    qg_lib.queue_gather_smem.restype = ctypes.c_size_t
    qg_shapes = ((N_RECENT, K_UNION), (QG.MAX_R, QG.MAX_K))
    for R_, k_ in qg_shapes:
        check(qg_lib.queue_gather_smem(R_, k_) == QG.smem_bytes(R_, k_),
              f"queue_gather shared memory at R {R_} k {k_}: the wrapper's "
              f"{QG.smem_bytes(R_, k_)} is not the library's "
              f"{qg_lib.queue_gather_smem(R_, k_)}")
    print("[phase0] queue_gather dynamic shared memory bytes a block: "
          + ", ".join(f"R {R_} k {k_}: {QG.smem_bytes(R_, k_)}"
                      for R_, k_ in qg_shapes)
          + " (the main path's, the largest)")
    phase0_contrastive()
    fa_lib = ctypes.CDLL(str(common.library_path("flash_attention")))
    for kname, dec in (("tile (fa_wgmma at D 64-256, fa_mma at D 32)",
                        0), ("decode (fa_decode)", 1)):
        print(f"[phase0] flash_attention {kname} dynamic shared memory "
              f"bytes by head dim: " + ", ".join(
                  f"D {d}: {fa_lib.flash_attention_smem(dec, d)}"
                  for d in FA.HEAD_DIMS))
    bwd_lib = ctypes.CDLL(str(common.library_path("flash_attention_bwd")))
    for tname, bf in (("bf16", 1), ("f32", 0)):
        print(f"[phase0] flash_attention_bwd {tname} dynamic shared memory "
              f"bytes by head dim (dq pass, dkdv pass): " + ", ".join(
                  f"D {d}: {bwd_lib.flash_attention_bwd_smem(bf, 1, d)}, "
                  f"{bwd_lib.flash_attention_bwd_smem(bf, 2, d)}"
                  for d in FA.HEAD_DIMS))

    g = torch.Generator(device=dev).manual_seed(args.seed)
    rows = [phase1_rq_assign(g, dev, peaks), phase1_queue_gather(g, dev, peaks),
            phase1_ppr_walk(g, dev, peaks),
            *phase1_fused_contrastive(g, dev, peaks),
            *phase1_embedding_bag(g, dev, peaks)]
    rows += phase1_flash_attention(g, dev, peaks)
    rows += phase1_flash_attention_bwd(g, dev, peaks)
    t = time.perf_counter()
    launches, p2 = phase2(args.seed, dev)
    print(f"[phase2] wall {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    launches8 = phase8(args.seed, dev, p2)
    print(f"[phase8] wall {time.perf_counter() - t:.2f} s")
    del p2
    torch.cuda.empty_cache()
    launches3 = phase3(args.seed, dev)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    launches6, p6 = phase6(args.seed, dev)
    print(f"[phase6] wall {time.perf_counter() - t:.2f} s")
    torch.cuda.empty_cache()
    t = time.perf_counter()
    launches7 = phase7(args.seed, dev, p6)
    print(f"[phase7] wall {time.perf_counter() - t:.2f} s")
    del p6
    torch.cuda.empty_cache()
    t = time.perf_counter()
    launches4 = phase4(args.seed, dev)
    print(f"[phase4] wall {time.perf_counter() - t:.2f} s")
    torch.cuda.empty_cache()             # Phase 4's tables took 66.56 GB
    t = time.perf_counter()
    launches5 = phase5(args.seed, dev)
    print(f"[phase5] wall {time.perf_counter() - t:.2f} s")
    torch.cuda.empty_cache()
    t = time.perf_counter()
    launches9 = phase9(args.seed, dev)
    print(f"[phase9] wall {time.perf_counter() - t:.2f} s")
    for r in rows:     # each path's launches, Phases 6-9's added to its own
        counter = r.get("counter", r["name"])
        r["launches"] = (next((ls[counter] for ls in (
            {n: launches[n] for n in SLICE1}, launches4, launches5,
            launches3) if counter in ls), 0)
            + sum(ls.get(counter, 0)
                  for ls in (launches6, launches7, launches8, launches9)))
        check(r["launches"] > 0, f"{r['name']} was not launched on its "
              f"main path")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(smi)          # again here, where the end of a long output keeps it
    extra = ("device_ms",)       # where Phase 1 took it
    print(json.dumps({"kernels": [
        {**{k: r[k] for k in keys}, **{k: r[k] for k in extra if k in r}}
        for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
