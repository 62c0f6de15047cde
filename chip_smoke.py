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

Each path's launch counts are zeroed just before it runs and read just
after: ``rq_assign`` and ``queue_gather`` report Phase 2's,
``ppr_walk`` and ``fused_contrastive_*`` Phase 3's.

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
from repro_torch.lifecycle.publish import (build_snapshot,  # noqa: E402
                                           snapshot_health)
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
                         "fused_contrastive"])
    print(f"[phase0] built {sorted(logs)} in "
          f"{time.perf_counter() - t:.2f} s")
    for kname, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[phase0] {kname}: {line.strip()}")

    g = torch.Generator(device=dev).manual_seed(args.seed)
    rows = [phase1_rq_assign(g, dev, peaks), phase1_queue_gather(g, dev, peaks),
            phase1_ppr_walk(g, dev, peaks),
            *phase1_fused_contrastive(g, dev, peaks)]
    t = time.perf_counter()
    launches = phase2(args.seed, dev)
    print(f"[phase2] wall {time.perf_counter() - t:.2f} s")
    launches3 = phase3(args.seed, dev)
    for r in rows:
        r["launches"] = (launches[r["name"]] if r["name"] in SLICE1
                         else launches3[r["name"]])
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
