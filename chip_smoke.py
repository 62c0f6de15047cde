#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) once on one GPU.

    python3 chip_smoke.py [--seed 0]
    python3 chip_smoke.py --selection-sweep STEPS   # Phase 3's RQ check
    python3 chip_smoke.py --contrastive-only   # Phase 1's fused_contrastive
    python3 chip_smoke.py --attention-only     # Phase 1's flash_attention
    python3 chip_smoke.py --decode-only REPS   # Phase 5's decode steps
    python3 chip_smoke.py --lm-train-only      # Phase 10 alone
    python3 chip_smoke.py --kimi-train-only    # Phase 13 alone
    python3 chip_smoke.py --distributed-only   # Phase 11 on Phase 3's corpus
    python3 chip_smoke.py --lm-mesh-only       # Phase 12 alone
    python3 chip_smoke.py --tp-only            # Phase 14 on Phase 3's corpus
    python3 chip_smoke.py --tp2-only           # Phase 15 alone

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
``embedding_bag`` forward is also held with f32 out (the partial bags of
a row shard, Phase 11) on a (26e6/4, 64) shard, rounded once bitwise
its bf16 out, and the backward into that shard against its plain
version and a repeat.  The
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
``flash_attention_decode_lse`` (the decode kernel writing each row's
lse and its rows in f32, for the fold across ``kv_seq`` ranks) is held
against ``chunked_attention_ref(..., return_lse=True)`` at a rank's block
of decode_32k and long_500k over four ranks, at head dim 112 and at D
256 with one KV head, each at one split and at ``plan``'s, with a
``kv_len`` below T: the f32 rows within ``DECODE_LSE_OUT_TOL``, the lse
within ``DECODE_LSE_TOL``, a repeat bitwise, and the same launch with
both options off bitwise the rounding of its f32 rows; it prints the
route's time beside the bf16-only route's.
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
steps on the card against the CPU.  It prints the warm retrieval step
and its scoring (``dot_scores``), each beside the same with the plain
product ``u @ cvec.T``.

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

Phase 6 runs the hour-level refresh cycle at the same width on a log
of Phase 3's topic model at half its users and items (131,072 and
32,768; the refresh is host-bound and scales with the log, and the
whole script must fit its 1,200 s): ``build_graph(keep_state=True)``
and the device PPR tables on
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
from Phase 6's topic model (the same users' home topics, Poisson(2)
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

Phase 10 runs the rest of LM training and the MoE layers, each part's
bytes reckoned and printed before it runs.  10a: ``run_lm`` (the
launcher's loop: AdamW at 1e-3, ``block_q`` 32, no clipping) on the
card at ``_reduced`` olmo-1b, llama3.2-3b, gemma-2b and grok-1-314b (2
layers, d 128, head dim 32, f32, B 4 x S 64: ``flash_attention_f32``
with lse and the f32 backward pair), every step's loss within
``CARD_CPU_LM_REL`` of the port's own ``run_lm`` on the CPU from the
same parameters; the reduced kimi-k2 (top-8 of the 4 experts the cut
leaves) raises the reference's ``top_k`` error.  10b: first
``apply_leafwise`` bitwise against ``update`` + ``apply_updates`` (AdamW
and Adafactor, two steps, llama3.2-3b at Phase 9's 2 layers); then three
``lm_train_step``s (the train_4k cell's step: ``lm_loss``, clipping at
1.0, ``make_optimizer(cfg.optimizer)`` applied leaf by leaf) of
llama3.2-3b (28 layers) and gemma-2b (18) at full width and depth, B 1 x
S 4,096 (the cut of Phase 9), with the step split (forward, backward,
optimizer), peak memory beside the reckoning, the launches of each step
checked, the gradients finite and non-zero at step 0 and the losses
falling on the repeated batch.  10c: grok-1-314b at full width, 1 of
its 64 layers (d 6,144, 48 heads over 8, 8 experts top-2 at ff 32,768,
bf16 params), three ``lm_train_step``s with Adafactor at B 1 x S 4,096
(capacity 1,281 slots an expert), printing each step's slots per
expert, the share dropped and aux; the MoE block in bf16 against f32 on
the same input (the share of tokens whose expert choices differ; the
outputs of the others within ``P4_REL`` of the largest) and
``_moe_scatter`` against ``_moe_dense`` at a capacity that drops
nothing.  10d: kimi-k2-1t-a32b serving at full width, 1 of its 61
layers (d 7,168, 64 heads over 8 at head dim 112, 384 experts top-8 at
ff 2,048; 38.8 GB of bf16 params): a prefill of 4,096 tokens (the
tile kernel at D 112) and 16 greedy decode steps (the decode kernel at D
112, its splits folded), the decode logits within ``BF16_LM_TOL`` of
``forward``'s at the same positions.  Kimi at its 384 experts does not
train on one card (its gradients would double the 38.8 GB of params and
Adafactor's f32 temporaries of its 5.6 G-entry ``w_gate`` come on top):
Phase 13 trains it at 64.

Phase 13 runs kimi-k2-1t-a32b's training after Phase 10, through the
attention backward at head dim 112 (the D 128 kernels with the last 16
columns zero-filled).  13a: one layer at full width (d 7,168, 64 heads
over 8 at D 112, expert ff 2,048, top-8, capacity factor 1.25, vocab
163,840, bf16 params) with its 384 experts cut to 64 so that the step
fits the card (5.28 G params; the reckoning, printed first: bf16 params
and gradients 10.6 GB each, the clipped gradients in f32 21.1 GB,
``w_gate``'s two f32 Adafactor temporaries 7.5 GB, the logits 6.7 GB:
about 57 GB, 96 experts about 75 GB), and one sequence of train_4k's 256
(B 1 x S 4,096): three ``lm_train_step``s with Adafactor and clipping,
printing each step's loss and gradient norm, the step split, attention's
share in CUDA events, the expert loads and dropped slots, peak memory
and each step's launches (``flash_attention`` twice, each backward pass
once a layer: the kernels, not the plain version); then the same steps
from the same parameters with the plain attention
(``chunked_attention_ref``) in place of the kernels, the first loss
within ``P9_BF16_LOSS`` of the kernels' and the rest printed beside
theirs.  13b: card against
CPU at kimi's head shape on a cut width (2 layers, d 896: 8 heads over 1
at D 112, kimi's 8:1 grouping; 16 experts top-8 at ff 256, vocab 8,192,
S 1,024), f32: the loss and every gradient at the initial parameters by
Phase 9's rule (``close`` at ``CARD_CPU_LM_REL``), then three Adafactor
steps' losses and norms within ``CARD_CPU_LM_REL``; both sides on the
card's expert choices (ROADMAP's "Card repeatability"), each of the
CPU's own choices that differs a near tie of its probabilities; then
the three steps in kimi's own types (bf16), each loss printed against
the f32 CPU step's and the first within ``BF16_LM_TOL``.

Phase 11 runs the distributed paths last, in ranks that
``torch.multiprocessing.spawn`` starts (each uses the kernels the parent
built, joins the process group through a file, and must exit 0 within
``P11_TIMEOUT_S``).  11a: one rank, for which ``init_distributed``
picks NCCL, at mesh (1, 1): the rankgraph2 data-parallel step at 1,024
edges a type bitwise the plain step (deterministic algorithms on; the
plain step must first repeat bitwise), and ``_lookup_sharded`` at one
shard bitwise the local gather (65,536 x 26 ids on 26 x 100,000 x 64
f32, f32 and bf16).  Where the machine has four cards, 11b also runs on
NCCL, one rank a card.  11b: four ranks sharing the card, for which it
picks gloo; each first shows that gloo takes CUDA tensors in
``all_reduce``, ``all_gather`` and ``broadcast``.  At mesh (4,)
``("data",)``: three data-parallel rankgraph2 steps at full width on
Phase 3's corpus, against three steps of the global step run in the
parent with the same batches and draws, each side on its own RQ
selections, in f32 and bf16 at train_batch's own 10,922 edges a type,
which 4 does not divide: each rank keeps ``block_rows``, 2,731 rows and
the last 2,729, and the negatives are the reference's whole-batch
fallback, each rank gathering the whole batch's destination rows.  Both
sides run under torch's deterministic algorithms (``deterministic_sums``),
so each repeats itself and the readings below are the tree's, not the
run's.  In f32 the losses by
``f32_gap``, every row whose selection differs a near tie of the biased
selection under the global step's inputs, widened only by what the
histograms and codebooks that differ between the two sides can move
(``selection_ties``), and pool rows within 1e-4.  In bf16 the two sides'
selections part at near ties from step 1 on, and by step 2 their losses
lie up to four times Phase 3's bf16 tolerance apart, so both bf16 sides are
held against the f32 global step on the same batches and draws: at
every step and loss the data-parallel step may lie no farther from it
than the bf16 global step does, plus that tolerance at the f32 value
(``bf16_lead``); the gap between the two bf16 sides is printed; pool
rows within 5e-2 of the bf16 global step's.  In both,
every histogram row must be its step's selections' counts on each side
(so the histograms differ only where the selections do), and the probe
rows' ``assign_codes`` must agree but for near ties widened by the
codebooks' drift (``near_ties``).  At mesh (1, 4) ``("data",
"model")``: dlrm-rm2 with 26 x 1,000,000 x 64 f32 tables row-sharded,
65,536 serve logits bitwise the parent's one-process lookup, one
65,536-row step's table gradient rows within ``P11_TABLE_REL`` of the
local ones (and none elsewhere), then one ``recsys_train_step``.  Then,
at the same mesh, wide-deep, sasrec and bst at full width (wide-deep 40
fields at embed 32, MLP 1024-512-256; sasrec embed 50, seq 50, 2 blocks;
bst embed 32, seq 20, 8 heads, 8 profile fields) with 1,000,000 rows a
table and every row-sharded leaf (``row_sharded_leaves``) in rank
shards: 16,384 serve outputs (sasrec: the user representation) bitwise
the parent's, one train batch's gradient rows of every sharded leaf
within ``P11_TABLE_REL`` of the parent's one-process ones (none
elsewhere), and one ``recsys_train_step`` whose parameters (the rows
the batch reached, ``P11_SAMPLE_ROWS`` others, every other leaf whole)
are held by the f32 gap rule.  dlrm's multi-hot bags on row shards
(16,384 rows x 26 bags of 1..16 ids, as Phase 4's): a serve step of bags
(logits within ``P4_REL`` of the parent's), then the bag lookup, whose
output must be one rounding of the model group's f32 sum of
``embedding_bag_fwd``'s f32 partial bags; that sum within
``P11_BAG_REL`` of the one-process kernel's f32 bags; the bf16 entries
that differ after rounding counted, none more than one step apart but
where the f32 sum lies below the floor; and the shard's table gradient
(``embedding_bag_bwd`` into the shard, under a fixed cotangent) bitwise
the one-process kernel's rows where no row of a shard holds
``EB.PIECE`` ids (each row's terms then come in position order; else
within ``P11_TABLE_REL``; the line says which held), zero elsewhere.
Last, at mesh (2, 2) in the same world, sasrec's and dlrm's retrieval
step against 1,000,000 candidates (``RS_CAND``), the candidates split
over the data axis: the merged top 100 bitwise ``top_k`` of the ranks'
gathered block scores, every block score bitwise the parent's
one-process score and the merged top 100 the one-process step's (the
line prints the count and largest gap of block scores apart, and any id
in one top 100 only).  It prints the backend, the
world size, each rank's step seconds and peak memory; gloo stages CUDA
tensors through the host, so its times say nothing of NCCL.

Phase 12 runs the LM family under a mesh after Phase 11.  The parent
first computes its sides and frees the card: kimi-k2-1t-a32b at full
width, 1 of its 61 layers, all 384 experts (38.8 GB of bf16; the
experts drawn each from its own generator, seeded by seed, layer and
expert, so that a rank draws its 96 without a transfer), a prefill of
4,096 tokens with every MoE block as ``_moe_shard_map_plain`` at nm 4
(the ranks' dispatch in one process), then that MoE block alone under
grad on a random input and cotangent; and olmo-1b at full width and
depth, two one-process ``lm_train_step``s (AdamW) on B 4 x S 2,048.
Then four gloo ranks sharing the card (and four NCCL ranks, one a card,
where the machine has four cards) run 12a and 12b.  12a, mesh (1, 4),
its rules with the tensor-parallel names unmapped (``P12_TP_OFF``: the
check is the expert-parallel dispatch alone, Phase 14 holds the rest):
each rank holds 96 experts and the rest of the layer (about 13.4 GB),
prefills through ``_moe_shard_map`` (T_my 1,024, capacity 32, a send
buffer of 4 x 96 x 32 x 7,168 bf16) and the D 112 prefill kernel, then
runs the MoE block alone under grad (``moe_grads``: d x and d router in
full, each expert leaf's gradient by each expert's norm and 8 fixed
rows, one leaf at a time).  Held: the ranks' logits bitwise equal; the
last position's logits, the caches, the block's output, aux, d x, the
expert norms and rows bitwise the parent's (the same products on the
same slices), d router (the four slices' bf16 sums in another order)
within ``BF16_LM_TOL``.  12b, mesh (4, 1): olmo-1b's FSDP shards
(``shard_params`` of the same ``init_params``), two ``lm_train_step(ctx=)``s on the same
four sequences (one a rank).  Held: the ranks' losses and norms equal,
and within ``CARD_CPU_LM_REL`` (Phase 9's card-vs-CPU tolerance) of the
parent's; each step's launches (forward with lse, remat recompute, the
two backward passes, 16 each); after the first step every shard's gaps
to the parent's parameters' block by their distribution (median within
1e-6, at most 1% beyond 1e-4), and the shards tiling every parameter
once.  It prints the bytes reckoned, each rank's seconds and peaks, the
bytes a rank's gathers receive a step, with the note that gloo's times
say nothing of NCCL.

Phase 14 runs tensor parallelism over the model axis after Phase 11,
on its corpus.  The parent first computes each part's one-process side
on the card and frees it; then four gloo ranks sharing the card (and
four NCCL ranks, one a card, where the machine has four cards) run them
at mesh (1, 4).  14a: rankgraph2 at full width in f32 (each rank 256 of
the encoders' 1,024 hidden units and 1 of the 4 aggregator heads,
``shard_state``): ``embed_side`` and ``assign_codes`` of 512 and 16,384
users on the initial state (primaries within ``P14_F32_REL`` norm-wise,
codes equal but for near ties), then two steps of ``P14_ROWS`` edges a
type on the parent's batches and draws, both sides under
``deterministic_sums`` (losses by ``f32_gap``, every flipped selection
within ``selection_ties``, the replicated state bitwise equal on every
rank).  14b: olmo-1b at full width, 2 of 16 layers, B 1 x S 2,048,
under its train rules (tensor and sequence parallelism): two AdamW steps
in f32 compute, the second from the parent's parameters after its first
(losses, norms and each gradient within ``P14_F32_REL``, norm-wise over
the ranks' blocks), one bf16 step (loss within ``BF16_LM_TOL``), and one
decode step under the decode rules on 2,048 random cached positions,
each rank on its block of 512 (``shard_caches``; logits within
``BF16_LM_TOL``).  14c: llama3.2-3b and gemma-2b at 2
layers prefill 4,096 under the prefill rules (last logits within
``BF16_LM_TOL``, each rank's caches against its heads of the
one-process caches, 2 ``flash_attention`` launches a rank).  14d: one
grok-1-314b layer at full width (each rank 8,192 of every expert's
32,768 ff columns, drawn expert by expert) at S 1,024 through the dense
loop and S 512 through the scatter, the output within ``BF16_LM_TOL`` of
the one-process layer's.  It prints the bytes reckoned, the parent's
and each rank's seconds, with the note that gloo stages through the
host.

Phase 15 runs last: the recsys family's tensor parallelism and the
decode rules' sequence-sharded KV cache.  The parent first computes
each part's one-process side on the card and frees it; then four gloo
ranks sharing the card (and four NCCL ranks, one a card, where the
machine has four cards) run 15a-15c.  15a, at meshes (1, 4) and (2, 2)
under the default rules (``mlp``, ``heads`` and ``table_rows`` over
``model``): dlrm-rm2 (multi-hot bags through the ``embedding_bag``
kernels), wide-deep, sasrec and bst at full width on Phase 11's cut of
1,000,000 rows a table, ``P15A_ROWS`` rows a batch (half Phase 11's,
for the script's time), the MLPs split
by columns then rows, bst's heads over the model ranks, sasrec's one
head whole at (1, 4) and split within the head at (2, 2): in f32 compute
the serve outputs within ``P15_F32_REL`` of the largest, the loss within
``P15_F32_REL`` relative and each rank's block of every dense gradient
from its own ReLUs within ``P15_GRAD_REL`` norm-wise of the parent's
(a ReLU flip between two sum orders moves an earlier layer's gradient
by about 1e-3 at random labels) and, from a second pass in which every
ReLU takes the parent's mask (``relu_masks``: the rank's column block
of it where its input is split over the model axis), flip-free, within
``P15_GRAD_FLIPFREE`` (a wrong block, scale or sum reads 0.5 or more;
a ReLU applied to a partial sum shows in the first); in bf16
the serve
outputs within ``P15_BF16_OUT`` of the largest.  15b, decode_32k's rules
at (1, 4) (``kv_seq -> model``): llama3.2-3b and gemma-2b at full width,
2 layers, B 8, T 32,768, caches of N(0, 1) noise; 15c, long_500k's rules
at (2, 2) (``kv_seq -> ("data", "model")``, the batch whole): llama at
B 1, T 524,288.  Each at ``cache_len`` T - 1, T / 4 (the first position
of block 1) and T / 4 + 100 (blocks 2 and 3 hold no key): the logits
within ``BF16_LM_TOL`` of the parent's one-process ``decode_step`` and
bitwise equal on every rank, each rank's block after the step equal to
its block before it but at the new position, which one rank writes,
near the parent's new key and value, and one ``flash_attention_decode``
launch a layer on a rank whose block holds a key, none on the others.
It prints each rank's cache bytes, the fold's bytes a layer, the step
seconds and the peak memory, with the note that gloo stages through the
host.  ``--tp2-only`` builds ``embedding_bag`` and ``flash_attention``
and runs Phase 15 alone.

Phase 16 runs after Phase 14, on Phase 3's corpus: the rankgraph2
trainer's three batch layouts and the L' double draw at full width, f32,
on one batch of train_batch's ``P16_ROWS`` (10,922) edges a type drawn
from ``--seed``, each step from the same initial state with the same
negative draws, under ``deterministic_sums``.  16a: one step on the
``dedup_ids`` batch, one on the ``dedup`` batch of the same draw
(bitwise equal: losses and parameters) and one on the legacy layout
(``expand_batch`` of it: every endpoint encoded again; losses within
Phase 3's f32 tolerances, ``f32_gap``).  16b:
``reuse_lprime_negatives=False`` with each edge type's L' bank drawn
equal to the bank it reuses (every loss and ``grad_norm`` bitwise the
reusing step's, the parameters after the step within ``P16_SAME_GAP``:
the banks' gradients reach their rows through two gathers, not one),
then with distinct L' banks (every loss but ``rq_contrastive`` bitwise
unchanged, ``grad_norm`` moved).  16c: ``build_cell`` of the 40 cells at (16, 16) and (2, 16,
16) on an ``AbstractMesh`` allocates nothing on the card
(``torch.cuda.memory_allocated`` unchanged); it prints the build time.
The steps' ``fused_contrastive`` and ``rq_assign`` launches count in the
kernels line.  ``--layouts-only`` builds the three kernels, makes Phase
3's corpus and runs Phase 16 alone.

Each path's launch counts are zeroed just before it runs and read just
after: ``rq_assign`` and ``queue_gather`` report Phase 2's,
``ppr_walk`` and ``fused_contrastive_*`` Phase 3's, ``embedding_bag_*``
Phase 4's serve and train stages, ``flash_attention*`` Phase 5's serve
stages; Phase 6's launches of ``rq_assign``, ``ppr_walk`` and
``fused_contrastive_*``, Phase 7's of those and ``queue_gather``,
Phase 8's of ``queue_gather``, ``rq_assign`` and
``fused_contrastive_*``, Phase 9's main run's of ``flash_attention``
and ``flash_attention_bwd_*``, Phase 10's runs' (``run_lm``, the
train steps, kimi's prefill and decode; not its checks), Phase 13a's
steps and Phase 11's, Phase 12's, Phase 14's and Phase 15's ranks' (each
rank counts its own and returns them: 11b's ``embedding_bag_fwd`` and
``embedding_bag_bwd`` on row shards, its own checks' launches left out;
12a's prefill, 12b's steps; 14a's serve and steps, 14b's steps and
decode, 14c's prefills; 15a's bags, 15b's and 15c's decode steps) and
Phase 16's steps are added to those; the f32 kernels' come from
Phase 10a alone.  Every kernel in the list must have launched on its
path.

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
import math
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
from repro_torch.core.negatives import (negative_draws,  # noqa: E402
                                        shard_block_for)
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
from repro_torch.core.trainer import (FeatureStore,  # noqa: E402
                                      apply_grads, draw_keys, embed_all,
                                      forward_losses, init_state,
                                      loss_directions, make_eval_step,
                                      make_grad_step, make_train_step,
                                      named_params, reset_dead_codes,
                                      shard_state)
from repro_torch.data.edge_dataset import (EdgeDataset,  # noqa: E402
                                           NeighborTables,
                                           build_neighbor_tables,
                                           incremental_refresh)
from repro_torch.data.synthetic import SyntheticWorld  # noqa: E402
from repro_torch.faults import (REQUIRED_SITES,  # noqa: E402
                                default_specs, run_chaos)
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.embedding_bag import (  # noqa: E402
    embedding_bag as EB, ops as EB_OPS)
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
from repro_torch.launch import train as TRAIN  # noqa: E402
from repro_torch.distributed import collectives as COLL  # noqa: E402
from repro_torch.distributed.collectives import (  # noqa: E402
    block_rows, gather_rows)
from repro_torch.distributed.sharding import (ShardingCtx,  # noqa: E402
                                              make_rules, shard_of)
from repro_torch.launch.mesh import (  # noqa: E402
    abstract_production_mesh, init_distributed, make_mesh)
from repro_torch.launch.steps import (all_cells,  # noqa: E402
                                      build_cell, dot_scores,
                                      lm_decode_step, lm_loss_and_grads,
                                      lm_prefill_step,
                                      lm_rules, lm_train_step,
                                      loss_and_grads,
                                      recsys_retrieval_step,
                                      recsys_serve_step, recsys_train_step,
                                      retrieval_scores, top_k)
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
from repro_torch.optim import optimizers as OPT  # noqa: E402
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
# Phases 6 and 7: Phase 3's topic model at half its users and items (the
# refresh and the lifecycle cycles are host-bound and scale with the log;
# at Phase 3's size the two took 465 s of the script's 1,200 s)
P6_USERS, P6_ITEMS = P3_USERS // 2, P3_ITEMS // 2
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
GROK = get_arch("grok-1-314b").config   # MoE 8 experts top-2, bf16 params
KIMI = get_arch("kimi-k2-1t-a32b").config   # 384 experts top-8, head dim 112
P10_STEPS = 3                # run_lm's and lm_train_step's steps
P10A_ARCHS = ("olmo-1b", "llama3.2-3b", "gemma-2b", "grok-1-314b")
P10B_ARCHS = ("llama3.2-3b", "gemma-2b")
P10_B, P10_S = 1, 4096       # train_4k cut to one sequence, as Phase 9
P10_MOE_LAYERS = 1           # of grok's 64 and kimi's 61
P10_KIMI_S = 4096            # kimi's prefill
P13_EXPERTS = 64             # 13a: kimi's 384 experts cut to fit one card
P13_RECKON_EXPERTS = (64, 96, 384)   # the counts 13a's reckoning prints
P13B_CUT = dict(n_layers=2, d_model=896, n_heads=8, n_kv_heads=1,
                n_experts=16, moe_d_ff=256, d_ff=256, vocab_size=8192)
P13B_S = 1024                # 13b's sequence
ROUTE_TIE = 1e-5             # 13b: a flipped expert choice's probability gap
P11_WORLD = 4                # gloo ranks sharing the card (11b)
# 11b's edges per type: train_batch's own 10,922 (4 does not divide it:
# blocks of 2,731 rows, the last 2,729, whole-batch negatives)
P11_ROWS = CF_ROWS
P11_STEPS = 3
P11_DLRM = dataclasses.replace(DLRM, default_vocab=TRAIN_VOCAB)  # Phase 4's cut
P11_SERVE = 65_536           # serve requests against the row-sharded tables
P11_LOOKUP_VOCAB = 100_000   # 11a's lookup at nm 1: 26 x 100,000 x 64 f32
P11_TIMEOUT_S = 300.0        # each spawn's limit, seconds
P11_POOL_BF16 = 5e-2         # bf16 pool rows, largest gap
# f32 pool rows and parameters, by the distribution of their gaps (the
# optimizer-sign hazard; the CPU test's rule for the parameters)
P11_GAP_MEDIAN, P11_GAP_FAR, P11_GAP_FAR_SHARE = 1e-6, 1e-4, 0.01
P11_TABLE_REL = 1e-5         # table gradient rows: sharded vs local
# 11b's other recsys kinds, row-sharded at Phase 4's train cut, and
# dlrm's multi-hot bags on its row shards
P11_KINDS = ("wide-deep", "sasrec", "bst")
P11_KIND_ROWS = 16_384       # each kind's serve and train batch; the bags'
P11_SASREC_NEG = 20          # sasrec's negatives a row (the launcher's)
P11_SAMPLE_ROWS = 4096       # rows of a sharded leaf held after a step
P11_BAG_REL = 1e-5           # f32 partial-bag sums: sharded vs one process
P11_RETRIEVAL = ("sasrec", "dlrm-rm2")   # 11b's retrieval at mesh (2, 2)
P11_RETRIEVAL_MESH = (2, 2)
P12_WORLD = 4                # ranks (12a's model axis, 12b's data axis)
P12_KIMI_S = 4096            # 12a's prefill, B 1: T_my 1,024 a rank
P12_OLMO_B, P12_OLMO_S = 4, 2048   # 12b: one sequence a rank
P12_STEPS = 2                # 12b's AdamW steps
P12_SAMPLE = 8               # fixed rows of each expert's gradient held
P12_TIMEOUT_S = 300.0        # each spawn's limit, seconds
P12_GAP_MEDIAN, P12_GAP_FAR, P12_GAP_FAR_SHARE = 1e-6, 1e-4, 0.01
# 12a's rules without tensor parallelism, so that its check stays the
# expert-parallel dispatch against the one-process one, bitwise
P12_TP_OFF = {"heads": None, "kv_heads": None, "mlp": None, "vocab": None,
              "expert_mlp": None}
P14_WORLD = 4                # ranks sharing the card at mesh (1, 4)
P14_ROWS = 2048              # 14a's edges a type: at mesh (1, 4) every
# rank holds the whole batch, and four copies of 10,922 edges a type's
# f32 activations (about 20 GB each) do not fit one card; 4,096 fit
# (8.35 GB a rank) but kept the script past 900 s on a slow host
P14_STEPS = 2                # 14a's steps
P14_SERVE = (SHAPES["serve_p99"]["batch"], 16_384)   # serve_bulk cut
P14_OLMO_LAYERS, P14_OLMO_S = 2, 2048   # 14b: 2 of 16 layers, B 1
P14_DECODE_T = 2048          # 14b's decode step: cached positions
P14_PREFILL_ARCHS = ("llama3.2-3b", "gemma-2b")
P14_PREFILL_S = 4096         # 14c: B 1
P14_GROK_S = {"dense": 1024, "scatter": 512}   # 14d: B 1
P14_F32_REL = 1e-5           # f32 losses, norms, gradients, primaries
P14B_KERNELS = {"flash_attention", "flash_attention_bwd_dq",
                "flash_attention_bwd_dkdv", "flash_attention_f32",
                "flash_attention_bwd_f32_dq", "flash_attention_bwd_f32_dkdv",
                "flash_attention_decode"}
P14_TIMEOUT_S = 300.0        # the spawn's limit, seconds
P15_WORLD = 4                # gloo ranks sharing the card
P15_MESHES = ((1, 4), (2, 2))   # 15a's
P15_KINDS = ("dlrm-rm2", "wide-deep", "sasrec", "bst")
# 15a's batch, cut from Phase 11's 16,384 rows: a slow host ran the whole
# script in 1,006.6 s, past the 900 s it aims at, so Phase 15 shrank its
# own work (15a's ranks spend their time staging each split layer's
# 16,384-row partial sums through the host)
P15A_ROWS = P11_KIND_ROWS // 2
P15_F32_REL = 1e-5           # 15a f32: outputs (of the largest), loss
# 15a f32: each dense gradient block, norm-wise.  A ReLU whose input lies
# within rounding of zero flips between two sum orders, and at random
# labels the batch's gradient terms cancel, so one flip moves an earlier
# layer's gradient by about 1e-3 (a one-process reordering alone moves
# dlrm's bot.0.w by 5.7e-4 on the CPU: tests/test_torch_tp_recsys.py::
# test_reordered_sums_move_gradients_past_relus); a wrong block, scale or
# sum reads 0.5 or more
P15_GRAD_REL = 2.0 ** -6
# 15a f32: each dense gradient block, norm-wise, where both sides take the
# parent's ReLU masks (``relu_masks``): the flips gone, what is left is the
# order of the f32 sums
P15_GRAD_FLIPFREE = 1e-5
P15_BF16_OUT = 2.0 ** -5     # 15a bf16 serve outputs, of the largest
P15_DECODE_ARCHS = ("llama3.2-3b", "gemma-2b")   # 15b, decode_32k's rules
P15_LAYERS = 2
P15_DECODE_T = LM_SH["decode_32k"]["seq_len"]    # 32,768
P15_LONG_T = LM_SH["long_500k"]["seq_len"]       # 524,288, 15c at (2, 2)
P15_TIMEOUT_S = 300.0        # the spawn's limit, seconds
# Phase 11b's rules for the row-sharded kinds: the tensor-parallel names
# unmapped, so that its checks stay the row sharding against the one
# process, bitwise (Phase 15a holds the tensor parallelism)
P11_TP_OFF = {"mlp": None, "heads": None}
P16_ROWS = CF_ROWS           # train_batch's edges a type: 10,922
P16_SEED = 16                # Phase 16's batch and draws: --seed + this
# 16b, each L' bank the bank it reuses: the largest parameter gap to the
# reusing step after one step (7.89e-5 on the H100; a gradient whose sign
# flips moves an AdamW entry by twice the dense rate, 8e-3)
P16_SAME_GAP = 1e-3


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


def code_drift(books, books_k, codes, l: int, j: int) -> float:
    """How far a row's distance to code ``j`` of layer ``l`` can move
    between codebooks ``books`` and ``books_k`` (triangle inequality):
    the drift of the row's codes ``codes`` of the layers before ``l``
    (its residual's) plus code ``j``'s own."""
    return float(sum((books[m][int(codes[m])].double()
                      - books_k[m][int(codes[m])].double()).norm()
                     for m in range(l))
                 + (books[l][j].double() - books_k[l][j].double()).norm())


def near_ties(x, ck, cp, books, what: str, books_k=None) -> int:
    """Every row where codes ``ck`` differ from the plain version's
    ``cp`` must be a near-tie at its first differing layer: the two
    codes' squared distances to the residual (in f64, on ``books``)
    within ``NEAR_TIE * (1 + d2)``.  ``books_k``, the codebooks ``ck``
    came from where they are not ``books``, widens that by what their
    drift (``code_drift``: D for each of the two codes) can move the two
    squared distances, ``2 D sqrt(d2) + D^2`` each.  Returns the number
    of such rows."""
    near = 0
    for row in torch.nonzero(~(ck == cp).all(dim=1)).flatten().tolist():
        r = x[row].double()
        for l, C in enumerate(books):
            a, b = int(ck[row, l]), int(cp[row, l])
            if a != b:
                da = float(((r - C[a].double()) ** 2).sum())
                db = float(((r - C[b].double()) ** 2).sum())
                moved = 0.0
                if books_k is not None:
                    for j, d in ((a, da), (b, db)):
                        D = code_drift(books, books_k, ck[row], l, j)
                        moved += 2 * D * d ** 0.5 + D * D
                check(abs(da - db) <= NEAR_TIE * (1 + abs(db)) + moved,
                      f"rq_assign {what} row {row} layer {l}: code {a} "
                      f"(d2 {da}) vs plain {b} (d2 {db}) is not a near-tie"
                      f" (drift allowance {moved:.3g})")
                near += 1
                break
            r = r - C[a].double()
    return near


def book_drift(books_a, books_b) -> list:
    """The largest row distance between two sets of codebooks, a
    layer."""
    return [float((a.double() - b.double()).norm(dim=1).max())
            for a, b in zip(books_a, books_b)]


def selection_ties(h, ck, cp, books, books_k, tot_p, tot_k, rq,
                   what: str):
    """Every row where the data-parallel step's RQ selections ``ck``
    differ from the global step's ``cp`` must be a near-tie of the
    biased selection (Eq. 13: the argmax of ``s = zeta1 / (zeta2 +
    dist) - log phat``) at its first differing layer l.  Under the
    global step's inputs (rows ``h``, codebooks ``books``, histogram
    totals ``tot_p``, a layer; f64) the global choice a may lead the
    data-parallel choice b by at most ``NEAR_TIE * (1 + |s_a|)`` plus
    what the inputs that differ between the two sides can move the two
    scores: the gap of ``log phat`` between ``tot_p`` and the
    data-parallel side's ``tot_k`` at a and at b, and the drift of the
    codebooks ``books_k`` it started from (``code_drift``: D for each
    code, through the score's slope ``zeta1 / (zeta2 + dist - D)^2``).
    The rows themselves may differ only by rounding.  Returns the
    number of such rows and the largest lead over its allowance."""
    def log_phat(tot):      # rq_index._phat
        tot = tot.double().cpu()
        return torch.log((tot + 1e-6) / (tot.sum() + 1e-6 * tot.shape[0]))
    lp_p = [log_phat(x) for x in tot_p]
    lp_k = [log_phat(x) for x in tot_k]
    rows = torch.nonzero(~(ck == cp).all(dim=1)).flatten()
    books = [C.double().cpu() for C in books]
    books_k = [C.double().cpu() for C in books_k]
    hr = h[rows.to(h.device)].double().cpu()
    worst = 0.0
    for i, row in enumerate(rows.tolist()):
        r = hr[i]
        for l, C in enumerate(books):
            a, b = int(cp[row, l]), int(ck[row, l])
            if a != b:
                d2 = (r * r).sum() - 2.0 * (C[[a, b]] @ r) + \
                    (C[[a, b]] ** 2).sum(dim=1)
                dist = torch.sqrt(torch.clamp_min(d2, 0.0) + 1e-12)
                s = rq.zeta1 / (rq.zeta2 + dist) - lp_p[l][[a, b]]
                D = torch.tensor([code_drift(books, books_k, cp[row], l, j)
                                  for j in (a, b)], dtype=torch.float64)
                slope = rq.zeta1 / (rq.zeta2 + torch.clamp_min(dist - D,
                                                               0.0)) ** 2
                allow = (NEAR_TIE * (1 + abs(float(s[0])))
                         + float((lp_p[l][[a, b]] - lp_k[l][[a, b]]).abs()
                                 .sum()) + float((D * slope).sum()))
                lead = float(s[0] - s[1])
                worst = max(worst, lead / allow)
                check(lead <= allow, f"{what} row {row} layer {l}: the "
                      f"global choice {a} leads the data-parallel {b} by "
                      f"{lead:.4g} in the biased score, past {allow:.4g}")
                break
            r = r - C[a]
    return int(rows.numel()), worst


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
             peaks, out_bytes: int = 2) -> tuple:
    """(bound ms, what bounds it) of the main path's call on the (N, L)
    bags ``ids``: an f32 (V, D) table, bf16 compute, no weights (weights
    would add their read, the rows' read and the d_weights write).
    Forward: ids read once, each distinct valid row read once, the
    output written once (bf16, or ``out_bytes`` a value: 4 for the f32
    partial bags); a multiply and an add per valid element.
    Backward: ids and the bf16 cotangent read once, the dense f32 d_table
    written once; an add per valid element.  Operations at the FP32
    rate."""
    N, L = ids.shape
    valid = ids[ids >= 0]
    nbytes = 4.0 * N * L + (2.0 if backward else out_bytes) * N * D
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

    # (b'') the f32-out forward and the backward on a row shard, as Phase
    # 11's sharded bags run them on rank 0: a (26e6/4, 64) f32 shard, rows
    # rounded to bf16, 16,384 x 26 bags of 1..16 ids with the other ranks'
    # ids as padding
    v_loc = TRAIN_VOCAB // P11_WORLD
    shard = torch.empty((F_ * v_loc, D), device=dev).normal_(
        generator=g).mul_(0.01)
    ids = R._shard_bags(random_bags(g, P11_KIND_ROWS * F_, BAG, TRAIN_VOCAB,
                                    dev).view(P11_KIND_ROWS, F_, BAG),
                        0, v_loc, TRAIN_VOCAB)
    out32 = EB.embedding_bag_fwd(shard, ids, None, "sum", bf16, f32)
    p_err = held(out32, embedding_bag_ref(shard, ids, None, "sum", bf16,
                                          f32), f32, "f32-out fwd on a shard")
    check(torch.equal(out32.to(bf16), EB.embedding_bag_fwd(
        shard, ids, None, "sum", bf16)), "embedding_bag_fwd on a shard: its "
        "f32 out rounded once is not its bf16 out")
    del out32
    cot = (torch.randn((ids.shape[0], D), generator=g, device=dev)
           * 1e-3).to(bf16)
    dk, _ = EB.embedding_bag_bwd(cot, shard, ids, None, "sum", bf16)
    dp, _ = embedding_bag_bwd_ref(cot, shard, ids, None, "sum", bf16)
    q_err = held(dk, dp, bf16, "d_table into a shard")
    del dp
    eb_repeat(cot, shard, ids, dk, "into a shard")
    del dk, cot
    p_ms = time_ms(lambda: EB.embedding_bag_fwd(shard, ids, None, "sum", bf16,
                                                f32), 10)
    p_plain = time_ms(lambda: embedding_bag_ref(shard, ids, None, "sum",
                                                bf16, f32), 3)
    pb, pby = eb_bound(ids, D, F_ * v_loc, False, peaks, out_bytes=4)
    print(f"[phase1] embedding_bag fwd with f32 out (partial bags) on a row "
          f"shard ({F_ * v_loc}, {D}) f32, rows rounded to bf16: bags="
          f"{ids.shape[0]} L<={BAG} valid ids={int((ids >= 0).sum())} "
          f"max_abs_err={p_err:.3g} (f32 within 1e-5) kernel_ms={p_ms:.4f} "
          f"plain_ms={p_plain:.4f} bound_ms={pb:.4f} ({pby}); rounded once "
          f"bitwise its bf16 out; bwd into the shard max_abs_err="
          f"{q_err:.3g} (within one bf16 step), repeat bitwise equal")
    del shard, ids
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
    # kimi-k2's head dim 112 (Phase 10d): prefill 4,096, a decode step
    ("kimi_prefill_4k", 1, 4096, 64, 8, 4096, 112, True),
    ("kimi_decode_4k", 1, 1, 64, 8, 4096, 112, False),
)
FA_SMALL = (
    # tests/test_kernels.py's sweep (B, Hq, Hkv, S, T, D, causal), in the
    # (B, H, S, D) contract through strided views, plus D 256
    (2, 4, 2, 256, 256, 64, True), (1, 2, 2, 200, 200, 32, True),
    (2, 4, 1, 1, 300, 64, True), (1, 2, 2, 128, 256, 64, False),
    (1, 8, 8, 96, 96, 128, True), (1, 8, 1, 70, 333, 256, True),
    (1, 8, 1, 1, 2000, 256, True),           # gemma-like decode, split
    (1, 8, 2, 40, 40, 112, True),            # head dim 112: tile kernels
    (1, 8, 2, 1, 300, 112, True),            # ... and decode
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
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


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
    # head dim 112 (kimi-k2): the bf16 kernels on their 128 tiles with the
    # last 16 columns zero-filled, the f32 kernel as it is; ragged kv_len,
    # an offset and forced splits, folded at 112 columns
    for dtype, S, kernels in ((torch.float32, 5, ("flash_attention_f32",)),
                              (bf16, 2, ("flash_attention_decode",
                                         "flash_attention")),
                              (bf16, 50, ("flash_attention",))):
        q = torch.randn((3, S, 8, 112), generator=g, device=dev).to(dtype)
        k = torch.randn((3, 700, 2, 112), generator=g, device=dev).to(dtype)
        v = torch.randn((3, 700, 2, 112), generator=g, device=dev).to(dtype)
        tol = 3e-4 if dtype == torch.float32 else BF16_STEP
        kw = dict(causal=True, q_offset=600, kv_len=kvl, scale=112 ** -0.5)
        want = chunked_attention_ref(q, k, v, **kw)
        got, n = fa_launches(lambda: FA.flash_attention(q, k, v, **kw))
        what = f"head dim 112 ({dtype}, S {S})"
        check(got.shape == q.shape and close(got, want, tol),
              f"flash_attention at {what} off the plain version")
        check_fa_launches(n, planned(q, k, 700)[0], what)
        for kernel in kernels:
            for splits in (2, 5):
                (got, part), n = fa_launches(lambda: FA.flash_attention_split(
                    q, k, v, splits=splits, kernel=kernel,
                    rpt=4 if dtype == torch.float32 else None, **kw))
                check_fa_launches(n, kernel, f"{kernel} at {what}")
                check(part[2].shape[-1] == 112 and close(got, want, tol)
                      and close(got, merge_ref(*part, n_heads=8,
                                               dtype=torch.float32),
                                1e-5 if dtype == torch.float32
                                else BF16_STEP),
                      f"{kernel} at {what} with {splits} forced splits off "
                      f"the plain version or merge_ref of its partials")
    print("[phase1] flash_attention at head dim 112: f32 (flash_attention_f32)"
          " and bf16 (flash_attention_decode, flash_attention on the D 128 "
          "tiles) with ragged kv_len, an offset and 2 and 5 forced splits "
          "held against the plain version and merge_ref of their partials")

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


# flash_attention_decode_lse at a rank's block of a sequence-sharded cache
# (name, B, Hq, Hkv, T, D), each with kv_len T - 37
DECODE_LSE_SHAPES = (
    ("decode_32k_block", 8, 24, 8, 8192, 128),    # decode_32k, 4 kv_seq ranks
    ("long_500k_block", 1, 24, 8, 131072, 128),   # long_500k, 4 kv_seq ranks
    ("kimi_block", 1, 64, 8, 4096, 112),          # kimi-k2's head dim
    ("gemma_block", 8, 8, 1, 8192, 256),          # gemma-2b's MQA, D 256
)
# the f32 rows against the plain version's f32 rows: relative, with a
# floor at the same share of the largest magnitude (P carries 16 bits in
# the kernel's P.V, and the sums run in another order); the lse absolute
DECODE_LSE_OUT_TOL = 2.0 ** -12
DECODE_LSE_TOL = 1e-4


def phase1_decode_lse(g: torch.Generator, dev, peaks) -> dict:
    """``flash_attention_decode_lse`` (the decode kernel writing each
    row's lse and its rows in f32, for the fold across ``kv_seq`` ranks)
    against ``chunked_attention_ref(..., return_lse=True)`` on q in f32 at
    ``DECODE_LSE_SHAPES``, at one split and at ``plan``'s: the f32 rows
    within ``DECODE_LSE_OUT_TOL``, the lse within ``DECODE_LSE_TOL``, one
    ``flash_attention_decode`` launch, a repeat bitwise; the same launch
    with both options off (the serving route) bitwise the rounding of its
    f32 rows, and at ``plan``'s splits bitwise ``flash_attention``.  Times
    the route beside the bf16-only route at the decode_32k block.
    Returns its kernels-line row (its launches are
    ``flash_attention_decode``'s)."""
    bf16, f32 = torch.bfloat16, torch.float32
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    worst, out_row = 0.0, None
    for name, B, Hq, Hkv, T, D in DECODE_LSE_SHAPES:
        q = torch.randn((B, 1, Hq, D), generator=g, device=dev).to(bf16)
        k = torch.empty((B, T, Hkv, D), dtype=bf16, device=dev).normal_(
            generator=g)
        v = torch.empty((B, T, Hkv, D), dtype=bf16, device=dev).normal_(
            generator=g)
        kv_len, scale = T - 37, D ** -0.5
        want, want_lse = chunked_attention_ref(
            q.float(), k, v, causal=False, kv_len=kv_len, block_q=1,
            scale=scale, return_lse=True)
        want_lse = want_lse[..., 0]
        _, planned = FA.plan(B, 1, Hq, Hkv, kv_len, n_sm, D=D)
        errs = []
        for splits in sorted({1, planned}):
            def run():
                return FA.flash_attention_decode_lse(
                    q, k, v, kv_len=kv_len, scale=scale, splits=splits)
            (out, lse), n = fa_launches(run)
            what = f"flash_attention_decode_lse at {name}, {splits} splits"
            check(n == {"flash_attention_decode": 1}, f"{what}: launches {n}")
            check(out.dtype == f32 and out.shape == q.shape
                  and lse.shape == (B, Hq), f"{what}: {out.dtype} "
                  f"{tuple(out.shape)}, lse {tuple(lse.shape)}")
            err = float((out - want).abs().max())
            bound = DECODE_LSE_OUT_TOL * (want.abs() + want.abs().max())
            check(bool(((out - want).abs() <= bound).all()),
                  f"{what}: rows off the plain version ({err:.3g})")
            lerr = float((lse - want_lse).abs().max())
            check(lerr <= DECODE_LSE_TOL, f"{what}: lse {lerr:.3g} off")
            again = run()
            check(same_bits(again[0], out) and same_bits(again[1], lse),
                  f"{what}: a repeat differs")
            off = FA._fwd(q, k, v, FA._kv(kv_len, q, B, T), causal=False,
                          scale=scale, q_offset=0, kernel=FA.DECODE.name,
                          splits=splits)[0]
            check(same_bits(off, out.to(bf16)), f"{what}: the options-off "
                  f"output is not the rounding of the f32 rows")
            if splits == planned:
                pub = FA.flash_attention(q, k, v, causal=False, scale=scale,
                                         kv_len=kv_len)
                check(same_bits(pub, off), f"{what}: flash_attention's "
                      f"output differs from the options-off launch")
            errs.append((splits, err, lerr))
            worst = max(worst, err)
        print(f"[phase1] flash_attention_decode_lse {name}: q "
              f"{tuple(q.shape)} k/v {tuple(k.shape)} kv_len {kv_len}; "
              f"(splits, f32 rows max_abs_err, lse max_abs_err) {errs} "
              f"(limits {DECODE_LSE_OUT_TOL:.3g} relative, "
              f"{DECODE_LSE_TOL} absolute); repeats bitwise; the "
              f"options-off output bitwise the f32 rows rounded")
        if name == "decode_32k_block":
            kw = dict(kv_len=kv_len, scale=scale)
            ms = time_ms(lambda: FA.flash_attention_decode_lse(q, k, v, **kw),
                         20)
            dev_ms = time_ms(lambda: FA.flash_attention_decode_lse(
                q, k, v, **kw), 20, lead=True)
            off_ms = time_ms(lambda: FA.flash_attention(
                q, k, v, causal=False, **kw), 20)
            off_dev = time_ms(lambda: FA.flash_attention(
                q, k, v, causal=False, **kw), 20, lead=True)
            plain_ms = time_ms(lambda: chunked_attention_ref(
                q.float(), k, v, causal=False, block_q=1, return_lse=True,
                **kw), 2)
            ops = 4.0 * D * kv_len * B * Hq
            nbytes = (2.0 * B * Hq * D + 2 * 2.0 * B * kv_len * Hkv * D
                      + 4.0 * B * Hq * (D + 1))
            t_o, t_b = ops / peaks[2], nbytes / peaks[1]
            by = "operations" if t_o >= t_b else "bytes"
            print(f"[phase1] flash_attention_decode_lse at {name} "
                  f"(splits {planned}): kernel_ms={ms:.4f} device_ms="
                  f"{dev_ms:.4f}; the bf16-only route (flash_attention) "
                  f"kernel_ms={off_ms:.4f} device_ms={off_dev:.4f}; "
                  f"plain_ms={plain_ms:.4f} bound_ms="
                  f"{max(t_o, t_b) * 1e3:.5f} ({by}; {nbytes / 1e9:.4f} GB)")
            out_row = dict(name="flash_attention_decode_lse", route="cuda",
                           counter="flash_attention_decode",
                           source="src/repro_torch/csrc/flash_attention.cu",
                           replaces="src/repro/kernels/flash_attention/"
                           "flash_attention.py:91", ms=ms, plain_ms=plain_ms,
                           bound_ms=max(t_o, t_b) * 1e3, bound_by=by,
                           library_ms=None, device_ms=dev_ms)
        del q, k, v, want, want_lse
        torch.cuda.empty_cache()
    out_row["max_abs_err"] = worst
    return out_row


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
    # kimi-k2's head dim 112 (Phase 13) on the D 128 tiles, its 8:1 groups
    ("kimi-k2-1t-a32b", 1, 4096, 64, 8, 112, torch.bfloat16),
    ("ragged bf16 D 112", 2, 77, 8, 1, 112, torch.bfloat16),
    ("ragged f32 D 112", 1, 70, 8, 1, 112, torch.float32),
)
BWD_FORCED = ("olmo-1b", "kimi-k2-1t-a32b")   # fa_bwd_forced's rows
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
    # kimi-k2's head dim 112 under grad: the kernels, forward and backward
    q, k = t(32, 8, 112), t(32, 1, 112)
    (out, n) = fa_launches(lambda: FA.flash_attention(
        q, k, k, causal=True, scale=112 ** -0.5))
    check(type(out.grad_fn).__name__ == "FlashAttentionBackward"
          and n == {"flash_attention": 1}, f"head dim 112 under grad: "
          f"grad_fn {out.grad_fn}, launches {n}")
    _, n = fa_launches(lambda: out.backward(torch.ones_like(out)))
    check(n == {"flash_attention_bwd_dq": 1, "flash_attention_bwd_dkdv": 1},
          f"head dim 112's backward: launches {n}")
    print(f"[phase1] F1 guard on the card: {len(cases)} refused cases "
          f"raised naming the case; lm_loss's case returns an output "
          f"with grad_fn {type(out.grad_fn).__name__}, as does head dim 112, "
          f"whose backward launches the dq and dkdv passes")


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
    ``BWD_FORCED_SPLITS`` ranges a key tile too (``fa_bwd_forced``; also
    at kimi-k2's head dim 112);
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
        if name in BWD_FORCED:
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
        Dt = D if f32 else FA.bwd_tile_width(D)
        tiles = ""
        if Dt != D:      # the kernels' products run on the padded tiles
            t14, t10 = (attention_bwd_work(B, S, Hq, Hkv, Dt, esize, n)[0]
                        for n in (14, 10))
            tiles = (f"; on its {Dt}-wide tiles the design's 14 D "
                     f"{t14 / 1e12:.4f} TFLOP ({t14 / peak * 1e3:.4f} ms at "
                     f"the peak), the five products' 10 D {t10 / 1e12:.4f}")
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
              f"({design_ops / peak * 1e3:.4f} ms at the peak){tiles}; "
              f"plain_ms={plain_ms:.4f}; SDPA forward+backward "
              f"{both_ms} ms, backward {sdpa_bwd_ms} ms")
        out[name] = dict(err=max(c for _, _, c in errs.values()), ms=ms,
                         dev_ms=dev_ms, dq_ms=dq_ms, dkdv_ms=dkdv_ms,
                         dq_dev=dq_dev, dkdv_dev=dkdv_dev,
                         plain_ms=plain_ms, bounds=bounds, sdpa=both_ms,
                         sdpa_bwd=sdpa_bwd_ms, gaps=gaps)
        if name == "reduced":
            # run_lm's forward (Phase 10a): the training route at this shape
            fwd = lambda: FA.flash_attention_lse(q, k, v,  # noqa: E731
                                                 scale=scale)
            ops, nbytes = fa_work(B, S, Hq, Hkv, S, D, True, 4)
            t_o, t_b = ops / peaks[0], nbytes / peaks[1]
            lib_ms, _ = sdpa_library(q, k, v, True, scale, math=True)
            out["reduced_fwd"] = dict(
                err=float((o - o_ref).abs().max()), ms=time_ms(fwd, 50),
                dev_ms=time_ms(fwd, 50, lead=True),
                plain_ms=time_ms(lambda: chunked_attention_ref(
                    q, k, v, causal=True, scale=scale, return_lse=True), 5),
                bound=(max(t_o, t_b) * 1e3,
                       "operations" if t_o >= t_b else "bytes"),
                sdpa=lib_ms)
            r_ = out["reduced_fwd"]
            print(f"[phase1] flash_attention_f32 with lse at run_lm's shape "
                  f"(Phase 10a): max_abs_err={r_['err']:.3g} kernel_ms="
                  f"{r_['ms']:.4f} device_ms={r_['dev_ms']:.4f} plain_ms="
                  f"{r_['plain_ms']:.4f} sdpa_ms={lib_ms} (math backend "
                  f"allowed) bound_ms={r_['bound'][0]:.5f} "
                  f"({r_['bound'][1]} at the FP32 rate)")
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
                 device_ms=r["dkdv_dev"])] + f32_rows(out)


def f32_rows(out: dict) -> list:
    """The f32 kernels that ``run_lm`` launches (Phase 10a), at its shape
    (``FA_BWD_SHAPES``' "reduced"): the forward with lse and the backward
    pair, each with its own bound (FP32 rate)."""
    r, f = out["reduced"], out["reduced_fwd"]
    src = "src/repro_torch/csrc/flash_attention_bwd.cu"
    ref = "src/repro/models/lm/model.py:152"
    return [dict(name="flash_attention_f32", route="cuda",
                 source="src/repro_torch/csrc/flash_attention.cu",
                 replaces="src/repro/kernels/flash_attention/"
                          "flash_attention.py:91",
                 max_abs_err=f["err"], ms=f["ms"], plain_ms=f["plain_ms"],
                 bound_ms=f["bound"][0], bound_by=f["bound"][1],
                 library_ms=f["sdpa"], device_ms=f["dev_ms"])] + [
        dict(name=f"flash_attention_bwd_f32_{p}", route="cuda", source=src,
             replaces=ref, max_abs_err=r["err"], ms=r[f"{p}_ms"],
             plain_ms=r["plain_ms"], bound_ms=r["bounds"][b][0],
             bound_by=r["bounds"][b][1], library_ms=None,
             device_ms=r[f"{p}_dev"])
        for p, b in (("dq", "dq 6 D"), ("dkdv", "dkdv 8 D"))]


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

def topic_model(rng: np.random.Generator, nu: int = P3_USERS,
                ni: int = P3_ITEMS):
    """Phase 3's topic model over ``nu`` users and ``ni`` items, the first
    draws of ``default_rng(seed)``: each topic's items (a block of
    ``ni // N_TOPICS`` in a permutation, in popularity-rank order), the
    global popularity order, and each user's home topic."""
    topic_items = rng.permutation(ni)
    global_items = rng.permutation(ni)
    home = rng.integers(0, N_TOPICS, nu)
    return topic_items, global_items, home


def topic_events(rng: np.random.Generator, model, per_user: np.ndarray):
    """``per_user[u]`` events of each user: HOME_SHARE on items of the
    home topic, the rest on any item, both Zipf-1.1 by popularity; event
    types 0-3 with probabilities 0.7 / 0.15 / 0.1 / 0.05.  Returns
    (users, items, event types)."""
    topic_items, global_items, home = model
    ni = len(topic_items)
    per_topic = ni // N_TOPICS

    def zipf_cdf(n):
        p = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** 1.1
        return np.cumsum(p / p.sum())

    users = np.repeat(np.arange(len(per_user), dtype=np.int64), per_user)
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


def make_log_world(seed: int, nu: int = P3_USERS,
                   ni: int = P3_ITEMS) -> SyntheticWorld:
    """A topic-clustered engagement log of one day on ``nu`` users and
    ``ni`` items, made with numpy: each user has a home topic (N_TOPICS
    topics of equal item count) and Poisson(EVENTS_PER_USER) events
    (``topic_events``); timestamps over one day; standard-normal
    features."""
    rng = np.random.default_rng(seed)
    model = topic_model(rng, nu, ni)
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


def draws_for(cfg, pool, batch, rows: int, g: torch.Generator,
              shard_block: int = 0) -> dict:
    """Negative draws of every loss direction of ``batch`` from the CPU
    generator ``g``, to inject into a step on any device (in-batch rows
    inside blocks of ``shard_block``)."""
    fills = {"user": pool.user_fill, "item": pool.item_fill}
    return {dn: negative_draws(rows, cfg.n_heads, cfg.n_negatives,
                               cfg.n_pool_neg, fills[DST_TYPE[dn]],
                               generator=g, shard_block=shard_block)
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
    corpus = SimpleNamespace(tables=res.tables, graph=g,
                             user_feat=world.user_feat,
                             item_feat=world.item_feat)
    return launches, corpus


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
    scores = dot_scores(u, cvec).cpu()
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
    def product_step():
        """The one-process step with the plain product for its scoring
        (the step's formula before ``dot_scores``)."""
        e = R.take_rows(tab, torch.remainder(q["sparse"][0], tab.shape[0]))
        uu = torch.mean(e, dim=0, keepdim=True).to(torch.bfloat16)
        cv = R.take_rows(tab, torch.remainder(cand, tab.shape[0]), uu.dtype)
        return top_k((uu @ cv.T)[0], 100)

    # warm: the whole step and its scoring, each beside the plain product's
    checks["retrieval_ms"] = [time_ms(f, 10) for f in (
        lambda: recsys_retrieval_step(params, cfg, q, cand, k=100),
        product_step, lambda: dot_scores(u, cvec),
        lambda: (u @ cvec.T)[0])]
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
          f"scores in the top 100: {checks['retrieval_ties_in_top100']}; "
          f"warm ms: the step {checks['retrieval_ms'][0]:.4f} (scoring with "
          f"u @ cvec.T instead: {checks['retrieval_ms'][1]:.4f}), its "
          f"scoring (dot_scores) {checks['retrieval_ms'][2]:.4f}, u @ "
          f"cvec.T on the same rows {checks['retrieval_ms'][3]:.4f}")
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
# Phase 10: the rest of LM training, and the MoE layers
# ---------------------------------------------------------------------------

def cpu_tree(params) -> dict:
    """A CPU copy of an LM parameter tree."""
    def cp(x):
        return x.detach().to("cpu", copy=True)
    return {k: ([{n: cp(x) for n, x in lp.items()} for lp in v]
                if k == "layers" else cp(v)) for k, v in params.items()}


def add_counts(total: dict, more: dict) -> dict:
    for k, v in more.items():
        total[k] = total.get(k, 0) + v
    return total


def nonzero_launches() -> dict:
    return {k: v for k, v in common.launch_counts().items() if v}


def gb(n_bytes: float) -> str:
    return f"{n_bytes / 1e9:.3f} GB"


def train_steps(params, cfg, opt, st, toks, what: str, routes=None):
    """``P10_STEPS`` calls of ``lm_train_step`` (the entry point, as a user
    calls it) on the repeated batch ``toks``.  While they run, wrappers
    time ``lm_loss`` (the forward) and ``clip_by_global_norm_`` plus
    ``apply_leafwise`` (the optimizer) inside the step, each between two
    syncs (the backward is the rest of the step's host time after a
    sync), check at step 0 that every gradient is finite and not all zero
    (before clipping), and with ``routes`` (a list) record each
    ``_router`` call's per-expert slot counts and aux; the losses must
    be finite and fall below the first on the repeated batch (AdamW's
    first steps move every entry by about lr, so a later step may
    overshoot: it is printed, not held).  Returns (losses,
    gradient norms, (forward, backward, optimizer) seconds a step,
    launches a step, the optimizer state)."""
    sec, first = {}, [True]

    def timed(key, fn, before=None):
        def inner(*a, **k):
            if before is not None:
                before(*a)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            sec[key] = sec.get(key, 0.0) + time.perf_counter() - t0
            return out
        return inner

    def grads_held(grads, *_):
        if first[0]:
            first[0] = False
            for name, gr in grads.items():
                check(bool(torch.isfinite(gr).all())
                      and float(gr.abs().max()) > 0,
                      f"{what} step 0: gradient of {name} not finite or zero")

    def recorded(fn):
        def inner(p, c, xt, *a):
            gate, eid, aux = fn(p, c, xt, *a)
            routes.append((torch.bincount(eid.reshape(-1),
                                          minlength=c.n_experts).cpu(),
                           float(aux.detach())))
            return gate, eid, aux
        return inner

    orig = (LM.lm_loss, OPT.clip_by_global_norm_, OPT.apply_leafwise,
            LM._router)
    LM.lm_loss = timed("forward", orig[0])
    OPT.clip_by_global_norm_ = timed("optimizer", orig[1], grads_held)
    OPT.apply_leafwise = timed("optimizer", orig[2])
    if routes is not None:
        LM._router = recorded(orig[3])
    losses, norms, split, per_step = [], [], [], []
    try:
        for _ in range(P10_STEPS):
            sec.clear()
            before = common.launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, gnorm, st = lm_train_step(params, cfg, opt, st, toks)
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
            losses.append(float(loss))
            norms.append(float(gnorm))
            split.append((sec["forward"], total - sec["forward"]
                          - sec["optimizer"], sec["optimizer"]))
            per_step.append({k: n - before[k] for k, n in
                             common.launch_counts().items()
                             if n != before[k]})
    finally:
        (LM.lm_loss, OPT.clip_by_global_norm_, OPT.apply_leafwise,
         LM._router) = orig
    check(all(np.isfinite(losses)) and min(losses[1:]) < losses[0],
          f"{what}: losses {losses} do not fall below the first on the "
          f"repeated batch")
    return losses, norms, split, per_step, st


def step_summary(losses, norms, split) -> str:
    med = sorted(sum(s) for s in split)[len(split) // 2]
    return (f"losses {[round(x, 6) for x in losses]} (the repeated "
            f"batch), gradient norms before clipping "
            f"{[round(x, 4) for x in norms]}; step seconds (forward, "
            f"backward, optimizer) "
            f"{[tuple(round(x, 4) for x in s) for s in split]}, median step "
            f"{med:.4f} s ({P10_B * P10_S / med:.0f} tokens/s)")


def phase10a(dev) -> dict:
    """``run_lm`` on the card at ``_reduced`` olmo-1b, llama3.2-3b,
    gemma-2b and grok-1-314b (f32, B 4 x S 64, head dim 32: the f32
    attention kernels, with lse, and the f32 backward pair), each step's
    loss within ``CARD_CPU_LM_REL`` of the port's own ``run_lm`` on the
    CPU from the same parameters; the reduced kimi-k2 raises the
    reference's ``top_k`` error.  Returns the card runs' launches."""
    total = {}
    for arch in P10A_ARCHS:
        cfg = TRAIN._reduced(get_arch(arch).config)
        L = cfg.n_layers
        params = LM.init_params(cfg, generator=torch.Generator(
            dev).manual_seed(0), device=dev)
        host = cpu_tree(params)
        n_par = sum(p.numel() for p in LM.named_params(params).values())
        print(f"[phase10a] {arch} reduced: {gb(4 * n_par)} of f32 params, "
              f"{gb(4 * 4 * 4 * 64 * cfg.vocab_size)} of f32 logits a step")
        common.reset_launches()
        card = TRAIN.run_lm(cfg, P10_STEPS, device=dev, params=params)
        torch.cuda.synchronize()
        n = nonzero_launches()
        want = {"flash_attention_f32": 2 * L * P10_STEPS,
                "flash_attention_bwd_f32_dq": L * P10_STEPS,
                "flash_attention_bwd_f32_dkdv": L * P10_STEPS}
        check(n == want, f"run_lm {arch}: launches {n}, want {want} (the "
              f"forward with lse, the remat recompute, the backward pair)")
        add_counts(total, n)
        cpu = TRAIN.run_lm(cfg, P10_STEPS, device="cpu", params=host)
        gap = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
        check(gap <= CARD_CPU_LM_REL, f"run_lm {arch}: card {card} cpu "
              f"{cpu}, gap {gap:.3g}")
        print(f"[phase10a] run_lm {arch}: card losses {card}, CPU "
              f"{cpu}, largest gap {gap:.3g} relative (limit "
              f"{CARD_CPU_LM_REL}); launches {n}")
        del params, host
    try:
        TRAIN.run_lm(TRAIN._reduced(KIMI), 1, device=dev)
    except ValueError as e:
        check("top_k" in str(e) and f"k={KIMI.n_experts_per_tok}" in str(e),
              f"reduced kimi raised {e!r}")
        print(f"[phase10a] run_lm kimi-k2-1t-a32b reduced raises, as the "
              f"reference's jax.lax.top_k does: {e}")
    else:
        raise AssertionError("reduced kimi (top-8 of 4 experts) ran")
    torch.cuda.empty_cache()
    return total


def leafwise_held(seed: int, dev) -> str:
    """The leaf-by-leaf update (``apply_leafwise``) bitwise against the
    whole-dict one (``update`` then ``apply_updates``) on the card: two
    steps of AdamW and of Adafactor at Phase 9's check size (llama3.2-3b
    at full width, 2 layers, f32 params), random gradients."""
    cfg = dataclasses.replace(LLAMA, n_layers=P9_CHECK_LAYERS)
    out = []
    for name in ("adamw", "adafactor"):
        g = torch.Generator(dev).manual_seed(seed + 100)
        whole = LM.named_params(LM.init_params(cfg, generator=g, device=dev))
        leaf = {k: p.clone() for k, p in whole.items()}
        opt = OPT.make_optimizer(name)
        sw, sl = opt.init(whole), opt.init(leaf)
        for _ in range(2):
            grads = {k: torch.randn(p.shape, generator=g, device=dev)
                     .mul_(1e-3) for k, p in whole.items()}
            upd, sw = opt.update(grads, sw, whole)
            apply_updates(whole, upd)
            del upd
            sl = OPT.apply_leafwise(opt, dict(grads), sl, leaf)
            del grads
        same = all(same_bits(whole[k], leaf[k]) for k in whole)
        states = [(sw.mu, sl.mu), (sw.nu, sl.nu)] if name == "adamw" else \
            [(sw.vr, sl.vr), (sw.vc, sl.vc)]
        same = same and sw.count == sl.count == 2 and all(
            same_bits(a[k], b[k]) for a, b in states for k in a)
        check(same, f"apply_leafwise ({name}) differs from update + "
              f"apply_updates on the card")
        out.append(f"{name} ({len(whole)} leaves, "
                   f"{gb(4 * sum(p.numel() for p in whole.values()))})")
        del whole, leaf, sw, sl
        torch.cuda.empty_cache()
    return ", ".join(out)


def phase10b(seed: int, dev) -> dict:
    """llama3.2-3b (28 layers) and gemma-2b (18) at full width and depth:
    ``P10_STEPS`` ``lm_train_step``s with ``make_optimizer(cfg.optimizer)``
    (AdamW at 3e-4) and clipping at B 1 x S 4,096 (train_4k cut to one
    sequence, as Phase 9); first the leaf-by-leaf update held bitwise
    against the whole-dict one.  Returns the steps' launches."""
    print(f"[phase10b] apply_leafwise bitwise equal to update + "
          f"apply_updates, two steps each: {leafwise_held(seed, dev)}")
    total = {}
    for arch in P10B_ARCHS:
        cfg = get_arch(arch).config
        L, V = cfg.n_layers, cfg.vocab_size
        g = torch.Generator(dev).manual_seed(seed + 101)
        params = LM.init_params(cfg, generator=g, device=dev)
        flat = LM.named_params(params)
        n_par = sum(p.numel() for p in flat.values())
        check(n_par == cfg.n_params(), f"{arch}: {n_par} params, want "
              f"{cfg.n_params()}")
        opt = OPT.make_optimizer(cfg.optimizer)
        st = opt.init(flat)
        toks = lm_tokens(cfg, g, P10_B, P10_S, dev)
        big = max(p.numel() for p in flat.values())
        reckon = {"f32 params": 4 * n_par, "gradients": 4 * n_par,
                  "AdamW moments": 8 * n_par,
                  "logits (bf16, f32, f32 gradient)": 10 * P10_S * V,
                  "one leaf's update temporaries (4 f32 copies of the "
                  "largest)": 16 * big}
        print(f"[phase10b] {arch}: {L} layers, d {cfg.d_model}, "
              f"{cfg.n_heads} heads over {cfg.n_kv_heads} at D "
              f"{cfg.resolved_head_dim}, ff {cfg.d_ff}, vocab {V}; bytes "
              f"reckoned: " + ", ".join(f"{k} {gb(v)}"
                                        for k, v in reckon.items())
              + f"; sum {gb(sum(reckon.values()))}")
        torch.cuda.reset_peak_memory_stats()
        losses, norms, split, per_step, st = train_steps(
            params, cfg, opt, st, toks, arch)
        peak = torch.cuda.max_memory_allocated()
        want = {"flash_attention": 2 * L, "flash_attention_bwd_dq": L,
                "flash_attention_bwd_dkdv":
                    L if cfg.resolved_head_dim <= 128 else 2 * L}
        for i, n in enumerate(per_step):
            check(n == want, f"{arch} step {i}: launches {n}, want {want}")
            add_counts(total, n)
        check(peak < 80e9, f"{arch}: peak {gb(peak)}")
        print(f"[phase10b] {arch}: {step_summary(losses, norms, split)}; "
              f"peak device memory {gb(peak)}; launches a step {per_step[0]} "
              f"(forward with lse {L}, remat recompute {L}, the backward "
              f"passes)")
        del params, flat, st, opt
        torch.cuda.empty_cache()
    return total


def moe_loads(routes, cap: int, k: int) -> list:
    """(per-expert slots, share of slots dropped, aux) of each recorded
    router call."""
    out = []
    for counts, aux in routes:
        drop = int(torch.clamp_min(counts - cap, 0).sum())
        out.append((counts.tolist(), drop / int(counts.sum()), aux))
    return out


def phase10c(seed: int, dev) -> dict:
    """grok-1-314b at full width, 1 of its 64 layers, bf16 params:
    ``P10_STEPS`` ``lm_train_step``s with Adafactor and clipping at B 1 x
    S 4,096 (capacity 1,281 slots an expert); the MoE block in bf16
    against the same block in f32 on the same bf16 inputs (expert choices
    first; outputs on the tokens whose choices agree and whose slots both
    keep, within ``P4_REL`` of the largest); ``_moe_scatter`` against
    ``_moe_dense`` at a capacity that drops nothing.  Returns the steps'
    launches."""
    cfg = dataclasses.replace(GROK, n_layers=P10_MOE_LAYERS)
    T, E, k, d = P10_B * P10_S, cfg.n_experts, cfg.n_experts_per_tok, \
        cfg.d_model
    cap = LM.moe_capacity(cfg, T)
    check(cap == 1281, f"grok capacity {cap} at T {T}")
    g = torch.Generator(dev).manual_seed(seed + 102)
    params = LM.init_params(cfg, generator=g, device=dev)
    flat = LM.named_params(params)
    n_par = sum(p.numel() for p in flat.values())
    check(n_par == cfg.n_params() and all(
        p.dtype == torch.bfloat16 for p in flat.values()),
        f"grok: {n_par} params, want {cfg.n_params()} in bf16")
    opt = OPT.make_optimizer(cfg.optimizer)
    st = opt.init(flat)
    n_state = sum(t.numel() for part in (st.vr, st.vc) for t in part.values())
    toks = lm_tokens(cfg, g, P10_B, P10_S, dev)
    big = max(p.numel() for p in flat.values())
    reckon = {"bf16 params": 2 * n_par, "bf16 gradients": 2 * n_par,
              "clipped gradients (f32, the JAX package's promotion)":
                  4 * n_par,
              "Adafactor state (f32)": 4 * n_state,
              "one leaf's Adafactor temporaries (w_gate, 2 f32 copies)":
                  8 * big,
              "logits (bf16, f32, f32 gradient)": 10 * T * cfg.vocab_size}
    print(f"[phase10c] grok-1-314b: {P10_MOE_LAYERS} of 64 layers, d {d}, "
          f"{cfg.n_heads} heads over {cfg.n_kv_heads} at D "
          f"{cfg.resolved_head_dim}, {E} experts top-{k} at ff "
          f"{cfg.moe_d_ff}, vocab {cfg.vocab_size}, bf16 params ({n_par}); "
          f"capacity {cap} slots an expert of {T * k}; bytes reckoned: "
          + ", ".join(f"{k_} {gb(v)}" for k_, v in reckon.items())
          + f" (peak about params + clipped gradients + temporaries: "
          f"{gb(2 * n_par + 4 * n_par + 8 * big)})")
    torch.cuda.reset_peak_memory_stats()
    routes = []
    losses, norms, split, per_step, st = train_steps(
        params, cfg, opt, st, toks, "grok", routes=routes)
    peak = torch.cuda.max_memory_allocated()
    L = cfg.n_layers
    want = {"flash_attention": 2 * L, "flash_attention_bwd_dq": L,
            "flash_attention_bwd_dkdv": L}
    total = {}
    for i, n in enumerate(per_step):
        check(n == want, f"grok step {i}: launches {n}, want {want}")
        add_counts(total, n)
    # the router runs twice a step (forward, remat recompute): the first
    loads = moe_loads(routes[::2], cap, k)
    print(f"[phase10c] grok: {step_summary(losses, norms, split)}; peak "
          f"device memory {gb(peak)}; launches a step {per_step[0]}")
    for i, (counts, drop, aux) in enumerate(loads):
        print(f"[phase10c] grok step {i}: slots per expert {counts} "
              f"(capacity {cap}), share of slots dropped {drop:.6f}, aux "
              f"{aux:.6g}")
    del st, opt, flat
    torch.cuda.empty_cache()

    with torch.no_grad():
        lp = params["layers"][0]
        x = torch.randn((P10_B, P10_S, d), generator=g, device=dev
                        ).to(torch.bfloat16)
        xt = x.reshape(T, d)
        _, eb, _ = LM._router(lp, cfg, xt)
        _, ef, _ = LM._router(lp, cfg, xt.float())
        agree = (eb == ef).all(dim=-1)
        kept = [(LM._pos_in_group(e.reshape(-1)) < cap).reshape(T, k)
                .all(dim=-1) for e in (eb, ef)]
        sel = agree & kept[0] & kept[1]
        ob = LM._moe_block(lp, cfg, x)[0].reshape(T, d)
        of = LM._moe_block(lp, cfg, x.float())[0].reshape(T, d)
        e_bf = near(ob[sel], of[sel], P4_REL)
        check(e_bf <= 1, f"grok MoE block bf16 vs f32: {e_bf:.3g} of the "
              f"limit")
        del of
        wide = dataclasses.replace(cfg, capacity_factor=E / k)
        check(LM.moe_capacity(wide, T) > T, "no-drop capacity")
        o_sc = LM._moe_scatter(lp, wide, x)[0]
        o_de = LM._moe_dense(lp, wide, x)[0]
        e_sd = near(o_sc, o_de, P4_REL)
        check(e_sd <= 1, f"grok _moe_scatter vs _moe_dense: {e_sd:.3g} of "
              f"the limit")
    print(f"[phase10c] grok MoE block, bf16 against f32 on the same bf16 "
          f"input (B {P10_B} x S {P10_S}): expert choices differ for "
          f"{1 - float(agree.float().mean()):.6f} of the tokens; outputs "
          f"on the {int(sel.sum())} tokens that agree and keep every slot "
          f"in both: {e_bf:.3g} of the limit ({P4_REL} of the largest); "
          f"_moe_scatter at capacity {LM.moe_capacity(wide, T)} (drops "
          f"nothing) against _moe_dense: {e_sd:.3g} of the same limit")
    del params, lp, x, ob, o_sc, o_de
    torch.cuda.empty_cache()
    return total


def phase10d(seed: int, dev) -> dict:
    """kimi-k2-1t-a32b serving at full width, 1 of its 61 layers (head
    dim 112, 384 experts top-8 at ff 2,048; bf16 params): a prefill of
    ``P10_KIMI_S`` tokens at B 1 and ``GEN_STEPS`` greedy decode steps
    from its cache, the decode logits held against ``forward``'s at the
    same positions within ``BF16_LM_TOL``.  The decode step's one token
    never drops a slot (capacity 8 of its 8), while ``forward`` over the
    whole sequence at the config's capacity drops the last slots of the
    fullest experts first, the very positions compared; so the check's
    ``forward`` runs its MoE blocks as ``_moe_dense`` (every expert over
    every token: nothing dropped; 10c holds it equal to ``_moe_scatter``
    where nothing drops).  Kimi at its 384 experts does not train on one
    card (module docstring); Phase 13 trains it at 64.  Returns the serve
    stages' launches."""
    cfg = dataclasses.replace(KIMI, n_layers=P10_MOE_LAYERS)
    hd, S, E, k = cfg.resolved_head_dim, P10_KIMI_S, cfg.n_experts, \
        cfg.n_experts_per_tok
    check(hd == 112, f"kimi head dim {hd}")
    n_par = cfg.n_params()
    cap = LM.moe_capacity(cfg, S)
    print(f"[phase10d] kimi-k2-1t-a32b: {P10_MOE_LAYERS} of 61 layers, d "
          f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} at D "
          f"{hd}, {E} experts top-{k} at ff {cfg.moe_d_ff}, vocab "
          f"{cfg.vocab_size}; bytes reckoned: bf16 params {gb(2 * n_par)}, "
          f"its MoE dispatch buffer at the prefill ({E} x {cap} x "
          f"{cfg.d_model} bf16) {gb(2 * E * cap * cfg.d_model)}, the "
          f"forward check's bf16 logits "
          f"{gb(2 * (S + GEN_STEPS) * cfg.vocab_size)}; training would add "
          f"{gb(2 * n_par)} of bf16 gradients (then {gb(4 * n_par)} "
          f"clipped in f32) and an f32 leaf of "
          f"{gb(4 * E * cfg.d_model * cfg.moe_d_ff)}: past one card")
    g = torch.Generator(dev).manual_seed(seed + 103)
    t = time.perf_counter()
    params = LM.init_params(cfg, generator=g, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    n_bytes = sum(p.numel() * p.element_size()
                  for p in LM.named_params(params).values())
    check(n_bytes == 2 * n_par, f"kimi params {n_bytes} bytes")
    prompt = lm_tokens(cfg, g, 1, S, dev)
    routes = []
    orig = LM._router

    def recorded(p, c, xt, *a):
        gate, eid, aux = orig(p, c, xt, *a)
        routes.append(torch.bincount(eid.reshape(-1), minlength=E).cpu())
        return gate, eid, aux
    torch.cuda.reset_peak_memory_stats()
    common.reset_launches()
    LM._router = recorded
    try:
        t = time.perf_counter()
        last, caches = lm_prefill_step(params, cfg, prompt)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t
    finally:
        LM._router = orig
    n_pre = nonzero_launches()
    check(n_pre == {"flash_attention": P10_MOE_LAYERS}, f"kimi prefill: "
          f"launches {n_pre}")
    pre = routes[0]
    drop = float(torch.clamp_min(pre - cap, 0).sum()) / (S * k)
    gen = {n: torch.nn.functional.pad(c, (0, 0, 0, 0, 0, GEN_STEPS))
           for n, c in caches.items()}
    del caches
    tok = torch.argmax(last, dim=-1, keepdim=True)
    toks, dec, step_s = [tok], [], []
    common.reset_launches()
    with torch.no_grad():
        for i in range(GEN_STEPS):
            t = time.perf_counter()
            logits, gen = LM.decode_step(params, cfg, tok, gen, S + i)
            tok = torch.argmax(logits, dim=-1, keepdim=True)
            toks.append(tok)
            dec.append(logits)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
    n_dec = nonzero_launches()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    want = {}
    for i in range(GEN_STEPS):
        add_counts(want, fa_step_launches(cfg, 1, S + i + 1, n_sm))
    check(n_dec == want, f"kimi decode: launches {n_dec}, want {want}")
    peak = torch.cuda.max_memory_allocated()
    check(all(bool(torch.isfinite(x).all()) for x in dec + [last]),
          "kimi logits not finite")
    # the check: forward over the prompt and the generated tokens, its
    # MoE blocks dropping nothing
    block = LM._moe_block
    LM._moe_block = LM._moe_dense
    try:
        with torch.no_grad():
            full = LM.forward(params, cfg, torch.cat([prompt] + toks[:-1],
                                                     dim=1))
    finally:
        LM._moe_block = block
    gaps = [near(x, full[:, S + i], BF16_LM_TOL) for i, x in enumerate(dec)]
    check(max(gaps) <= 1, f"kimi decode vs forward: {max(gaps):.3g} of "
          f"{BF16_LM_TOL} of the largest")
    print(f"[phase10d] kimi: init {init_s:.2f} s; prefill {S} tokens "
          f"{prefill_s:.4f} s (capacity {cap} slots an expert: share of "
          f"slots dropped {drop:.6f}, the fullest expert {int(pre.max())}, the "
          f"emptiest {int(pre.min())}); {GEN_STEPS} greedy decode steps, tokens "
          f"{[int(x) for x in torch.cat(toks[1:], dim=1)[0].tolist()]}, "
          f"seconds per token {[round(x, 5) for x in step_s]}; peak device "
          f"memory {gb(peak)}; launches: prefill {n_pre}, decode {n_dec}; "
          f"decode logits vs forward's at the same positions (forward's "
          f"MoE as _moe_dense, nothing dropped): largest "
          f"{max(gaps):.3g} of {BF16_LM_TOL} of the largest")
    del params, gen, full, dec, last
    torch.cuda.empty_cache()
    return add_counts(n_pre, n_dec)


def phase10(seed: int, dev) -> dict:
    """The rest of LM training and the MoE layers (module docstring).
    Returns the main runs' launches (10a-10d)."""
    total = {}
    for part in (lambda: phase10a(dev), lambda: phase10b(seed, dev),
                 lambda: phase10c(seed, dev), lambda: phase10d(seed, dev)):
        t = time.perf_counter()
        add_counts(total, part())
        print(f"[phase10] part wall {time.perf_counter() - t:.2f} s")
    return total


# ---------------------------------------------------------------------------
# Phase 13: kimi-k2's training, the attention backward at head dim 112
# ---------------------------------------------------------------------------

def kimi_reckon(cfg) -> dict:
    """The bytes a one-layer kimi train step holds at its peak, leaf by
    leaf: bf16 params and gradients, the clipped gradients in f32 (the
    JAX package's promotion), ``w_gate``'s two f32 Adafactor temporaries
    (``apply_leafwise``'s one leaf at a time) and the logits (bf16, f32,
    f32 gradient) of B 1 x S 4,096."""
    n = cfg.n_params()
    big = cfg.n_experts * cfg.d_model * cfg.moe_d_ff
    return {"bf16 params": 2 * n, "bf16 gradients": 2 * n,
            "clipped gradients (f32)": 4 * n,
            "w_gate's two f32 Adafactor temporaries": 8 * big,
            "logits (bf16, f32, f32 gradient)":
                10 * P10_B * P10_S * cfg.vocab_size}


def phase13a(seed: int, dev) -> dict:
    """kimi-k2-1t-a32b at full width, 1 of its 61 layers, its 384 experts
    cut to ``P13_EXPERTS`` (the reckoning, printed first, says why):
    ``P10_STEPS`` ``lm_train_step``s with Adafactor and clipping at B 1 x
    S 4,096, the attention's backward on the D 128 tiles at head dim 112.
    Returns the steps' launches."""
    cfg = dataclasses.replace(KIMI, n_layers=P10_MOE_LAYERS,
                              n_experts=P13_EXPERTS)
    L, T, E, k = cfg.n_layers, P10_B * P10_S, cfg.n_experts, \
        cfg.n_experts_per_tok
    d, H, hd, V = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim, \
        cfg.vocab_size
    check(hd == 112 and H == 64 and cfg.n_kv_heads == 8,
          f"kimi heads {H} over {cfg.n_kv_heads} at D {hd}")
    cap = LM.moe_capacity(cfg, T)
    for n_e in P13_RECKON_EXPERTS:
        c = dataclasses.replace(cfg, n_experts=n_e)
        r = kimi_reckon(c)
        print(f"[phase13a] reckoning at {n_e} experts: {c.n_params() / 1e9:.3f} "
              f"G params ({2 * V * d / 1e9:.3f} G embedding and untied head, "
              f"{(d * H * hd * 2 + 2 * d * cfg.n_kv_heads * hd) / 1e9:.3f} G "
              f"attention, {3 * n_e * d * cfg.moe_d_ff / 1e9:.3f} G experts); "
              + ", ".join(f"{k_} {gb(v)}" for k_, v in r.items())
              + f"; sum {gb(sum(r.values()))} of the card's 80 GB")
    g = torch.Generator(dev).manual_seed(seed + 130)
    t = time.perf_counter()
    params = LM.init_params(cfg, generator=g, device=dev)
    flat = LM.named_params(params)
    n_par = sum(p.numel() for p in flat.values())
    check(n_par == cfg.n_params() and all(
        p.dtype == torch.bfloat16 for p in flat.values()),
        f"kimi: {n_par} params, want {cfg.n_params()} in bf16")
    opt = OPT.make_optimizer(cfg.optimizer)
    st = opt.init(flat)
    toks = lm_tokens(cfg, g, P10_B, P10_S, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    torch.cuda.reset_peak_memory_stats()
    routes = []
    losses, norms, split, per_step, st = train_steps(
        params, cfg, opt, st, toks, "kimi", routes=routes)
    peak = torch.cuda.max_memory_allocated()
    want = {"flash_attention": 2 * L, "flash_attention_bwd_dq": L,
            "flash_attention_bwd_dkdv": L}
    total = {}
    for i, n in enumerate(per_step):
        check(n == want, f"kimi step {i}: launches {n}, want {want} (the "
              f"forward with lse, the remat recompute, the backward passes "
              f"at D 112)")
        add_counts(total, n)
    check(peak < 80e9, f"kimi: peak {gb(peak)}")
    loads = moe_loads(routes[::2], cap, k)
    del st, opt, flat, params
    torch.cuda.empty_cache()
    # attention's own time at the step's shape, in CUDA events
    scale = hd ** -0.5
    q, do = (torch.randn((P10_B, P10_S, H, hd), generator=g, device=dev
                         ).to(torch.bfloat16) for _ in range(2))
    kk, vv = (torch.randn((P10_B, P10_S, cfg.n_kv_heads, hd), generator=g,
                          device=dev).to(torch.bfloat16) for _ in range(2))
    o, lse = FA.flash_attention_lse(q, kk, vv, scale=scale)
    f_ms = time_ms(lambda: FA.flash_attention_lse(q, kk, vv, scale=scale),
                   10, lead=True)
    b_ms = time_ms(lambda: FA.flash_attention_bwd(q, kk, vv, o, do, lse,
                                                  scale=scale), 10, lead=True)
    del q, kk, vv, do, o, lse
    torch.cuda.empty_cache()
    plain, plain_loads = kimi_plain_steps(cfg, seed, dev, toks, cap, k)
    del toks
    check(abs(plain[0] - losses[0]) <= P9_BF16_LOSS * abs(plain[0]),
          f"kimi step 0: loss {losses[0]} with the kernels, {plain[0]} with "
          f"the plain attention")
    attn = 2 * L * f_ms + L * b_ms
    med = sorted(sum(x) for x in split)[len(split) // 2]
    print(f"[phase13a] kimi-k2-1t-a32b: {L} of 61 layers, d {d}, {H} heads "
          f"over {cfg.n_kv_heads} at D {hd}, {E} experts (of 384) top-{k} at "
          f"ff {cfg.moe_d_ff}, capacity factor {cfg.capacity_factor} "
          f"({cap} slots an expert of {T * k}), vocab {V}, bf16 params "
          f"({n_par}), Adafactor, B {P10_B} x S {P10_S} (one sequence of "
          f"train_4k's 256); init {init_s:.2f} s")
    print(f"[phase13a] kimi: {step_summary(losses, norms, split)}; peak "
          f"device memory {gb(peak)} (reckoned "
          f"{gb(sum(kimi_reckon(cfg).values()))}); launches a step "
          f"{per_step[0]}; attention of a step (CUDA events, device time at "
          f"the step's shape): forward {f_ms:.4f} ms x {2 * L} + backward "
          f"{b_ms:.4f} ms x {L} = {attn:.2f} ms ({attn / 1e3 / med:.1%} of "
          f"the median step)")
    for i, (counts, drop, aux) in enumerate(loads):
        print(f"[phase13a] kimi step {i}: slots per expert {counts} "
              f"(capacity {cap}), share of slots dropped {drop:.6f}, aux "
              f"{aux:.6g}")
    print(f"[phase13a] kimi, the same steps from the same parameters with "
          f"the plain attention (chunked_attention_ref) in place of the "
          f"kernels: losses {[round(x, 6) for x in plain]} (kernels "
          f"{[round(x, 6) for x in losses]}; step 0 within {P9_BF16_LOSS} "
          f"relative), share of slots dropped each step "
          f"{[round(x[1], 6) for x in plain_loads]} (kernels "
          f"{[round(x[1], 6) for x in loads]})")
    return total


def kimi_plain_steps(cfg, seed: int, dev, toks, cap: int, k: int) -> tuple:
    """13a's steps from the same parameters (``init_params`` from the same
    seed) on the same tokens, with the plain attention
    (``chunked_attention_ref``) in place of the kernels and the MoE as
    it is: whether the losses' course comes from the model and its
    optimizer or from the attention kernels at head dim 112.  Returns the
    losses and ``moe_loads`` of the forward's router calls."""
    params = LM.init_params(cfg, generator=torch.Generator(dev).manual_seed(
        seed + 130), device=dev)
    opt = OPT.make_optimizer(cfg.optimizer)
    st = opt.init(LM.named_params(params))
    routes, orig = [], (LM.chunked_attention, LM._router)

    def recorded(p, c, xt, *a):
        gate, eid, aux = orig[1](p, c, xt, *a)
        routes.append((torch.bincount(eid.reshape(-1),
                                      minlength=c.n_experts).cpu(),
                       float(aux.detach())))
        return gate, eid, aux
    LM.chunked_attention, LM._router = chunked_attention_ref, recorded
    losses = []
    try:
        for _ in range(P10_STEPS):
            loss, _, st = lm_train_step(params, cfg, opt, st, toks)
            losses.append(float(loss))
    finally:
        LM.chunked_attention, LM._router = orig
    check(all(np.isfinite(losses)), f"kimi, plain attention: losses {losses}")
    del params, opt, st
    torch.cuda.empty_cache()
    return losses, moe_loads(routes[::2], cap, k)


def forced_routes(card_routes: list, cpu_routes: list, flips: list):
    """``LM._router`` taking, call by call, the card's recorded expert
    ids in place of its own (the gates from its own probabilities at
    those ids, renormalised as the router does); it records its own ids
    and, for each call, the tokens whose own ids differ with the largest
    gap of its probabilities between the two choices."""
    orig = LM._router

    def router(p, c, xt, *a):
        gate, eid, aux = orig(p, c, xt, *a)
        want = card_routes[len(cpu_routes)].to(eid.device)
        cpu_routes.append(eid.cpu())
        probs = torch.softmax((xt @ p["router"].to(xt.dtype)).to(
            torch.float32), dim=-1)
        diff = (want != eid).any(dim=-1)
        gap = 0.0
        if bool(diff.any()):
            p_ = probs[diff]
            gap = float((p_.gather(1, want[diff]) - p_.gather(1, eid[diff])
                         ).abs().max().detach())
        flips.append((int(diff.sum()), gap))
        g_ = probs.gather(1, want)
        g_ = g_ / torch.clamp_min(g_.sum(dim=-1, keepdim=True), 1e-9)
        return g_, want, aux
    return router


def phase13b(seed: int, dev) -> str:
    """Card against CPU at kimi's head shape on a cut width
    (``P13B_CUT``, S ``P13B_S``), f32: the loss and every gradient at the
    initial parameters by Phase 9's rule, then ``P10_STEPS`` Adafactor
    steps' losses and norms, the CPU on the card's expert choices (each
    of its own that differs a near tie, within ``ROUTE_TIE``); then the
    same steps in bf16, each loss printed against the f32 CPU step's and
    the first held within ``BF16_LM_TOL``.
    Returns the printed note."""
    base = dataclasses.replace(KIMI, **P13B_CUT)
    cfg = dataclasses.replace(base, dtype="float32", param_dtype="float32")
    check(cfg.resolved_head_dim == 112, f"13b head dim "
          f"{cfg.resolved_head_dim}")
    L = cfg.n_layers
    g = torch.Generator(dev).manual_seed(seed + 131)
    params = trainable(LM.init_params(cfg, generator=g, device=dev))
    host = trainable(cpu_tree(params))
    init = cpu_tree(params)
    toks = lm_tokens(cfg, g, 1, P13B_S, dev)
    card_routes, cpu_routes, flips = [], [], []
    orig = LM._router

    def recorded(p, c, xt, *a):
        gate, eid, aux = orig(p, c, xt, *a)
        card_routes.append(eid.cpu())
        return gate, eid, aux

    def run(prm, tk):
        loss, grads = lm_grads(prm, cfg, tk)
        opt = OPT.make_optimizer(cfg.optimizer)
        st = opt.init(LM.named_params(prm))
        steps = []
        for _ in range(P10_STEPS):
            loss_t, norm_t, st = lm_train_step(prm, cfg, opt, st, tk)
            steps.append((float(loss_t), float(norm_t)))
        return loss, grads, steps

    common.reset_launches()
    LM._router = recorded
    try:
        loss, grads, steps = run(params, toks)
        torch.cuda.synchronize()
    finally:
        LM._router = orig
    n = nonzero_launches()
    want = {"flash_attention_f32": 2 * L * (1 + P10_STEPS),
            "flash_attention_bwd_f32_dq": L * (1 + P10_STEPS),
            "flash_attention_bwd_f32_dkdv": L * (1 + P10_STEPS)}
    check(n == want, f"13b f32 card: launches {n}, want {want}")
    LM._router = forced_routes(card_routes, cpu_routes, flips)
    try:
        c_loss, c_grads, c_steps = run(host, toks.cpu())
    finally:
        LM._router = orig
    check(len(cpu_routes) == len(card_routes), f"13b router calls: card "
          f"{len(card_routes)}, cpu {len(cpu_routes)}")
    n_flip = sum(f for f, _ in flips)
    tie = max(x for _, x in flips)
    print(f"[phase13b] router calls (lm_grads, then each step: forward "
          f"and remat recompute a layer), the CPU's own choices that differ "
          f"from the card's and the largest probability gap: "
          f"{[(f, float(f'{x:.3g}')) for f, x in flips]}; losses and norms "
          f"card {steps}, cpu {c_steps}")
    check(tie <= ROUTE_TIE, f"13b: the CPU's own expert choices differ from "
          f"the card's by a probability gap of {tie:.3g} (near-tie limit "
          f"{ROUTE_TIE})")
    worst = abs(float(loss) - float(c_loss)) / (
        CARD_CPU_LM_REL * abs(float(c_loss)) + 1e-4 * abs(float(c_loss)))
    check(close(loss.cpu(), c_loss, CARD_CPU_LM_REL), f"13b f32 loss card "
          f"{float(loss)} cpu {float(c_loss)}")
    for name, gr in grads.items():
        b = c_grads[name]
        check(bool(torch.isfinite(gr).all()) and float(gr.abs().max()) > 0,
              f"13b f32 gradient of {name} not finite or zero")
        check(close(gr.cpu(), b, CARD_CPU_LM_REL), f"13b f32 gradient of "
              f"{name} off the CPU's "
              f"({float((gr.cpu() - b).abs().max()):.3g})")
        worst = max(worst, float(((gr.cpu() - b).abs() / (
            CARD_CPU_LM_REL * b.abs() + 1e-4 * b.abs().max()
        ).clamp_min(1e-30)).max()))
    step_gap = max(abs(a - b) / abs(b) for s_, c_ in zip(steps, c_steps)
                   for a, b in zip(s_, c_))
    check(step_gap <= CARD_CPU_LM_REL and all(np.isfinite(steps).ravel()),
          f"13b steps card {steps} cpu {c_steps}")
    del params, grads, c_grads, host
    # the steps in kimi's own types (bf16 params and compute) from the same
    # initial weights, against the f32 CPU ones (the first held)
    bf = {k_: ([{n_: x.to(dev, torch.bfloat16) for n_, x in lp.items()}
                for lp in v] if k_ == "layers" else v.to(dev, torch.bfloat16))
          for k_, v in init.items()}
    opt = OPT.make_optimizer(base.optimizer)
    st = opt.init(LM.named_params(bf))
    common.reset_launches()
    b_steps = []
    for _ in range(P10_STEPS):
        b_loss, b_norm, st = lm_train_step(bf, base, opt, st, toks)
        b_steps.append((float(b_loss), float(b_norm)))
    torch.cuda.synchronize()
    nb = nonzero_launches()
    want = {"flash_attention": 2 * L * P10_STEPS,
            "flash_attention_bwd_dq": L * P10_STEPS,
            "flash_attention_bwd_dkdv": L * P10_STEPS}
    check(nb == want, f"13b bf16 steps: launches {nb}, want {want}")
    b_gaps = [abs(b[0] - c[0]) / abs(c[0]) for b, c in zip(b_steps, c_steps)]
    check(b_gaps[0] <= BF16_LM_TOL and all(np.isfinite(b_steps).ravel()),
          f"13b bf16 losses {b_steps} against the f32 CPU's {c_steps}")
    del bf, st, opt
    torch.cuda.empty_cache()
    return (f"{L} layers, d {cfg.d_model}, {cfg.n_heads} heads over "
            f"{cfg.n_kv_heads} at D {cfg.resolved_head_dim}, "
            f"{cfg.n_experts} experts top-{cfg.n_experts_per_tok} at ff "
            f"{cfg.moe_d_ff}, vocab {cfg.vocab_size}, B 1 x S {P13B_S}, f32: "
            f"loss card {float(loss):.7f} cpu {float(c_loss):.7f}; loss and "
            f"every gradient at the initial parameters within "
            f"{worst:.3g} of Phase 9's tolerance ({CARD_CPU_LM_REL} relative "
            f"+ 1e-4 of the largest); {P10_STEPS} Adafactor steps' (loss, "
            f"norm) card {[tuple(round(x, 6) for x in s_) for s_ in steps]}, "
            f"cpu {[tuple(round(x, 6) for x in s_) for s_ in c_steps]}, "
            f"largest gap {step_gap:.3g} relative (limit {CARD_CPU_LM_REL}); "
            f"{len(card_routes)} router calls, the CPU's own expert choices "
            f"differing for {n_flip} tokens (largest probability gap "
            f"{tie:.3g}, limit {ROUTE_TIE}), both sides on the card's; "
            f"{P10_STEPS} bf16 steps (kimi's types, their own expert "
            f"choices) (loss, norm) "
            f"{[tuple(round(x, 6) for x in s_) for s_ in b_steps]}, each "
            f"loss {[float(f'{x:.3g}') for x in b_gaps]} relative from the "
            f"f32 CPU step's (limit {BF16_LM_TOL} at the first); launches "
            f"f32 {n}, bf16 {nb}")


def phase13(seed: int, dev) -> dict:
    """kimi-k2's training (module docstring).  Returns 13a's launches."""
    t = time.perf_counter()
    total = phase13a(seed, dev)
    print(f"[phase13] 13a wall {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    note = phase13b(seed, dev)
    print(f"[phase13b] {note}")
    print(f"[phase13] 13b wall {time.perf_counter() - t:.2f} s")
    return total


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
    world = make_log_world(seed, P6_USERS, P6_ITEMS)
    old, delta, merged, user_feat, item_feat, n_fresh = refresh_logs(
        world, seed)
    del world
    log_s = time.perf_counter() - t
    nu, ni, nu2, ni2 = old.n_users, old.n_items, delta.n_users, delta.n_items
    n2 = nu2 + ni2
    print(f"[phase6] logs (Phase 3's topic model at half its users and "
          f"items): old "
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
    """The next day's log, made with numpy from Phase 6's topic model:
    the same users' home topics (``topic_model`` of ``default_rng(seed)``
    at P6_USERS and P6_ITEMS) and a separate stream, ``default_rng((seed,
    7))``: Poisson(P7_EVENTS) events per user of Phase 6's log
    (``topic_events``), timestamps over
    the day after day 0, in time order, ids in the grown spaces.  Returns
    (the first P7_DELTA_S seconds: cycle 1's refresh delta and the live
    traffic; the rest: the gate's next-day ground truth)."""
    model = topic_model(np.random.default_rng(seed), P6_USERS, P6_ITEMS)
    rng = np.random.default_rng((seed, 7))
    users, items, etype = topic_events(rng, model,
                                       rng.poisson(P7_EVENTS, P6_USERS))
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


# ---------------------------------------------------------------------------
# Phase 11: the distributed paths on the card
# ---------------------------------------------------------------------------

def p11_to(tree, dev):
    """A tree of dicts and lists of tensors moved to ``dev``."""
    if isinstance(tree, dict):
        return {k: p11_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(p11_to(v, dev) for v in tree)
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def p11_state_hash(state) -> str:
    """The first 16 hex digits of a sha256 over a train state's
    parameters, pool and RQ state."""
    h = hashlib.sha256()
    for t in (*named_params(state.params).values(), state.pool.user,
              state.pool.item, *state.rq_state.hists, *state.rq_state.usage):
        h.update(t.detach().reshape(-1).view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()[:16]


def p11_gloo_cuda(rank: int, world: int, dev) -> None:
    """That this torch's gloo takes CUDA tensors in ``all_reduce``,
    ``all_gather`` and ``broadcast``, with the right values; raises
    naming the collective that does not."""
    import torch.distributed as dist

    def run(name, fn):
        try:
            fn()
            torch.cuda.synchronize()
        except Exception as e:          # name the collective, then fail
            raise RuntimeError(f"gloo does not take CUDA tensors in {name}: "
                               f"{type(e).__name__}: {e}") from e
    x = torch.full((8,), float(rank + 1), device=dev)
    run("all_reduce", lambda: dist.all_reduce(x))
    check(bool((x == world * (world + 1) // 2).all()),
          "gloo all_reduce on CUDA tensors: wrong sum")
    parts = [torch.empty(8, device=dev) for _ in range(world)]
    run("all_gather", lambda: dist.all_gather(
        parts, torch.full((8,), float(rank), device=dev)))
    check(all(bool((p == i).all()) for i, p in enumerate(parts)),
          "gloo all_gather on CUDA tensors: wrong parts")
    z = torch.full((8,), float(rank + 7), device=dev)
    run("broadcast", lambda: dist.broadcast(z, src=0))
    check(bool((z == 7).all()), "gloo broadcast on CUDA tensors: wrong value")


def p11a_checks(tmp: str, dev) -> dict:
    """11a on one NCCL rank, mesh (1, 1): the DP step bitwise the plain
    step (deterministic algorithms on, and the plain step first shown to
    repeat bitwise), and ``_lookup_sharded`` at nm 1 bitwise the local
    gather."""
    spec = torch.load(f"{tmp}/spec_rg.pt", weights_only=False)
    mesh = make_mesh((1, 1), ("data", "model"))
    ctx = ShardingCtx(make_rules(mesh), mesh)
    feats = FeatureStore(spec["user_feat"].to(dev), spec["item_feat"].to(dev))
    batch = p11_to(spec["check_batch"], dev)
    draws = p11_to(spec["check_draws"], dev)
    runs = []
    for c in (None, None, ctx):
        state, opt = init_state(CONFIG, generator=torch.Generator()
                                .manual_seed(spec["seed"]),
                                pool_size=P3_POOL, device=dev)
        step = make_train_step(CONFIG, opt, c, features=feats)
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, batch, draws=draws)
        torch.cuda.synchronize()
        runs.append(({k: float(v) for k, v in m.items()},
                     p11_state_hash(state), time.perf_counter() - t))
    check(runs[0][:2] == runs[1][:2], "11a: the plain step does not repeat "
          "bitwise under deterministic algorithms")
    check(runs[2][:2] == runs[0][:2], "11a: the DP step at mesh (1, 1) is "
          "not bitwise the plain step")
    g = torch.Generator(dev).manual_seed(spec["seed"] + 50)
    tables = torch.randn((DLRM.n_sparse, P11_LOOKUP_VOCAB, DLRM.embed_dim),
                         generator=g, device=dev)
    ids = torch.randint(0, P11_LOOKUP_VOCAB, (P11_SERVE, DLRM.n_sparse),
                        generator=g, device=dev, dtype=torch.int32)
    out = {}
    R._lookup_sharded(tables, ids[:8], ctx)       # NCCL's first call
    for dt in (torch.float32, torch.bfloat16):
        torch.cuda.synchronize()
        t = time.perf_counter()
        a = R._lookup_sharded(tables, ids, ctx, dt)
        torch.cuda.synchronize()
        out[str(dt).replace("torch.", "")] = time.perf_counter() - t
        check(torch.equal(a, R._lookup_local(tables, ids, dt)),
              f"11a: _lookup_sharded at nm 1 ({dt}) is not the local gather")
    return {"step_s": [r[2] for r in runs], "lookup_s": out,
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}


class deterministic_sums:
    """Torch's deterministic algorithms inside the block, the setting
    before it restored after.  11b's rankgraph2 sides run under it: with
    torch's CUDA scatter sums (the gathers' backward) free to reorder,
    a bf16 step's losses at step 2 moved by more than the bf16 tolerance
    from run to run, so ``bf16_lead`` read another value each run, once
    past its limit; under it each run reads the same.  The port's
    kernels and a one-stream cuBLAS repeat as they are."""

    def __enter__(self):
        self.was = (torch.are_deterministic_algorithms_enabled(),
                    torch.is_deterministic_algorithms_warn_only_enabled())
        torch.use_deterministic_algorithms(True, warn_only=True)
        return self

    def __exit__(self, *exc):
        torch.use_deterministic_algorithms(self.was[0],
                                           warn_only=self.was[1])
        return False


def p11_rankgraph2(tmp: str, world: int, dev) -> dict:
    """This rank's half of the rankgraph2 DP check: three steps at mesh
    (world,) in f32, then in bf16, from the seed's initial state on the
    parent's batches and draws, each on its own RQ selections (kept, with
    the histograms and codebooks each step starts from); then
    ``assign_codes`` (rq_assign) of the parent's probe rows with this
    rank's codebooks."""
    spec = torch.load(f"{tmp}/spec_rg.pt", weights_only=False)
    mesh = make_mesh((world,), ("data",))
    ctx = ShardingCtx(make_rules(mesh), mesh)
    feats = FeatureStore(spec["user_feat"].to(dev), spec["item_feat"].to(dev))
    lead = ctx.axis_index("data") == 0      # ships what every rank holds
    out = {}
    for tag, cfg in (("f32", dataclasses.replace(CONFIG, dtype="float32")),
                     ("bf16", CONFIG)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        state, opt = init_state(cfg, generator=torch.Generator().manual_seed(
            spec["seed"]), pool_size=P3_POOL, device=dev)
        grad_step = make_grad_step(cfg, ctx, features=feats)
        metrics, secs, codes, starts, first = [], [], [], [], None
        n_layers = len(cfg.rq.codebook_sizes)
        for t in range(P11_STEPS):
            batch = p11_to(spec["batches"][tag][t], dev)
            draws = p11_to(spec["draws"][tag][t], dev)
            if tag == "f32":
                starts.append(([h.sum(dim=0).cpu()
                                for h in state.rq_state.hists],
                               [b.detach().float().cpu() for b in
                                layer_books(state.params["rq"], n_layers)]))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sg = grad_step(state, batch, draws=draws)
            state, m = apply_grads(state, sg, opt)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            metrics.append({k: float(v) for k, v in m.items()})
            codes.append(sg.aux["codes"].cpu())
            del sg
            if t == 0 and lead:
                first = p11_params(state)
        probe = assign_codes(state.params["rq"], spec["probe"][tag].to(dev),
                             cfg.rq)
        out[tag] = dict(metrics=metrics, secs=secs,
                        peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                        hash=p11_state_hash(state),
                        hists=[h.cpu() for h in state.rq_state.hists],
                        usage=[u.cpu() for u in state.rq_state.usage],
                        pool=(state.pool.user.cpu(), state.pool.item.cpu()),
                        fills=(state.pool.user_fill, state.pool.item_fill),
                        codes=probe.cpu(), step_codes=codes,
                        starts=starts if lead else None,
                        books=[b.detach().float().cpu() for b in layer_books(
                            state.params["rq"], n_layers)],
                        params=p11_params(state) if lead else None,
                        params_first=first if lead else None)
        del state, grad_step
    return out


def p11_dlrm(tmp: str, world: int, dev) -> dict:
    """This rank's half of the row-sharded dlrm check at mesh (1, world):
    its rows of the tables drawn as the parent drew the whole ones, the
    serve logits bitwise the parent's, the table gradient rows it owns
    against the parent's local ones (and none elsewhere), then one
    ``recsys_train_step``."""
    spec = torch.load(f"{tmp}/spec_rs.pt", weights_only=False)
    mesh = make_mesh((1, world), ("data", "model"))
    ctx = ShardingCtx(make_rules(mesh, P11_TP_OFF), mesh)
    cfg = P11_DLRM
    V, D = cfg.default_vocab, cfg.embed_dim
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    params = R.dlrm_init(cfg, generator=torch.Generator(dev).manual_seed(
        spec["seed"] + 40), device=dev, ctx=ctx)
    rows = R.shard_rows(ctx, V)
    check(rows is not None and params["tables"].shape[1] == V // world,
          "11b: dlrm's tables are not row-sharded")
    serve = p11_to(spec["serve"], dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    logits = recsys_serve_step(params, cfg, serve, ctx)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t
    check(torch.equal(logits.cpu(), spec["logits"]),
          "11b: row-sharded serve logits are not bitwise the parent's")
    train = p11_to(spec["train"], dev)
    loss, grads = loss_and_grads(params, cfg, train, ctx)
    touched = spec["touched"]
    f, r = touched // V, touched % V
    own = (r >= rows.start) & (r < rows.stop)
    local = (f[own] * (V // world) + (r[own] - rows.start)).to(dev)
    gt = grads["tables"].reshape(-1, D)
    got, want = gt[local], spec["rows"][own].to(dev)
    gap = float(((got - want).abs() / (P11_TABLE_REL * want.abs()
                                       + 1e-4 * want.abs().max())).max())
    check(close(got, want, P11_TABLE_REL), f"11b: table gradient rows differ "
          f"from the local lookup's (worst {gap:.3g} of 1)")
    gt[local] = 0
    check(not bool(gt.any()), "11b: gradient outside the batch's rows")
    del grads, gt, got
    opt = rankgraph2_optimizer()
    st = opt.init(R.flatten_params(params))
    torch.cuda.synchronize()
    t = time.perf_counter()
    loss2, st = recsys_train_step(params, st, train, cfg, opt, ctx)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t
    check(bool(torch.isfinite(loss2)), "11b: non-finite dlrm loss")
    return dict(serve_s=serve_s, train_s=train_s, loss=float(loss),
                own_rows=int(own.sum()), rows=(rows.start, rows.stop),
                table_gap=gap,
                peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)


def p11_kind_cfg(arch: str):
    """An arch's config at Phase 4's train cut (``TRAIN_VOCAB`` rows a
    table), every width its own."""
    return dataclasses.replace(get_arch(arch).config,
                               default_vocab=TRAIN_VOCAB)


def p11_train_batch(cfg, g: torch.Generator, n: int, dev) -> dict:
    """``recsys_batch``'s train batch of ``n`` rows; sasrec's with a
    positive and ``P11_SASREC_NEG`` negatives a row."""
    b = recsys_batch(cfg, g, n, dev)
    if cfg.kind == "sasrec":
        V = cfg.default_vocab
        b["pos"] = torch.randint(0, V, (n,), generator=g, device=dev,
                                 dtype=torch.int32)
        b["neg"] = torch.randint(0, V, (n, P11_SASREC_NEG), generator=g,
                                 device=dev, dtype=torch.int32)
    return b


def leaf_rows(t: torch.Tensor) -> torch.Tensor:
    """A table (V, D) or a stack of them (F, V, D) as rows (F*V, D)."""
    return t.reshape(-1, t.shape[-1])


def own_rows(idx: torch.Tensor, V: int, rows: slice) -> tuple:
    """(mask, local rows): which of the whole rows ``idx`` of a leaf
    (``f * V + r``) lie in this rank's rows, and where in its shard."""
    f, r = idx // V, idx % V
    own = (r >= rows.start) & (r < rows.stop)
    return own, f[own] * (rows.stop - rows.start) + (r[own] - rows.start)


class uncounted:
    """Launches inside leave the kernels' counts as they were: the
    checks' own launches are not the main path's."""

    def __enter__(self):
        self.saved = common.launch_counts()

    def __exit__(self, *exc):
        for name, k in common.KERNELS.items():
            k.launches = self.saved.get(name, 0)


def p11_kind(tmp: str, world: int, dev, ctx, arch: str) -> dict:
    """This rank's half of a row-sharded kind's check at mesh (1, world):
    its rows of every row-sharded leaf drawn as the parent drew the whole
    ones, the serve outputs bitwise the parent's, the gradient rows it
    owns against the parent's (and none elsewhere), then one
    ``recsys_train_step`` and the parameters after it against the
    parent's step."""
    cfg = p11_kind_cfg(arch)
    spec = torch.load(f"{tmp}/spec_{cfg.kind}.pt", weights_only=False)
    V = cfg.default_vocab
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    params = R.init_params(cfg, generator=torch.Generator(dev).manual_seed(
        spec["seed"]), device=dev, ctx=ctx)
    leaves, rows = R.row_sharded_leaves(cfg, ctx), R.shard_rows(ctx, V)
    check(leaves == R.ROW_SHARDED[cfg.kind] and all(
        params[k].shape[-2] == V // world for k in leaves),
        f"11b: {arch}'s leaves {leaves} are not row-sharded")
    serve = p11_to(spec["serve"], dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = recsys_serve_step(params, cfg, serve, ctx)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t
    check(torch.equal(out.cpu(), spec["out"]),
          f"11b: {arch}'s row-sharded serve outputs are not bitwise the "
          f"parent's")
    train = p11_to(spec["train"], dev)
    loss, grads = loss_and_grads(params, cfg, train, ctx)
    check(float(loss) == spec["loss"], f"11b: {arch}'s loss {float(loss)} "
          f"vs the parent's {spec['loss']}")
    gaps, n_own = {}, 0
    for k in leaves:
        gk = leaf_rows(grads[k])
        own, local = own_rows(spec["touched"][k], V, rows)
        local = local.to(dev)
        got, want = gk[local], spec["rows"][k][own].to(dev)
        gaps[k] = float(((got - want).abs() / (
            P11_TABLE_REL * want.abs() + 1e-4 * want.abs().max())).max())
        check(close(got, want, P11_TABLE_REL), f"11b: {arch}'s {k} gradient "
              f"rows differ from the parent's (worst {gaps[k]:.3g} of 1)")
        gk[local] = 0
        check(not bool(gk.any()), f"11b: {arch}'s {k} gradient outside the "
              f"batch's rows")
        n_own += int(own.sum())
    del grads, gk, got, want
    opt = rankgraph2_optimizer()
    st = opt.init(R.flatten_params(params))
    torch.cuda.synchronize()
    t = time.perf_counter()
    loss2, st = recsys_train_step(params, st, train, cfg, opt, ctx)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t
    del st
    flat = R.flatten_params(params)
    after = {}
    for k, v in flat.items():
        if k in leaves:
            own, local = own_rows(spec["sample"][k], V, rows)
            after[k] = p11_gaps([leaf_rows(v.detach())[local.to(dev)]],
                                [spec["after"][k][own]])
        else:
            after[k] = p11_gaps([v.detach()], [spec["after"][k]])
    worst = tuple(max(g[i] for g in after.values()) for i in range(3))
    check(worst[0] <= P11_GAP_MEDIAN and worst[1] <= P11_GAP_FAR_SHARE,
          f"11b: {arch}'s parameters after a step: median {worst[0]:.3g}, "
          f"share beyond {P11_GAP_FAR} {worst[1]:.3g}")
    return dict(serve_s=serve_s, train_s=train_s, loss=float(loss2),
                own_rows=n_own, table_gap=max(gaps.values()), after=worst,
                peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)


def p11_bags(tmp: str, world: int, dev, ctx) -> dict:
    """This rank's half of dlrm's multi-hot bags on row shards at mesh
    (1, world): a serve step of bags (its logits near the parent's), then
    the bag lookup under a fixed cotangent.  Held: the bags are one
    rounding of the model group's f32 sum of partial bags, which lies
    within ``P11_BAG_REL`` of the one-process kernel's f32 bags; the
    entries that differ after rounding, by at most one bf16 step unless
    their f32 sums sit below the floor; the shard's table gradient
    bitwise the one-process kernel's rows where no row of the shard holds
    ``EB.PIECE`` ids (each row's terms then come in position order), else
    within ``P11_TABLE_REL``, and zero outside the batch's rows."""
    import torch.distributed as dist
    spec = torch.load(f"{tmp}/spec_bags.pt", weights_only=False)
    mine = torch.load(f"{tmp}/spec_bags-{ctx.axis_index('model')}.pt",
                      weights_only=False)
    cfg = P11_DLRM
    V, D, F_ = cfg.default_vocab, cfg.embed_dim, cfg.n_sparse
    bf16 = torch.bfloat16
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    params = R.dlrm_init(cfg, generator=torch.Generator(dev).manual_seed(
        spec["seed"]), device=dev, ctx=ctx)
    rows = R.shard_rows(ctx, V)
    batch = p11_to(spec["batch"], dev)
    ids = batch["sparse"]
    torch.cuda.synchronize()
    t = time.perf_counter()
    logits = recsys_serve_step(params, cfg, batch, ctx)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t
    want_l = spec["logits"].to(dev).float()
    logit_gap = float((logits.float() - want_l).abs().max()
                      / want_l.abs().max())
    check(bool(torch.isfinite(logits).all()) and logit_gap <= P4_REL,
          f"11b: dlrm bag logits {logit_gap:.3g} of the largest from the "
          f"parent's")
    shard = params["tables"].detach().requires_grad_(True)
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = R._bag_lookup(shard, ids, bf16, ctx, V)
    out.backward(spec["cot"].to(dev).view_as(out))
    torch.cuda.synchronize()
    bag_s = time.perf_counter() - t
    v_loc = V // world
    with uncounted():       # the model group's f32 sum, as the op forms it
        part = EB_OPS.embedding_bag_partials(
            shard.detach().reshape(-1, D),
            R._shard_bags(ids, ctx.axis_index("model"), v_loc, V), bf16)
        dist.all_reduce(part, group=ctx.group("model"))
    out = out.detach().reshape(-1, D)
    check(torch.equal(part.to(bf16), out), "11b: the sharded bags are not "
          "one rounding of the model group's f32 sum")
    want32 = spec["bags32"].to(dev)
    bag_gap = float(((part - want32).abs() / (
        P11_BAG_REL * want32.abs() + 1e-4 * want32.abs().max())).max())
    check(close(part, want32, P11_BAG_REL), f"11b: f32 bags {bag_gap:.3g} "
          f"of the tolerance from the one-process kernel's")
    want16 = want32.to(bf16)
    diff = out != want16
    a16, b16 = out.view(torch.int16).int(), want16.view(torch.int16).int()
    far = diff & (((a16 < 0) != (b16 < 0)) | ((a16 - b16).abs() > 1))
    floor = 1e-4 * float(want32.abs().max())
    check(bool((want32[far].abs() <= floor).all()), "11b: a bf16 bag more "
          "than one step from the one-process one above the floor")
    # the shard's table gradient against the one-process kernel's rows
    dtab = leaf_rows(shard.grad)
    own_ids = R._shard_bags(ids, ctx.axis_index("model"), v_loc, V)
    counts = torch.bincount(own_ids[own_ids >= 0].long(),
                            minlength=F_ * v_loc)
    most = int(counts.max())
    local = mine["local"].to(dev)
    got, want = dtab[local], mine["rows"].to(dev).float()
    bitwise = most < EB.PIECE
    grad_gap = float(((got - want).abs() / (
        P11_TABLE_REL * want.abs() + 1e-4 * want.abs().max())).max())
    check(torch.equal(got, want) if bitwise else close(got, want,
                                                       P11_TABLE_REL),
          f"11b: the shard's bag gradient rows differ from the one-process "
          f"kernel's ({'bitwise' if bitwise else grad_gap})")
    dtab[local] = 0
    check(not bool(dtab.any()), "11b: bag gradient outside the batch's rows")
    return dict(serve_s=serve_s, bag_s=bag_s, logit_gap=logit_gap,
                bag_gap=bag_gap, differ=int(diff.sum()), far=int(far.sum()),
                entries=out.numel(), most=most, bitwise=bitwise,
                grad_gap=grad_gap, own_rows=int(local.numel()),
                peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)


def p11_retrieval(tmp: str, world: int, dev) -> dict:
    """This rank's half of the sharded retrieval at mesh
    ``P11_RETRIEVAL_MESH``: sasrec's and dlrm's step against
    ``RS_CAND`` candidates; the merged top 100 against ``top_k`` of the
    ranks' block scores gathered, and those scores against the parent's
    one-process scores."""
    spec = torch.load(f"{tmp}/spec_retrieval.pt", weights_only=False)
    mesh = make_mesh(P11_RETRIEVAL_MESH, ("data", "model"))
    ctx = ShardingCtx(make_rules(mesh, P11_TP_OFF), mesh)
    axes = ctx.mesh_axes("candidates")
    out = {}
    for arch in P11_RETRIEVAL:
        s = spec[arch]
        cfg = p11_kind_cfg(arch)
        params = R.init_params(cfg, generator=torch.Generator(dev)
                               .manual_seed(s["seed"]), device=dev, ctx=ctx)
        q, cand = p11_to(s["query"], dev), s["cand"].to(dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        vals, idx = recsys_retrieval_step(params, cfg, q, cand, 100, ctx)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        scores, blk = retrieval_scores(params, cfg, q, cand, ctx)
        whole = gather_rows(scores, ctx.group(axes), cand.shape[0])
        tv, ti = top_k(whole, 100)
        check(torch.equal(ti, idx) and torch.equal(tv, vals),
              f"11b: {arch}'s merged top 100 is not top_k of the ranks' "
              f"block scores")
        one = s["scores"].to(dev)
        d = (whole.float() - one.float()).abs()
        out[arch] = dict(secs=secs, block=(blk.start, blk.stop),
                         differ=int((d > 0).sum()), gap=float(d.max()),
                         idx=idx.cpu(), vals=vals.cpu())
        del params, scores, whole
        torch.cuda.empty_cache()
    return out


def p11_rank(rank: int, world: int, tmp: str, role: str) -> None:
    """One rank of Phase 11, a ``torch.multiprocessing.spawn`` child using
    the kernels the parent built: joins the process group through a file
    in ``tmp`` (``init_distributed`` picks NCCL or gloo), runs its part
    and writes it, with its own launch counts, to
    ``tmp/<role>-rank<rank>.pt``."""
    import os
    import torch.distributed as dist
    if role == "a":     # bitwise repeats need deterministic cuBLAS
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        torch.use_deterministic_algorithms(True, warn_only=True)
    backend, dev = init_distributed(rank, world, f"{tmp}/rdv-{role}")
    out = {"backend": backend, "device": str(dev)}
    if backend == "gloo":
        p11_gloo_cuda(rank, world, dev)
    common.reset_launches()              # this rank's main path
    if role == "a":
        out["a"] = p11a_checks(tmp, dev)
    else:
        with deterministic_sums():
            out["rg"] = p11_rankgraph2(tmp, world, dev)
        torch.cuda.empty_cache()
        out["rs"] = p11_dlrm(tmp, world, dev)
        torch.cuda.empty_cache()
        mesh = make_mesh((1, world), ("data", "model"))
        ctx = ShardingCtx(make_rules(mesh, P11_TP_OFF), mesh)
        t = time.perf_counter()
        out["kinds"] = {}
        for arch in P11_KINDS:
            out["kinds"][arch] = p11_kind(tmp, world, dev, ctx, arch)
            torch.cuda.empty_cache()
        out["bags"] = p11_bags(tmp, world, dev, ctx)
        torch.cuda.empty_cache()
        out["retrieval"] = p11_retrieval(tmp, world, dev)
        out["recsys_s"] = time.perf_counter() - t
    out["launches"] = common.launch_counts()
    torch.save(out, f"{tmp}/{role}-rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def spawn_ranks(fn, args: tuple, world: int, limit: float, what: str
                ) -> None:
    """Run ``world`` ranks of ``fn(rank, *args)``; any rank that raises
    or exits non-zero fails the phase, as does passing ``limit``
    seconds."""
    import torch.multiprocessing as mp
    ctx = mp.spawn(fn, args=args, nprocs=world, join=False)
    deadline = time.monotonic() + limit
    while not ctx.join(timeout=5.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            raise AssertionError(f"{what}: {world} ranks passed the "
                                 f"{limit:.0f} s limit")


def p11_spawn(role: str, world: int, tmp: str) -> list:
    """Run ``world`` ranks of ``p11_rank`` (``spawn_ranks``, within
    ``P11_TIMEOUT_S``).  Returns each rank's output."""
    spawn_ranks(p11_rank, (world, tmp, role), world, P11_TIMEOUT_S,
                f"phase 11{role}")
    return [torch.load(f"{tmp}/{role}-rank{r}.pt", weights_only=False)
            for r in range(world)]


def p11_corpus(seed: int, dev) -> SimpleNamespace:
    """Phase 3's corpus without its training: the log, ``build_graph``
    and the device PPR tables, as ``run_pipeline`` makes them (for
    ``--distributed-only``)."""
    cfg = CONFIG
    world = make_log_world(seed)
    g = build_graph(world.day0, alpha_pop=cfg.alpha_pop, c_u=cfg.c_u,
                    c_i=cfg.c_i, k_cap=cfg.k_cap, seed=seed)
    tables = build_neighbor_tables(g, k_imp=cfg.k_imp, n_walks=cfg.ppr_walks,
                                   walk_len=cfg.ppr_len,
                                   restart=cfg.ppr_restart, seed=seed,
                                   backend="device", device=dev)
    return SimpleNamespace(tables=tables, graph=g, user_feat=world.user_feat,
                           item_feat=world.item_feat)


def p11_reference(seed: int, dev, corpus, tmp: str) -> dict:
    """The parent's side: three batches of ``P11_ROWS`` edges a type on
    Phase 3's corpus and the whole batch's draws (``shard_block_for``:
    blocks of rows / P11_WORLD where that divides, else the whole batch,
    the reference's fallback), the one-process global step with those
    negatives in f32 and then in bf16 on the same batches and draws
    (each step's RQ selections kept, and in f32 the RQ's input rows,
    codebooks and histograms it starts from), the probe rows and their
    codes; the dlrm tables whole, serve logits and the local table
    gradient rows.  Writes the ranks' inputs to ``tmp``."""
    ds = EdgeDataset(corpus.tables, corpus.user_feat, corpus.item_feat,
                     k_train=CONFIG.k_train, device=dev, g=corpus.graph)
    feats = FeatureStore(ds.user_feat, ds.item_feat)
    per_type = {et: P11_ROWS for et in ("uu", "ui", "ii")}
    blk = shard_block_for(P11_ROWS, P11_WORLD)
    batch_list = [ds.sample_batch(t, seed, per_type)
                  for t in range(P11_STEPS)]
    batches = {"f32": batch_list, "bf16": batch_list}
    draw_list, ref = [], {}
    with deterministic_sums():     # its docstring says why
        g = torch.Generator().manual_seed(seed + 11)
        for tag, cfg in (("f32", dataclasses.replace(CONFIG,
                                                     dtype="float32")),
                         ("bf16", CONFIG)):
            state, opt = init_state(cfg, generator=torch.Generator()
                                    .manual_seed(seed), pool_size=P3_POOL,
                                    device=dev)
            grad_step = make_grad_step(cfg, features=feats,
                                       shard_block=blk)
            metrics, secs, codes, starts = [], [], [], []
            for t in range(P11_STEPS):
                if tag == "f32":     # the pool fills alike in both types
                    draw_list.append(draws_for(cfg, state.pool,
                                               batch_list[t], P11_ROWS, g,
                                               shard_block=blk))
                start = ([h.sum(dim=0) for h in state.rq_state.hists],
                         [b.detach().float().clone() for b in layer_books(
                             state.params["rq"], len(cfg.rq.codebook_sizes))])
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sg = grad_step(state, batch_list[t], draws=draw_list[t])
                state, m = apply_grads(state, sg, opt)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                metrics.append({k: float(v) for k, v in m.items()})
                codes.append(sg.aux["codes"].cpu())
                if tag == "f32":
                    starts.append((sg.aux["rq_input"].float(), *start))
                del sg
                if t == 0:
                    first = p11_params(state)
            ref[tag] = dict(metrics=metrics, secs=secs, state=state,
                            cfg=cfg, step_codes=codes, starts=starts,
                            params_first=first)
        probe = {tag: ref[tag]["state"].pool.user.detach().clone()
                 for tag in ("f32", "bf16")}
        for tag in probe:
            r = ref[tag]
            r["codes"] = assign_codes(r["state"].params["rq"], probe[tag],
                                      r["cfg"].rq).cpu()
    check_rows = {et: CHECK_ROWS for et in ("uu", "ui", "ii")}
    check_batch = ds.sample_batch(P11_STEPS, seed, check_rows)
    fresh, _ = init_state(CONFIG, generator=torch.Generator().manual_seed(
        seed), pool_size=P3_POOL, device=dev)
    check_draws = draws_for(CONFIG, fresh.pool, check_batch, CHECK_ROWS,
                            torch.Generator().manual_seed(seed + 12))
    cpu = torch.device("cpu")
    torch.save(dict(seed=seed,
                    user_feat=torch.from_numpy(np.asarray(corpus.user_feat,
                                                          np.float32)),
                    item_feat=torch.from_numpy(np.asarray(corpus.item_feat,
                                                          np.float32)),
                    batches=p11_to(batches, cpu),
                    draws=p11_to({"f32": draw_list, "bf16": draw_list}, cpu),
                    probe=p11_to(probe, cpu),
                    check_batch=p11_to(check_batch, cpu),
                    check_draws=p11_to(check_draws, cpu)),
               f"{tmp}/spec_rg.pt")
    del ds, feats, batches, batch_list, draw_list, fresh
    # dlrm-rm2 at Phase 4's train cut, its tables whole on the card
    cfg = P11_DLRM
    V, D = cfg.default_vocab, cfg.embed_dim
    whole = R.dlrm_init(cfg, generator=torch.Generator(dev).manual_seed(
        seed + 40), device=dev)
    gq = torch.Generator(dev).manual_seed(seed + 41)
    serve = recsys_batch(cfg, gq, P11_SERVE, dev, labels=False)
    logits = recsys_serve_step(whole, cfg, serve)
    train = recsys_batch(cfg, gq, RS_TRAIN, dev)
    loss, grads = loss_and_grads(whole, cfg, train)
    flat = (torch.arange(cfg.n_sparse, device=dev)[None, :] * V
            + train["sparse"].long()).reshape(-1)
    touched = torch.unique(flat)
    rows = grads["tables"].reshape(-1, D)[touched]
    torch.save(dict(seed=seed, serve=p11_to(serve, cpu), logits=logits.cpu(),
                    train=p11_to(train, cpu), touched=touched.cpu(),
                    rows=rows.cpu()), f"{tmp}/spec_rs.pt")
    ref["rs"] = dict(loss=float(loss), touched=int(touched.numel()))
    del whole, grads, rows
    torch.cuda.empty_cache()
    return ref


def p11_recsys_reference(seed: int, dev, tmp: str) -> dict:
    """The parent's one-process sides of 11b's new recsys checks, each
    made and freed in turn, written to ``tmp`` for the ranks: for each
    of ``P11_KINDS`` at ``TRAIN_VOCAB`` rows a table, a serve batch of
    ``P11_KIND_ROWS`` and its outputs, a train batch, its loss and the
    gradient rows of every row-sharded leaf that the batch reaches, then
    one ``recsys_train_step`` and the parameters after it (the reached
    rows and ``P11_SAMPLE_ROWS`` others of each sharded leaf, the other
    leaves whole); dlrm's multi-hot bags (``P11_KIND_ROWS`` rows, lengths
    1..``BAG``): the one-process kernel's f32 bags, the logits, a
    cotangent and the backward kernel's table gradient rows, split by
    rank; and the one-process retrieval scores of ``P11_RETRIEVAL``."""
    cpu = torch.device("cpu")
    out = {}
    for i, arch in enumerate(P11_KINDS):
        cfg = p11_kind_cfg(arch)
        whole = R.init_params(cfg, generator=torch.Generator(dev).manual_seed(
            seed + 60 + i), device=dev)
        g = torch.Generator(dev).manual_seed(seed + 70 + i)
        serve = recsys_batch(cfg, g, P11_KIND_ROWS, dev, labels=False)
        served = recsys_serve_step(whole, cfg, serve)
        train = p11_train_batch(cfg, g, P11_KIND_ROWS, dev)
        loss, grads = loss_and_grads(whole, cfg, train)
        touched, rows = {}, {}
        for k in R.ROW_SHARDED[cfg.kind]:
            gk = leaf_rows(grads[k])
            touched[k] = torch.nonzero(gk.abs().amax(dim=1) > 0).flatten()
            rows[k] = gk[touched[k]].cpu()
        del grads, gk
        opt = rankgraph2_optimizer()
        st = opt.init(R.flatten_params(whole))
        recsys_train_step(whole, st, train, cfg, opt)
        del st
        sample, after = {}, {}
        for k, v in R.flatten_params(whole).items():
            if k in touched:
                n = leaf_rows(v).shape[0]
                sample[k] = torch.unique(torch.cat([touched[k], torch.randint(
                    0, n, (P11_SAMPLE_ROWS,), generator=g, device=dev)]))
                after[k] = leaf_rows(v)[sample[k]].detach().cpu()
            else:
                after[k] = v.detach().cpu()
        torch.save(dict(seed=seed + 60 + i, serve=p11_to(serve, cpu),
                        out=served.cpu(), train=p11_to(train, cpu),
                        loss=float(loss), touched=p11_to(touched, cpu),
                        rows=rows, sample=p11_to(sample, cpu), after=after),
                   f"{tmp}/spec_{cfg.kind}.pt")
        out[arch] = dict(loss=float(loss), touched={
            k: int(v.numel()) for k, v in touched.items()})
        del whole, serve, served, train, touched, rows, sample, after
        torch.cuda.empty_cache()
    # dlrm's multi-hot bags: the tables whole, as p11_dlrm's
    cfg = P11_DLRM
    V, D, F_ = cfg.default_vocab, cfg.embed_dim, cfg.n_sparse
    bf16 = torch.bfloat16
    whole = R.dlrm_init(cfg, generator=torch.Generator(dev).manual_seed(
        seed + 40), device=dev)
    g = torch.Generator(dev).manual_seed(seed + 80)
    batch = recsys_batch(cfg, g, P11_KIND_ROWS, dev, bags=BAG, labels=False)
    logits = recsys_serve_step(whole, cfg, batch)
    ids = batch["sparse"]
    offs = (torch.arange(F_, device=dev) * V)[None, :, None]
    flat_ids = torch.where(ids >= 0, ids.long() % V + offs, -1).reshape(
        -1, BAG).to(torch.int32)
    table = leaf_rows(whole["tables"])
    bags32 = EB.embedding_bag_fwd(table, flat_ids, None, "sum", bf16,
                                  torch.float32)
    check(torch.equal(bags32.to(bf16), EB.embedding_bag_fwd(
        table, flat_ids, None, "sum", bf16)), "embedding_bag_fwd: its f32 "
        "out rounded once is not its bf16 out")
    cot = (torch.randn((flat_ids.shape[0], D), generator=g, device=dev)
           * 1e-3).to(bf16)
    d_table, _ = EB.embedding_bag_bwd(cot, table, flat_ids, None, "sum",
                                      bf16)
    reached = torch.unique(flat_ids[flat_ids >= 0].long())
    for r in range(P11_WORLD):
        rows = slice(r * V // P11_WORLD, (r + 1) * V // P11_WORLD)
        own, local = own_rows(reached, V, rows)
        torch.save(dict(local=local.cpu(),
                        rows=d_table[reached[own]].to(bf16).cpu()),
                   f"{tmp}/spec_bags-{r}.pt")
    torch.save(dict(seed=seed + 40, batch=p11_to(batch, cpu),
                    logits=logits.cpu(), bags32=bags32.cpu(),
                    cot=cot.cpu()), f"{tmp}/spec_bags.pt")
    out["bags"] = dict(reached=int(reached.numel()),
                       valid=int((flat_ids >= 0).sum()))
    del whole, table, bags32, d_table, cot, batch
    torch.cuda.empty_cache()
    # retrieval: one query against RS_CAND candidates, one process
    spec = {}
    for i, arch in enumerate(P11_RETRIEVAL):
        cfg = p11_kind_cfg(arch)
        params = R.init_params(cfg, generator=torch.Generator(dev)
                               .manual_seed(seed + 90 + i), device=dev)
        g = torch.Generator(dev).manual_seed(seed + 95 + i)
        q = recsys_batch(cfg, g, 1, dev, labels=False)
        cand = torch.randint(0, 4 * cfg.default_vocab, (RS_CAND,),
                             generator=g, device=dev, dtype=torch.int32)
        vals, idx = recsys_retrieval_step(params, cfg, q, cand, 100)
        scores, _ = retrieval_scores(params, cfg, q, cand)
        spec[arch] = dict(seed=seed + 90 + i, query=p11_to(q, cpu),
                          cand=cand.cpu(), scores=scores.cpu(),
                          vals=vals.cpu(), idx=idx.cpu())
        del params
        torch.cuda.empty_cache()
    torch.save(spec, f"{tmp}/spec_retrieval.pt")
    out["retrieval"] = {a: (spec[a]["vals"], spec[a]["idx"])
                        for a in P11_RETRIEVAL}
    return out


def p11_params(state) -> dict:
    """A CPU copy of every parameter of a train state, by name."""
    return {k: v.detach().to("cpu", copy=True)
            for k, v in named_params(state.params).items()}


def p11_gaps(mine, want) -> tuple:
    """The median, the share beyond P11_GAP_FAR and the largest of the
    elementwise gaps between two lists of tensors."""
    d = torch.cat([(x.double().cpu() - y.double().cpu()).abs().reshape(-1)
                   for x, y in zip(mine, want)])
    return (float(d.median()), float((d > P11_GAP_FAR).double().mean()),
            float(d.max()))


def bf16_lead(a: dict, b: dict, f32: dict) -> float:
    """How much farther the metrics ``a`` of one step lie from the f32
    step's ``f32`` than ``b`` does, by 11b's bf16 tolerance at the f32
    value: the largest ``(|a - f32| - |b - f32|) / (CARD_CPU_REL |f32| +
    CARD_CPU_ABS)`` over the metrics (1 is the tolerance)."""
    return max((abs(a[k] - f32[k]) - abs(b[k] - f32[k]))
               / (CARD_CPU_REL * abs(f32[k]) + CARD_CPU_ABS) for k in f32)


def p11_rankgraph2_held(role: str, backend: str, world: int, tag: str,
                        rg: list, want: dict, note: str, smi: str,
                        f32: list) -> None:
    """11b's rankgraph2 check of one type: the ranks' outputs ``rg``
    against the parent's global step ``want`` (and in bf16 both against
    the f32 global step's metrics ``f32`` on the same batches and
    draws).  Prints every number, then fails on the first check that
    does not hold."""
    failed = []

    def hold(cond: bool, what: str) -> None:
        if not cond:
            failed.append(what)

    def held(fn, *args):
        try:
            return fn(*args)
        except AssertionError as e:     # printed below, then failed
            failed.append(str(e))
            return None

    hold(len({r["hash"] for r in rg}) == 1,
         f"11{role} {tag}: the ranks' states differ")
    mine, st = rg[0], want["state"]
    if tag == "f32":
        gaps = [f32_gap(x, y) for x, y in zip(mine["metrics"],
                                              want["metrics"])]
        hold(max(gaps) <= 1, f"11{role} f32: losses {mine['metrics']} vs "
             f"{want['metrics']}")
        loss_note = f"worst loss gap {max(gaps):.3f} of the tolerance"
    else:
        # by step 2 the two bf16 sides' selections have parted at near
        # ties and their losses lie up to four tolerances apart, so each
        # bf16 side is held against the f32 global step: the
        # data-parallel step no farther from it than the global bf16
        # step, plus the tolerance
        gaps = [within(x, y, CARD_CPU_REL, CARD_CPU_ABS)
                for x, y in zip(mine["metrics"], want["metrics"])]
        to_f32 = [[float(f"{within(x, f, CARD_CPU_REL, CARD_CPU_ABS):.3g}")
                   for x, f in zip(side, f32)]
                  for side in (mine["metrics"], want["metrics"])]
        lead = [bf16_lead(x, y, f) for x, y, f in zip(
            mine["metrics"], want["metrics"], f32)]
        hold(max(lead) <= 1, f"11{role} bf16: the data-parallel step's "
             f"losses {mine['metrics']} lie farther from the f32 step's "
             f"{f32} than the global bf16 step's {want['metrics']} by "
             f"{[float(f'{x:.3g}') for x in lead]} of the tolerance")
        loss_note = (f"loss gap of the global bf16 step each step "
                     f"{[float(f'{x:.3g}') for x in gaps]} of the tolerance; "
                     f"of the f32 global step on the same batches and draws,"
                     f" the data-parallel step's {to_f32[0]} and the global "
                     f"bf16 step's {to_f32[1]}; the data-parallel step's "
                     f"lead over the global's "
                     f"{[float(f'{x:.3g}') for x in lead]} (limit 1)")
    rq = want["cfg"].rq
    sizes = rq.codebook_sizes
    # each step's selections, the ranks' in global row order; every
    # histogram row counts its step's selections
    flips, hist_gap = [], 0
    for t in range(P11_STEPS):
        ck = p11_global_rows([r["step_codes"][t] for r in rg], P11_ROWS)
        cp = want["step_codes"][t]
        if ck.shape != cp.shape:
            hold(False, f"11{role} {tag} step {t}: {tuple(ck.shape)} "
                 f"selections vs {tuple(cp.shape)}")
            continue
        for l, n in enumerate(sizes):
            for side, codes, hist in (("data-parallel", ck,
                                       mine["hists"][l]),
                                      ("global", cp, st.rq_state.hists[l])):
                hold(torch.equal(hist[t].cpu(), torch.bincount(
                    codes[:, l], minlength=n).float()),
                    f"11{role} {tag} step {t} layer {l}: the {side} "
                    f"histogram row is not its selections' counts")
            hist_gap += int((mine["hists"][l][t]
                             != st.rq_state.hists[l][t].cpu()).sum())
        if tag == "f32":
            h, tot_p, books_p = want["starts"][t]
            tot_k, books_k = rg[0]["starts"][t]
            res = held(selection_ties, h, ck, cp, books_p, books_k, tot_p,
                       tot_k, rq, f"11{role} f32 step {t}")
            flips.append(res if res is None else (res[0], round(res[1], 4)))
        else:
            flips.append(int((~(ck == cp).all(dim=1)).sum()))
    hist_diff = sum(int((x != y.cpu()).sum()) for x, y in zip(
        mine["hists"], st.rq_state.hists))
    hold(hist_diff == hist_gap, f"11{role} {tag}: histogram rows past "
         f"the steps' differ")
    usage_gap = max(float((x - y.cpu()).abs().max()) for x, y in
                    zip(mine["usage"], st.rq_state.usage))
    fills = (st.pool.user_fill, st.pool.item_fill)
    hold(mine["fills"] == fills, f"11{role} {tag}: pool fills "
         f"{mine['fills']} vs {fills}")
    pool = p11_gaps([x[:n] for x, n in zip(mine["pool"], fills)],
                    [x[:n] for x, n in zip((st.pool.user, st.pool.item),
                                           fills)])
    # each parameter's gaps after the first step and after the last (the
    # worst median, share and largest over them); a flipped selection
    # changes the gradients of the rows it reaches, and Adam passes a
    # relative gradient change on to the update, so the parameters are
    # held after the first step (before the histograms part)
    params = named_params(st.params)

    def worst(gaps: dict) -> tuple:
        return tuple(max(g[i] for g in gaps.values()) for i in range(3))
    each = {k: p11_gaps([v], [params[k].detach()])
            for k, v in mine["params"].items()}
    first = {k: p11_gaps([v], [want["params_first"][k]])
             for k, v in mine["params_first"].items()}
    par, par1 = worst(each), worst(first)
    print(f"[phase11{role}] {tag} each parameter's gaps after the last "
          f"step (median, share beyond {P11_GAP_FAR}, largest): " + json.dumps(
              {k: [float(f"{x:.3g}") for x in g]
               for k, g in sorted(each.items(), key=lambda kv: -kv[1][0])}))
    if tag == "f32":    # ROADMAP's optimizer-sign hazard: by distribution
        for what, g in (("the pool rows", pool),
                        ("the worst parameter after the first step",
                         par1)):
            hold(g[0] <= P11_GAP_MEDIAN and g[1] <= P11_GAP_FAR_SHARE,
                 f"11{role} f32: {what}'s gaps: median {g[0]:.3g}, share "
                 f"beyond {P11_GAP_FAR} {g[1]:.3g}")
    else:
        hold(pool[2] <= P11_POOL_BF16, f"11{role} bf16: pool rows "
             f"{pool[2]} apart")
    # the probe rows' codes (Eq. 9) on each side's codebooks
    ck = torch.from_numpy(layer_codes(mine["codes"], sizes))
    cp = torch.from_numpy(layer_codes(want["codes"], sizes))
    books = [b.detach().float().cpu() for b in layer_books(
        st.params["rq"], len(sizes))]
    drift = book_drift(books, mine["books"])
    near = held(near_ties, st.pool.user.detach().float().cpu(), ck, cp,
                books, f"11{role} {tag} probe", mine["books"])
    sel = ("flipped rows and the largest lead over its allowance"
           if tag == "f32" else "flipped rows")
    print(f"[phase11{role}] backend {backend}, world size {world}, mesh "
          f"({world},) data: rankgraph2 {tag} {P11_STEPS} steps of "
          f"{P11_ROWS} edges a type on its own RQ selections against the "
          f"global step: {loss_note}; "
          f"selections differing from the global step's, each step "
          f"({sel}) {flips}; histogram bins differing {hist_diff}, each "
          f"row its step's selections' counts; usage gap {usage_gap:.3g}; "
          f"the filled pool rows' gaps (median, share beyond "
          f"{P11_GAP_FAR}, largest) {[float(f'{x:.3g}') for x in pool]}; "
          f"the parameters' (the worst of each over them) after the "
          f"first step {[float(f'{x:.3g}') for x in par1]}, after the "
          f"last {[float(f'{x:.3g}') for x in par]}; codebook drift "
          f"{[float(f'{d:.3g}') for d in drift]}; probe codes differing "
          f"{near} of {ck.shape[0]}, each a near tie within its codes' "
          f"drift; each rank's step seconds "
          f"{[[round(x, 4) for x in r['secs']] for r in rg]}; peak GB "
          f"{[round(r['peak_gb'], 3) for r in rg]} ({note}; {smi})",
          flush=True)
    for what in failed:
        check(False, what)


def p11_global_rows(parts: list, rows: int) -> torch.Tensor:
    """The ranks' RQ rows (each laid out as its block's endpoints: every
    edge type in sorted order, its src rows then its dst rows, a rank's
    ``block_rows`` of ``rows`` edges a type) in the whole batch's
    order."""
    sizes = [len(range(rows)[block_rows(rows, len(parts), r)])
             for r in range(len(parts))]
    n = parts[0].shape[0] // sizes[0]
    check(all(p.shape[0] == n * b for p, b in zip(parts, sizes)),
          f"11b: the ranks' RQ rows {[p.shape[0] for p in parts]}")
    return torch.cat([p[i * b:(i + 1) * b] for i in range(n)
                      for p, b in zip(parts, sizes)])


def p11_summary(outs: list, key: str, field: str) -> str:
    return "[" + ", ".join(f"{o[key][field]:.4f}" for o in outs) + "]"


def p11_recsys_held(role: str, backend: str, world: int, outs: list,
                    ref: dict, note: str, smi: str) -> None:
    """11b's row-sharded kinds, dlrm's bags and the retrieval: the ranks'
    results against each other and the parent's, and their lines."""
    for arch in P11_KINDS:
        ks = [o["kinds"][arch] for o in outs]
        want = ref[arch]
        check(all(k["loss"] == want["loss"] for k in ks),
              f"11{role}: {arch} losses {[k['loss'] for k in ks]} vs "
              f"{want['loss']}")
        check(sum(k["own_rows"] for k in ks) == sum(want["touched"].values()),
              f"11{role}: {arch}: the shards' rows do not cover the batch's")
        cfg = p11_kind_cfg(arch)
        after = [float(f"{max(k['after'][i] for k in ks):.3g}")
                 for i in range(3)]
        width = {"wide_deep": f"{cfg.n_sparse} fields, embed "
                 f"{cfg.embed_dim}, MLP {cfg.bot_mlp}",
                 "sasrec": f"embed {cfg.embed_dim}, seq {cfg.seq_len}, "
                 f"{cfg.n_blocks} blocks",
                 "bst": f"embed {cfg.embed_dim}, seq {cfg.seq_len}, "
                 f"{cfg.n_heads} heads, {cfg.n_sparse} profile fields"}
        print(f"[phase11{role}] backend {backend}, mesh (1, {world}): "
              f"{arch} at full width ({width[cfg.kind]}), {TRAIN_VOCAB:,} "
              f"rows a table, "
              f"{', '.join(R.ROW_SHARDED[cfg.kind])} row-sharded: "
              f"{P11_KIND_ROWS:,} serve outputs bitwise the parent's; the "
              f"gradient rows ({json.dumps(want['touched'])} reached) "
              f"within {P11_TABLE_REL} (worst "
              f"{max(k['table_gap'] for k in ks):.3g} of 1), none "
              f"elsewhere; after one recsys_train_step the parameters' "
              f"worst (median, share beyond {P11_GAP_FAR}, largest) gap "
              f"{after}; "
              f"serve seconds {[round(k['serve_s'], 4) for k in ks]}, train "
              f"step seconds {[round(k['train_s'], 4) for k in ks]}, peak GB "
              f"{[round(k['peak_gb'], 3) for k in ks]} ({note}; {smi})")
    bs = [o["bags"] for o in outs]
    b0 = bs[0]
    check(all(b["differ"] == b0["differ"] for b in bs),
          f"11{role}: the ranks' bags differ from each other")
    print(f"[phase11{role}] dlrm-rm2 multi-hot bags on row shards (mesh "
          f"(1, {world}), {P11_KIND_ROWS:,} rows x {DLRM.n_sparse} bags of "
          f"1..{BAG} ids, {ref['bags']['valid']:,} valid, "
          f"{ref['bags']['reached']:,} rows reached): embedding_bag_fwd "
          f"with f32 out on each shard, the model group's f32 sum within "
          f"{P11_BAG_REL} of the one-process kernel's f32 bags (worst "
          f"{max(b['bag_gap'] for b in bs):.3g} of 1), rounded once: "
          f"{b0['differ']:,} of {b0['entries']:,} bf16 entries differ, "
          f"{b0['far']} by more than one step (each below the floor); "
          f"logits {max(b['logit_gap'] for b in bs):.3g} of the largest "
          f"from the parent's (limit {P4_REL}); the shard's table gradient "
          f"(embedding_bag_bwd into the shard) "
          + ("bitwise the one-process kernel's rows (no row of a shard "
             f"holds {EB.PIECE} ids: at most "
             f"{max(b['most'] for b in bs)}; each row's terms in position "
             f"order)" if all(b["bitwise"] for b in bs) else
             f"within {P11_TABLE_REL} of the one-process kernel's rows "
             f"(worst {max(b['grad_gap'] for b in bs):.3g} of 1; a shard "
             f"row holds {max(b['most'] for b in bs)} ids, pieces of "
             f"{EB.PIECE} cut elsewhere)")
          + f", none elsewhere; serve seconds "
          f"{[round(b['serve_s'], 4) for b in bs]}, bag forward and "
          f"backward seconds {[round(b['bag_s'], 4) for b in bs]}, peak GB "
          f"{[round(b['peak_gb'], 3) for b in bs]} ({note}; {smi})")
    for arch in P11_RETRIEVAL:
        rs = [o["retrieval"][arch] for o in outs]
        vals, idx = ref["retrieval"][arch]
        check(all(torch.equal(r["idx"], rs[0]["idx"])
                  and torch.equal(r["vals"], rs[0]["vals"]) for r in rs),
              f"11{role}: {arch}'s ranks return different top 100s")
        swaps = sorted(set(idx.tolist()) ^ set(rs[0]["idx"].tolist()))
        same = (torch.equal(idx, rs[0]["idx"])
                and torch.equal(vals, rs[0]["vals"]))
        differ = max(r["differ"] for r in rs)
        check(same and differ == 0, f"11{role}: {arch}: {differ} block "
              f"scores differ from the one-process step's (largest gap "
              f"{max(r['gap'] for r in rs):.3g}), the merged top 100 "
              f"{'equal to' if same else 'not'} the one-process step's: "
              f"dot_scores promises both bitwise")
        print(f"[phase11{role}] retrieval at mesh {P11_RETRIEVAL_MESH} "
              f"(candidates over data, rows over model): {arch} against "
              f"{RS_CAND:,} candidates, blocks "
              f"{sorted({r['block'] for r in rs})}; the merged top 100 "
              f"bitwise top_k of the ranks' block scores; block scores "
              f"that differ from the one-process step's: {differ} (largest "
              f"gap {max(r['gap'] for r in rs):.3g}); the top 100 "
              f"{'equal to' if same else 'not equal to'} the one-process "
              f"step's (ids in one only: {swaps}); seconds "
              f"{[round(r['secs'], 4) for r in rs]} ({note}; {smi})")
    print(f"[phase11{role}] the row-sharded recsys checks took "
          f"{[round(o['recsys_s'], 2) for o in outs]} s a rank")


def phase11(seed: int, dev, corpus, smi: str) -> dict:
    """Phase 11: 11a on one NCCL rank (and 11b on NCCL, one rank a card,
    where the machine has four cards), 11b on four gloo ranks sharing
    the card.  Returns the ranks' launch counts, summed."""
    t_all = time.perf_counter()
    total = {}
    with tempfile.TemporaryDirectory(prefix="phase11-") as tmp:
        t = time.perf_counter()
        ref = p11_reference(seed, dev, corpus, tmp)
        ref_s = time.perf_counter() - t
        t = time.perf_counter()
        ref["recsys"] = p11_recsys_reference(seed, dev, tmp)
        print(f"[phase11] the parent's side of the row-sharded recsys "
              f"checks ({', '.join(P11_KINDS)}, dlrm's bags, retrieval) took "
              f"{time.perf_counter() - t:.2f} s ({smi})")
        rows, blk = P11_ROWS, shard_block_for(P11_ROWS, P11_WORLD)
        c = -(-rows // P11_WORLD)
        side = (f"shard-local negatives of {blk} rows" if blk else
                f"whole-batch negatives ({P11_WORLD} does not divide "
                f"{rows}: ranks of {c} rows, the last "
                f"{rows - (P11_WORLD - 1) * c})")
        print(f"[phase11] the parent's side (the global step in f32 and "
              f"bf16 at {rows} edges a type with {side}; dlrm-rm2 at "
              f"{TRAIN_VOCAB:,} rows a field, Phase 4's train cut) took "
              f"{ref_s:.2f} s; global step seconds f32 "
              f"{[round(x, 4) for x in ref['f32']['secs']]}, bf16 "
              f"{[round(x, 4) for x in ref['bf16']['secs']]} ({smi})")
        # 11a: one NCCL rank, mesh (1, 1)
        t = time.perf_counter()
        a = p11_spawn("a", 1, tmp)[0]
        check(a["backend"] == "nccl", f"11a chose {a['backend']}, not nccl")
        total = add_counts(total, a["launches"])
        print(f"[phase11a] backend {a['backend']}, world size 1, mesh (1, 1)"
              f": the rankgraph2 DP step bitwise the plain step at "
              f"{CHECK_ROWS} edges a type (the plain step repeats bitwise "
              f"under deterministic algorithms); step seconds (plain, "
              f"plain, DP) {[round(x, 4) for x in a['a']['step_s']]}; "
              f"_lookup_sharded at nm 1 bitwise the local gather, "
              f"{P11_SERVE:,} x {DLRM.n_sparse} ids on {DLRM.n_sparse} x "
              f"{P11_LOOKUP_VOCAB:,} x 64 f32, seconds "
              f"{json.dumps({k: round(v, 4) for k, v in a['a']['lookup_s'].items()})}"
              f"; peak {a['a']['peak_gb']:.3f} GB; wall "
              f"{time.perf_counter() - t:.2f} s ({smi})")
        roles = [("b", P11_WORLD)]
        if torch.cuda.device_count() >= P11_WORLD:
            roles.insert(0, ("b-nccl", P11_WORLD))
        else:
            print(f"[phase11a] {torch.cuda.device_count()} card(s): 11b on "
                  f"NCCL, one rank a card, needs {P11_WORLD}; not run")
        for role, world in roles:
            t = time.perf_counter()
            outs = p11_spawn(role, world, tmp)
            wall = time.perf_counter() - t
            backend = outs[0]["backend"]
            check(all(o["backend"] == backend for o in outs),
                  f"11{role}: ranks chose different backends")
            check(backend == ("nccl" if role == "b-nccl" else "gloo"),
                  f"11{role} chose {backend}")
            for o in outs:
                total = add_counts(total, o["launches"])
            note = ("gloo stages CUDA tensors through the host: these times "
                    "say nothing of NCCL" if backend == "gloo" else
                    "one rank a card")
            for tag in ("f32", "bf16"):
                p11_rankgraph2_held(role, backend, world, tag,
                                    [o["rg"][tag] for o in outs], ref[tag],
                                    note, smi, ref["f32"]["metrics"])
            rs = [o["rs"] for o in outs]
            check(all(r["loss"] == ref["rs"]["loss"] for r in rs),
                  f"11{role}: dlrm losses {[r['loss'] for r in rs]} vs "
                  f"{ref['rs']['loss']}")
            check(sum(r["own_rows"] for r in rs) == ref["rs"]["touched"],
                  f"11{role}: the shards' rows do not cover the batch's")
            print(f"[phase11{role}] backend {backend}, world size {world}, "
                  f"mesh (1, {world}) data x model: dlrm-rm2 {DLRM.n_sparse} x "
                  f"{TRAIN_VOCAB:,} x 64 f32 row-sharded ({TRAIN_VOCAB // world:,}"
                  f" rows a rank): {P11_SERVE:,} serve logits bitwise the "
                  f"one-process local lookup's; one step's table gradient "
                  f"rows ({ref['rs']['touched']:,} touched) within "
                  f"{P11_TABLE_REL} of the local ones (worst "
                  f"{max(r['table_gap'] for r in rs):.3g} of 1); each "
                  f"rank's serve "
                  f"seconds {p11_summary(outs, 'rs', 'serve_s')}, train "
                  f"step seconds {p11_summary(outs, 'rs', 'train_s')}, peak "
                  f"GB {p11_summary(outs, 'rs', 'peak_gb')}; wall "
                  f"{wall:.2f} s ({note}; {smi})")
            p11_recsys_held(role, backend, world, outs, ref["recsys"], note,
                            smi)
    print(f"[phase11] wall {time.perf_counter() - t_all:.2f} s; the ranks' "
          f"launches {json.dumps(nonzero(total))}")
    return total


# ---------------------------------------------------------------------------
# Phase 12: the LM family under a mesh
# ---------------------------------------------------------------------------

def kimi_params(cfg, seed: int, dev, experts: range) -> dict:
    """kimi-k2 parameters at ``cfg`` in its bf16 param type, with only the
    experts in ``experts`` of each layer: the rest drawn in one order from
    a generator seeded ``seed + 151`` (as ``init_params`` scales them),
    and expert ``e`` of layer ``i`` from its own generator seeded
    ``p12_expert_seed(seed, i, e)``, so that a rank holding some experts
    draws exactly the values the whole tree has there."""
    dtype = LM.DTYPES[cfg.param_dtype]
    d, hd, E, ff, V = cfg.d_model, cfg.resolved_head_dim, cfg.n_experts, \
        cfg.moe_d_ff, cfg.vocab_size
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    g = torch.Generator(dev).manual_seed(seed + 151)

    def w(fan_in: int, *shape):
        return torch.empty(shape, dtype=dtype, device=dev).normal_(
            0.0, fan_in ** -0.5, generator=g)
    layers = []
    for i in range(cfg.n_layers):
        p = {"wq": w(d, d, H * hd), "wk": w(d, d, Hkv * hd),
             "wv": w(d, d, Hkv * hd), "wo": w(H * hd, H * hd, d),
             "ln1": torch.ones(d, dtype=dtype, device=dev),
             "ln2": torch.ones(d, dtype=dtype, device=dev),
             "router": w(d, d, E)}
        shapes = {"w_gate": (d, ff), "w_up": (d, ff), "w_down": (ff, d)}
        for n, shape in shapes.items():
            p[n] = torch.empty((len(experts),) + shape, dtype=dtype,
                               device=dev)
        for j, e in enumerate(experts):
            ge = torch.Generator(dev).manual_seed(p12_expert_seed(seed, i, e))
            for n, shape in shapes.items():
                p[n][j].normal_(0.0, shape[0] ** -0.5, generator=ge)
        layers.append(p)
    emb = torch.empty((V, d), dtype=dtype, device=dev).normal_(
        0.0, 1.0, generator=g).mul_(0.02)
    head = torch.empty((d, V), dtype=dtype, device=dev).normal_(
        0.0, 1.0, generator=g).mul_(0.02)
    return {"embed": emb, "layers": layers, "lm_head": head,
            "final_norm": torch.ones(d, dtype=dtype, device=dev)}


def p12_expert_seed(seed: int, layer: int, e: int) -> int:
    return seed * 1_000_003 + (layer + 1) * 10_007 + e


def moe_grads(fn, lp: dict, x: torch.Tensor, R: torch.Tensor,
              dp: int = 1) -> dict:
    """The MoE block ``fn(lp, x)`` under grad of ``sum(out * R) + aux /
    dp``: the output, aux, the gradients of x and the router, and each
    expert leaf's gradient by the norm of each expert's and by
    ``P12_SAMPLE`` fixed rows of each (one leaf's gradient at a time)."""
    x = x.clone().requires_grad_(True)
    names = ("w_gate", "w_up", "w_down")
    for n in ("router",) + names:
        lp[n].requires_grad_(True)
    try:
        out, aux = fn(lp, x)
        loss = torch.sum(out.float() * R) + aux / dp
        dx, dr = torch.autograd.grad(loss, [x, lp["router"]],
                                     retain_graph=True)
        res = {"out": out.detach().cpu(), "aux": float(aux.detach()),
               "dx": dx.cpu(), "router": dr.cpu()}
        del dx, dr
        for i, n in enumerate(names):
            gr, = torch.autograd.grad(loss, [lp[n]],
                                      retain_graph=i < len(names) - 1)
            rows = torch.linspace(0, gr.shape[1] - 1, P12_SAMPLE,
                                  device=gr.device).long()
            res[n] = (torch.stack([gr[e].float().norm()
                                   for e in range(gr.shape[0])]).cpu(),
                      gr[:, rows].cpu())
            del gr
    finally:
        for n in ("router",) + names:
            lp[n].requires_grad_(False)
    return res


def p12a_reference(seed: int, dev, tmp: str) -> dict:
    """12a's parent side: kimi-k2 at full width, one layer, all 384
    experts (38.8 GB): the prefill of ``P12_KIMI_S`` tokens with every MoE
    block as ``_moe_shard_map_plain`` at nm ``P12_WORLD`` (the ranks'
    dispatch in one process), then the MoE block alone under grad
    (``moe_grads``) without the embedding and head; writes the inputs
    for the ranks and frees the card."""
    cfg = dataclasses.replace(KIMI, n_layers=1)
    S, E = P12_KIMI_S, cfg.n_experts
    t = time.perf_counter()
    params = kimi_params(cfg, seed, dev, range(E))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    g = torch.Generator(dev).manual_seed(seed + 153)
    prompt = lm_tokens(cfg, g, 1, S, dev)
    x = torch.randn((1, S, cfg.d_model), generator=g, device=dev).to(
        torch.bfloat16)
    R = torch.randn((1, S, cfg.d_model), generator=g, device=dev)
    block = LM._moe_block
    LM._moe_block = lambda p, c, x_, ctx=None, lay=None: \
        LM._moe_shard_map_plain(p, c, x_, P12_WORLD)
    try:
        t = time.perf_counter()
        last, caches = lm_prefill_step(params, cfg, prompt)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t
    finally:
        LM._moe_block = block
    del params["embed"], params["lm_head"]
    torch.cuda.empty_cache()
    lp = params["layers"][0]
    t = time.perf_counter()
    grads = moe_grads(lambda p, x_: LM._moe_shard_map_plain(
        p, cfg, x_, P12_WORLD), lp, x, R)
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    torch.save(dict(prompt=prompt.cpu(), x=x.cpu(), R=R.cpu()),
               f"{tmp}/p12a-inputs.pt")
    out = dict(last=last.cpu(), caches={k: v.cpu() for k, v in
                                        caches.items()},
               grads=grads, init_s=init_s, prefill_s=prefill_s,
               grad_s=grad_s, peak=peak)
    del params, lp, last, caches, x, R
    torch.cuda.empty_cache()
    return out


def p12b_reference(seed: int, dev, tmp: str) -> dict:
    """12b's parent side: olmo-1b at full width and depth,
    ``P12_STEPS`` one-process ``lm_train_step``s (AdamW) on B
    ``P12_OLMO_B`` x S ``P12_OLMO_S`` from ``init_params`` seeded ``seed +
    161``; writes the tokens and the parameters after the first step for
    the ranks and frees the card."""
    cfg = OLMO
    params = LM.init_params(cfg, generator=torch.Generator(dev).manual_seed(
        seed + 161), device=dev)
    toks = lm_tokens(cfg, torch.Generator(dev).manual_seed(seed + 163),
                     P12_OLMO_B, P12_OLMO_S, dev)
    opt = OPT.make_optimizer(cfg.optimizer)
    st = opt.init(LM.named_params(params))
    losses, norms, secs = [], [], []
    torch.cuda.reset_peak_memory_stats()
    for t in range(P12_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, gnorm, st = lm_train_step(params, cfg, opt, st, toks)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(loss))
        norms.append(float(gnorm))
        if t == 0:
            torch.save({k: v.detach().cpu() for k, v in
                        LM.named_params(params).items()},
                       f"{tmp}/p12b-step1.pt")
    peak = torch.cuda.max_memory_allocated()
    torch.save(toks.cpu(), f"{tmp}/p12b-tokens.pt")
    del params, st, toks
    torch.cuda.empty_cache()
    return dict(losses=losses, norms=norms, secs=secs, peak=peak)


def p12a_rank(tmp: str, seed: int, world: int, dev) -> dict:
    """12a on this rank, mesh (1, world): its ``E / world`` experts and the
    rest of one kimi layer (``kimi_params``), the prefill through
    ``_moe_shard_map`` (``lm_prefill_step(ctx=)``), then the MoE block
    alone under grad (``moe_grads``) without the embedding and head."""
    cfg = dataclasses.replace(KIMI, n_layers=1)
    mesh = make_mesh((1, world), ("data", "model"))
    shape = next(s for s in LM_SHAPES if s.step == "prefill")
    ctx = ShardingCtx(lm_rules("kimi-k2-1t-a32b", shape, mesh,
                               overrides=P12_TP_OFF), mesh)
    E_loc = cfg.n_experts // world
    mi = ctx.axis_index("model")
    inp = torch.load(f"{tmp}/p12a-inputs.pt")
    check(LM.moe_dispatch(cfg, P12_KIMI_S, ctx) == "shard_map",
          "12a: the prefill does not take the shard_map dispatch")
    torch.cuda.reset_peak_memory_stats()
    params = kimi_params(cfg, seed, dev, range(mi * E_loc, (mi + 1) * E_loc))
    n_bytes = sum(p.numel() * p.element_size()
                  for p in LM.named_params(params).values())
    common.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    last, caches = lm_prefill_step(params, cfg, inp["prompt"].to(dev), ctx)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    launches = common.launch_counts()
    check(nonzero(launches) == {"flash_attention": cfg.n_layers},
          f"12a prefill: launches {nonzero(launches)}")
    del params["embed"], params["lm_head"]
    torch.cuda.empty_cache()
    t = time.perf_counter()
    lay = LM.param_layout(cfg, ctx)["layers"][0]
    grads = moe_grads(lambda p, x_: LM._moe_shard_map(p, cfg, x_, ctx, lay),
                      params["layers"][0], inp["x"].to(dev),
                      inp["R"].to(dev))
    torch.cuda.synchronize()
    return dict(last=last.cpu(), caches={k: v.cpu() for k, v in
                                         caches.items()},
                grads=grads, experts=(mi * E_loc, (mi + 1) * E_loc),
                prefill_s=prefill_s, grad_s=time.perf_counter() - t,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                params_gb=n_bytes / 1e9, launches=launches)


def p12b_rank(tmp: str, seed: int, world: int, dev) -> dict:
    """12b on this rank, mesh (world, 1): its FSDP shards of olmo-1b
    (``shard_params`` of ``init_params`` seeded as the parent's),
    ``P12_STEPS`` ``lm_train_step(ctx=)``s on the whole batch (this rank
    takes its row), the bytes its gathers receive counted; after the
    first step its shards' gaps to the parent's parameters' blocks."""
    import repro_torch.distributed.collectives as C
    cfg = OLMO
    mesh = make_mesh((world, 1), ("data", "model"))
    shape = next(s for s in LM_SHAPES if s.step == "train")
    ctx = ShardingCtx(lm_rules("olmo-1b", shape, mesh), mesh)
    full = LM.init_params(cfg, generator=torch.Generator(dev).manual_seed(
        seed + 161), device=dev)
    params = LM.shard_params(full, cfg, ctx)
    del full
    torch.cuda.empty_cache()
    toks = torch.load(f"{tmp}/p12b-tokens.pt").to(dev)
    opt = OPT.make_optimizer(cfg.optimizer, shards=LM.shard_groups(cfg, ctx))
    st = opt.init(LM.named_params(params))
    gathered = [0]
    orig = C.gather_dim

    def counted(x, dim, group, **kw):
        out = orig(x, dim, group, **kw)
        gathered[0] += out.numel() * out.element_size()
        return out
    C.gather_dim = counted
    common.reset_launches()
    losses, norms, secs, peaks, per_step, gaps = [], [], [], [], [], {}
    try:
        for t in range(P12_STEPS):
            gathered[0] = 0
            before = common.launch_counts()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, gnorm, st = lm_train_step(params, cfg, opt, st, toks, ctx)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            peaks.append(torch.cuda.max_memory_allocated() / 1e9)
            losses.append(float(loss))
            norms.append(float(gnorm))
            per_step.append({k: n - before[k] for k, n in
                             common.launch_counts().items()
                             if n != before[k]})
            if t == 0:
                ref = LM.named_params(LM.shard_params(p12_tree(torch.load(
                    f"{tmp}/p12b-step1.pt", mmap=True), cfg), cfg, ctx))
                for name, mine in LM.named_params(params).items():
                    want = ref[name].to(dev)
                    d = (mine.detach() - want).abs().flatten()
                    gaps[name] = (float(d.median()),
                                  float((d > P12_GAP_FAR).float().mean()),
                                  float(d.max()), tuple(mine.shape))
                del ref
    finally:
        C.gather_dim = orig
    return dict(losses=losses, norms=norms, secs=secs, peaks=peaks,
                gathered_gb=gathered[0] / 1e9, per_step=per_step, gaps=gaps,
                launches=common.launch_counts())


def p12_tree(flat: dict, cfg) -> dict:
    """``named_params``' flat dict -> the parameter tree."""
    tree = {k: v for k, v in flat.items() if not k.startswith("layers.")}
    tree["layers"] = [{} for _ in range(cfg.n_layers)]
    for k, v in flat.items():
        if k.startswith("layers."):
            _, i, n = k.split(".", 2)
            tree["layers"][int(i)][n] = v
    return tree


def p12_rank(rank: int, world: int, tmp: str, role: str, seed: int) -> None:
    """One rank of Phase 12, a ``torch.multiprocessing.spawn`` child using
    the kernels the parent built: joins the process group through a file
    in ``tmp`` (``init_distributed`` picks NCCL or gloo), runs 12a then
    12b and writes them, with its own launch counts (12a's prefill and
    12b's steps), to ``tmp/12<role>-rank<rank>.pt``."""
    import torch.distributed as dist
    backend, dev = init_distributed(rank, world, f"{tmp}/rdv12-{role}")
    if backend == "gloo":
        p11_gloo_cuda(rank, world, dev)
    a = p12a_rank(tmp, seed, world, dev)
    torch.cuda.empty_cache()
    b = p12b_rank(tmp, seed, world, dev)
    launches = add_counts(dict(a.pop("launches")), b.pop("launches"))
    torch.save(dict(backend=backend, a=a, b=b, launches=launches),
               f"{tmp}/12{role}-rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def p12a_held(role: str, outs: list, ref: dict, note: str, smi: str
              ) -> None:
    """12a's checks on the ranks' outputs against the parent's."""
    cfg = dataclasses.replace(KIMI, n_layers=1)
    a0 = outs[0]["a"]
    check(all(torch.equal(o["a"]["last"], a0["last"]) for o in outs),
          f"12{role}a: the ranks' logits differ")
    rg = ref["grads"]
    for n in ("out", "dx", "router"):
        check(all(torch.equal(o["a"]["grads"][n], a0["grads"][n])
                  for o in outs), f"12{role}a: the ranks' {n} differ")
    # the same products on the same slices as the parent's: bitwise
    same = {"logits": same_bits(a0["last"], ref["last"]),
            "aux": a0["grads"]["aux"] == rg["aux"]}
    for k in ("k", "v"):
        same[f"cache {k}"] = same_bits(a0["caches"][k], ref["caches"][k])
    for n in ("out", "dx"):
        same[n] = same_bits(a0["grads"][n], rg[n])
    for n in ("w_gate", "w_up", "w_down"):
        for o in outs:
            lo, hi = o["a"]["experts"]
            norms, rows = o["a"]["grads"][n]
            same[f"{n} norms"] = same.get(f"{n} norms", True) and \
                same_bits(norms, rg[n][0][lo:hi])
            same[f"{n} rows"] = same.get(f"{n} rows", True) and \
                same_bits(rows, rg[n][1][lo:hi])
    check(all(same.values()), f"12{role}a: not bitwise the parent's: "
          f"{[k for k, v in same.items() if not v]}")
    # d router sums the four slices' bf16 products in another order
    gap = near(a0["grads"]["router"], rg["router"], BF16_LM_TOL)
    check(gap <= 1, f"12{role}a: d router {gap:.3g} of {BF16_LM_TOL}")
    T_my = P12_KIMI_S // P12_WORLD
    cap = LM.shard_map_capacity(cfg, T_my)
    E_loc = cfg.n_experts // P12_WORLD
    print(f"[phase12{role}a] kimi-k2-1t-a32b, 1 of 61 layers at full width, "
          f"mesh (1, {P12_WORLD}): {E_loc} of {cfg.n_experts} experts a "
          f"rank; prefill B 1 x S {P12_KIMI_S} through _moe_shard_map (T_my "
          f"{T_my}, capacity {cap}, send buffer {P12_WORLD} x {E_loc} x "
          f"{cap} x {cfg.d_model} bf16 "
          f"{gb(2 * P12_WORLD * E_loc * cap * cfg.d_model)}) and the D "
          f"{cfg.resolved_head_dim} prefill kernel; the ranks' logits "
          f"bitwise equal; against the parent's one-process dispatch "
          f"(_moe_shard_map_plain): bitwise equal "
          + ", ".join(same)
          + f" (expert gradients: each expert's norm and {P12_SAMPLE} "
          f"fixed rows of each), d router {gap:.3g} of {BF16_LM_TOL} of "
          f"the largest; a rank's params "
          f"{p11_summary(outs, 'a', 'params_gb')} GB, prefill seconds "
          f"{p11_summary(outs, 'a', 'prefill_s')}, MoE block under grad "
          f"seconds {p11_summary(outs, 'a', 'grad_s')}, peak GB "
          f"{p11_summary(outs, 'a', 'peak_gb')}; the parent's: init "
          f"{ref['init_s']:.2f} s, prefill {ref['prefill_s']:.4f} s, MoE "
          f"grad {ref['grad_s']:.2f} s, peak {gb(ref['peak'])} ({note}; "
          f"{smi})")


def p12b_held(role: str, outs: list, ref: dict, note: str, smi: str
              ) -> None:
    """12b's checks on the ranks' outputs against the parent's."""
    cfg = OLMO
    L = cfg.n_layers
    want = {"flash_attention": 2 * L, "flash_attention_bwd_dq": L,
            "flash_attention_bwd_dkdv": L}
    for r, o in enumerate(outs):
        b = o["b"]
        check(all(n == want for n in b["per_step"]),
              f"12{role}b rank {r}: launches {b['per_step']}, want {want}")
        check(b["losses"] == outs[0]["b"]["losses"]
              and b["norms"] == outs[0]["b"]["norms"],
              f"12{role}b: the ranks' losses or norms differ")
    b0 = outs[0]["b"]
    for what in ("losses", "norms"):
        check(close(torch.tensor(b0[what]), torch.tensor(ref[what]),
                    CARD_CPU_LM_REL),
              f"12{role}b: {what} {b0[what]} vs the one-process "
              f"{ref[what]}")
    worst = {}
    for name in b0["gaps"]:
        med = max(o["b"]["gaps"][name][0] for o in outs)
        far = max(o["b"]["gaps"][name][1] for o in outs)
        mx = max(o["b"]["gaps"][name][2] for o in outs)
        check(med <= P12_GAP_MEDIAN and far <= P12_GAP_FAR_SHARE,
              f"12{role}b: {name} after step 1: median gap {med:.3g}, "
              f"share beyond {P12_GAP_FAR} {far:.3g}, largest {mx:.3g}")
        worst[name] = (med, far, mx)
    # the shards tile each parameter once: the blocks' sizes add up
    sizes = {k: math.prod(v[0])
             for k, v in LM.named_params(LM._leaves(cfg)).items()}
    for name, n in sizes.items():
        got = sum(math.prod(o["b"]["gaps"][name][3]) for o in outs)
        check(got == n, f"12{role}b: {name}'s shards hold {got} entries, "
              f"the parameter {n}")
    wm = max(worst, key=lambda k: worst[k][0])
    wf = max(worst, key=lambda k: worst[k][1])
    print(f"[phase12{role}b] olmo-1b at full width and depth ({L} layers), "
          f"mesh ({P12_WORLD}, 1), FSDP over data: {P12_STEPS} AdamW steps "
          f"of B {P12_OLMO_B} x S {P12_OLMO_S} (one sequence a rank); "
          f"losses {b0['losses']} vs the one-process step's {ref['losses']},"
          f" gradient norms {b0['norms']} vs {ref['norms']} (within "
          f"{CARD_CPU_LM_REL}); after step 1 every parameter's shards "
          f"against the one-process parameters: the largest median gap "
          f"{worst[wm][0]:.3g} ({wm}), the largest share beyond "
          f"{P12_GAP_FAR} {worst[wf][1]:.3g} ({wf}), the largest gap "
          f"{max(v[2] for v in worst.values()):.3g}; the shards tile every "
          f"parameter once; launches a step {want}; each rank's step "
          f"seconds {[[round(s, 3) for s in o['b']['secs']] for o in outs]},"
          f" peak GB {[[round(s, 3) for s in o['b']['peaks']] for o in outs]}"
          f", bytes gathered a step {p11_summary(outs, 'b', 'gathered_gb')}"
          f" GB (bf16 casts before the send, the embedding in f32; the "
          f"gradients' reduce-scatter in f32); the one-process step's "
          f"seconds {[round(s, 3) for s in ref['secs']]}, peak "
          f"{gb(ref['peak'])} ({note}; {smi})")


def phase12(seed: int, dev, smi: str) -> dict:
    """Phase 12 (module docstring): the parent's sides, then four gloo
    ranks sharing the card run 12a and 12b (and four NCCL ranks, one a
    card, where the machine has four cards).  Returns the ranks' launch
    counts, summed."""
    t_all = time.perf_counter()
    cfg = dataclasses.replace(KIMI, n_layers=1)
    E, d, ff, V = cfg.n_experts, cfg.d_model, cfg.moe_d_ff, cfg.vocab_size
    E_loc = E // P12_WORLD
    hd = cfg.resolved_head_dim
    attn = d * (cfg.n_heads * hd * 2 + cfg.n_kv_heads * hd * 2)
    print(f"[phase12] bytes reckoned: kimi's parent side (bf16, all "
          f"{E} experts) {gb(2 * cfg.n_params())}, freed before the spawn;"
          f" a rank {gb(2 * 3 * E_loc * d * ff)} of experts, "
          f"{gb(2 * 2 * V * d)} of embedding and head, {gb(2 * attn)} of "
          f"attention: {gb(2 * (3 * E_loc * d * ff + 2 * V * d + attn))}, "
          f"{gb(2 * P12_WORLD * (3 * E_loc * d * ff + 2 * V * d + attn))} "
          f"for {P12_WORLD} ranks; olmo-1b's f32 params "
          f"{gb(4 * OLMO.n_params())}, {gb(OLMO.n_params())} of them a "
          f"rank ({smi})")
    total = {}
    with tempfile.TemporaryDirectory(prefix="phase12-") as tmp:
        t = time.perf_counter()
        ref_a = p12a_reference(seed, dev, tmp)
        ref_b = p12b_reference(seed, dev, tmp)
        print(f"[phase12] the parent's sides took "
              f"{time.perf_counter() - t:.2f} s")
        roles = [("", P12_WORLD)]
        if torch.cuda.device_count() >= P12_WORLD:
            roles.insert(0, ("nccl", P12_WORLD))
        else:
            print(f"[phase12] {torch.cuda.device_count()} card(s): Phase 12 "
                  f"on NCCL, one rank a card, needs {P12_WORLD}; not run")
        for role, world in roles:
            t = time.perf_counter()
            spawn_ranks(p12_rank, (world, tmp, role, seed), world,
                        P12_TIMEOUT_S, f"phase 12{role}")
            outs = [torch.load(f"{tmp}/12{role}-rank{r}.pt",
                               weights_only=False) for r in range(world)]
            backend = outs[0]["backend"]
            check(all(o["backend"] == backend for o in outs),
                  f"12{role}: ranks chose different backends")
            check(backend == ("nccl" if role == "nccl" else "gloo"),
                  f"12{role} chose {backend}")
            for o in outs:
                total = add_counts(total, o["launches"])
            note = ("gloo stages CUDA tensors through the host: these times "
                    "say nothing of NCCL" if backend == "gloo" else
                    "one rank a card")
            p12a_held(role, outs, ref_a, note, smi)
            p12b_held(role, outs, ref_b, note, smi)
            print(f"[phase12{role}] backend {backend}, world size {world}, "
                  f"wall {time.perf_counter() - t:.2f} s")
    print(f"[phase12] wall {time.perf_counter() - t_all:.2f} s; the ranks' "
          f"launches {json.dumps(nonzero(total))}")
    return total


class Laps:
    """Seconds between calls on the host clock after a sync, by name."""

    def __init__(self):
        self.secs, self.t = {}, time.perf_counter()

    def __call__(self, name: str) -> None:
        torch.cuda.synchronize()
        t = time.perf_counter()
        self.secs[name] = round(t - self.t, 3)
        self.t = t


def p14_reckon() -> str:
    """Phase 14's bytes reckoned: a rank's shards and the whole sides."""
    olmo = dataclasses.replace(OLMO, n_layers=P14_OLMO_LAYERS)
    grok = dataclasses.replace(GROK, n_layers=1)
    d, ff, E = grok.d_model, grok.moe_d_ff, grok.n_experts
    hd = grok.resolved_head_dim
    attn = d * hd * (2 * grok.n_heads + 2 * grok.n_kv_heads) + d * E
    rg = sum(math.prod(s) for s, _ in M.param_specs(CONFIG).values())
    return (f"rankgraph2's encoders and aggregators {gb(4 * rg)} f32, "
            f"{gb(4 * rg / P14_WORLD)} a rank but for l2's bias; olmo-1b "
            f"at {P14_OLMO_LAYERS} layers {gb(4 * olmo.n_params())} f32, "
            f"{gb(olmo.n_params())} a rank; grok-1-314b's layer: experts "
            f"{gb(2 * 3 * E * d * ff)} bf16, attention and router "
            f"{gb(2 * attn)}, a rank {gb(2 * (3 * E * d * ff + attn) / P14_WORLD)}")


def grok_layer(cfg, seed: int, dev, ctx=None) -> dict:
    """One grok-1-314b layer at ``cfg`` in bf16: the attention, norms and
    router from a generator seeded ``seed + 171``, each expert's three
    matrices from its own (seeded ``p12_expert_seed(seed, 0, e)``), as
    ``init_params`` scales them; under ``ctx`` this rank's shards, each
    expert cut as it is drawn (no whole copy of the experts)."""
    d, hd, E, ff = cfg.d_model, cfg.resolved_head_dim, cfg.n_experts, \
        cfg.moe_d_ff
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    g = torch.Generator(dev).manual_seed(seed + 171)
    dt = torch.bfloat16

    def w(fan_in: int, *shape, gen=g):
        return torch.empty(shape, dtype=dt, device=dev).normal_(
            0.0, fan_in ** -0.5, generator=gen)
    p = {"wq": w(d, d, H * hd), "wk": w(d, d, Hkv * hd),
         "wv": w(d, d, Hkv * hd), "wo": w(H * hd, H * hd, d),
         "ln1": torch.ones(d, dtype=dt, device=dev),
         "ln2": torch.ones(d, dtype=dt, device=dev), "router": w(d, d, E)}
    lay = None if ctx is None else LM.param_layout(cfg, ctx)["layers"][0]

    def cut(name, x):
        if lay is None:
            return x
        return shard_of(x, lay[name], ctx)
    p = {k: cut(k, v) for k, v in p.items()}
    shapes = {"w_gate": (d, ff), "w_up": (d, ff), "w_down": (ff, d)}
    for n, shape in shapes.items():
        loc = cut(n, torch.empty((1,) + shape, device="meta")).shape[1:]
        p[n] = torch.empty((E,) + tuple(loc), dtype=dt, device=dev)
    for e in range(E):
        ge = torch.Generator(dev).manual_seed(p12_expert_seed(seed, 0, e))
        for n, shape in shapes.items():
            p[n][e] = cut(n, w(shape[0], *shape, gen=ge)[None])[0]
    return p


def p14_layer(lp, cfg, x, ctx, lay):
    """One layer of ``cfg`` on ``x`` (1, S, d) under ``ctx`` (grad off):
    its output (1, S, d) on every rank, each rank running its block of
    the sequence where the rules make the residual sequence-parallel."""
    S = x.shape[1]
    tp = LM._tp(ctx, S, True)
    pos = torch.arange(S, device=x.device)[None]
    if tp is not None and tp.seq:
        x = torch.chunk(x, tp.nm, dim=1)[tp.mi]
    out = LM._layer(lp, cfg, x, pos, None, 0, True, 1024, ctx, lay, tp)[0]
    if tp is not None and tp.seq:
        out = COLL.gather_split(out, 1, tp.group)
    return out


def p14a_reference(seed: int, dev, corpus, tmp: str) -> dict:
    """14a's parent side: ``P14_STEPS`` one-process rankgraph2 steps in
    f32 at full width on Phase 3's corpus (``P14_ROWS`` edges a type,
    whole-batch negatives: the (1, 4) mesh has one data rank), each
    step's RQ inputs, selections, histogram totals and codebooks kept;
    before them ``embed_side`` and ``assign_codes`` of the first users at
    each of ``P14_SERVE`` on the initial state (after the steps the two
    sides' parameters differ by their steps' rounding).  Writes the
    ranks' inputs."""
    cfg = dataclasses.replace(CONFIG, dtype="float32")
    lap = Laps()
    ds = EdgeDataset(corpus.tables, corpus.user_feat, corpus.item_feat,
                     k_train=cfg.k_train, device=dev, g=corpus.graph)
    feats = FeatureStore(ds.user_feat, ds.item_feat)
    per_type = {et: P14_ROWS for et in ("uu", "ui", "ii")}
    batches = [ds.sample_batch(t, seed + 14, per_type)
               for t in range(P14_STEPS)]
    lap("batches")
    g = torch.Generator().manual_seed(seed + 141)
    draws, metrics, codes, starts, secs = [], [], [], [], []
    state, opt = init_state(cfg, generator=torch.Generator().manual_seed(
        seed), pool_size=P3_POOL, device=dev)
    lap("init")
    with deterministic_sums():
        serve = {}
        with torch.no_grad():
            for n in P14_SERVE:
                side = ds.node_inference_batch(np.arange(n))
                _, prim = M.embed_side(state.params, cfg, side, M.USER)
                serve[n] = (prim.cpu(), assign_codes(
                    state.params["rq"], prim, cfg.rq).cpu())
        books0 = [b.detach().float().cpu() for b in layer_books(
            state.params["rq"], len(cfg.rq.codebook_sizes))]
        lap("serve")
        grad_step = make_grad_step(cfg, features=feats)
        for t in range(P14_STEPS):
            draws.append(draws_for(cfg, state.pool, batches[t], P14_ROWS, g))
            start = ([h.sum(dim=0) for h in state.rq_state.hists],
                     [b.detach().float().clone() for b in layer_books(
                         state.params["rq"], len(cfg.rq.codebook_sizes))])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sg = grad_step(state, batches[t], draws=draws[t])
            state, m = apply_grads(state, sg, opt)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            metrics.append({k: float(v) for k, v in m.items()})
            codes.append(sg.aux["codes"].cpu())
            starts.append((sg.aux["rq_input"].float(), *start))
            del sg
    lap("steps")
    cpu = torch.device("cpu")
    torch.save(dict(seed=seed, batches=p11_to(batches, cpu),
                    draws=p11_to(draws, cpu),
                    user_feat=ds.user_feat.cpu(), item_feat=ds.item_feat.cpu(),
                    tables=(corpus.tables.user_nbrs, corpus.tables.item_nbrs,
                            corpus.tables.n_users, corpus.tables.n_items)),
               f"{tmp}/p14a.pt")
    lap("save")
    out = dict(cfg=cfg, metrics=metrics, codes=codes, starts=starts,
               secs=secs, serve=serve, books=books0, laps=lap.secs)
    del state, ds, feats, batches
    torch.cuda.empty_cache()
    return out


def p14_replicated_hash(state) -> str:
    """``p11_state_hash`` of what every rank of a model group holds alike:
    the RQ codebooks, the log-variances, the pool and the RQ state."""
    h = hashlib.sha256()
    params = named_params(state.params)
    for t in ([params[k] for k in sorted(params)
               if k.startswith(("rq.", "uncertainty."))]
              + [state.pool.user, state.pool.item, *state.rq_state.hists,
                 *state.rq_state.usage]):
        h.update(t.detach().reshape(-1).view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()[:16]


def p14a_rank(tmp: str, dev, ctx) -> dict:
    """14a on this rank, mesh (1, 4): from the parent's initial state cut
    to the rank's shards (``shard_state``: 256 of the encoders' 1,024
    hidden units, one aggregator head) the serve batches' primaries and
    codes, then the parent's steps."""
    lap = Laps()
    spec = torch.load(f"{tmp}/p14a.pt", weights_only=False)
    cfg = dataclasses.replace(CONFIG, dtype="float32")
    feats = FeatureStore(spec["user_feat"].to(dev), spec["item_feat"].to(dev))
    lap("load")
    metrics, codes, starts, secs = [], [], [], []
    torch.cuda.reset_peak_memory_stats(dev)
    state, opt = init_state(cfg, generator=torch.Generator().manual_seed(
        spec["seed"]), pool_size=P3_POOL, device=dev)
    lap("init")
    state = shard_state(state, cfg, ctx)
    ds = EdgeDataset(NeighborTables(*spec["tables"]), feats.user_feat,
                     feats.item_feat, k_train=cfg.k_train, device=dev)
    lap("shard")
    with deterministic_sums():
        serve, serve_s = {}, {}
        with torch.no_grad():
            for n in P14_SERVE:
                side = ds.node_inference_batch(np.arange(n))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, prim = M.embed_side(state.params, cfg, side, M.USER, ctx)
                cd = assign_codes(state.params["rq"], prim, cfg.rq)
                torch.cuda.synchronize()
                serve_s[n] = time.perf_counter() - t0
                serve[n] = (prim.cpu(), cd.cpu())
        books0 = [b.detach().float().cpu() for b in layer_books(
            state.params["rq"], len(cfg.rq.codebook_sizes))]
        lap("serve")
        grad_step = make_grad_step(cfg, ctx, features=feats)
        for t in range(P14_STEPS):
            starts.append(([h.sum(dim=0).cpu() for h in state.rq_state.hists],
                           [b.detach().float().cpu() for b in layer_books(
                               state.params["rq"],
                               len(cfg.rq.codebook_sizes))]))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sg = grad_step(state, p11_to(spec["batches"][t], dev),
                           draws=p11_to(spec["draws"][t], dev))
            state, m = apply_grads(state, sg, opt)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            metrics.append({k: float(v) for k, v in m.items()})
            codes.append(sg.aux["codes"].cpu())
            del sg
    lap("steps")
    return dict(metrics=metrics, codes=codes, starts=starts, secs=secs,
                serve=serve, serve_s=serve_s, hash=p14_replicated_hash(state),
                books=books0, laps=lap.secs,
                peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                hidden=tuple(state.params["f_user"].l1.weight.shape),
                heads=tuple(state.params["agg_user"].w.shape))


def p14_olmo(dtype: str):
    return dataclasses.replace(OLMO, n_layers=P14_OLMO_LAYERS, dtype=dtype)


def p14b_steps(cfg, seed: int, dev, tmp: str, ctx=None, steps: int = 1,
               start=None):
    """``steps`` AdamW steps of olmo-1b's cut on the tokens in ``tmp``
    (under ``ctx`` on this rank's shards) from ``init_params`` seeded
    ``seed + 181``, or from ``start`` (parameters, optimizer, state):
    returns those after the steps and each step's loss, norm, gradients
    (``lm_loss_and_grads``, then ``lm_train_step``) and seconds.  Without
    ``ctx`` the parameters after the first of two or more steps are
    written for the ranks."""
    if start is None:
        params = LM.init_params(cfg, generator=torch.Generator(
            dev).manual_seed(seed + 181), device=dev)
        if ctx is not None:
            params = LM.shard_params(params, cfg, ctx)
        opt = OPT.make_optimizer(cfg.optimizer, shards=None if ctx is None
                                 else LM.shard_groups(cfg, ctx))
        st = opt.init(LM.named_params(params))
    else:
        params, opt, st = start
    toks = torch.load(f"{tmp}/p14b-tokens.pt").to(dev)
    out = []
    for t in range(steps):
        _, grads = lm_loss_and_grads(params, cfg, toks, ctx)
        grads = {k: g.detach() for k, g in grads.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, gnorm, st = lm_train_step(params, cfg, opt, st, toks, ctx)
        torch.cuda.synchronize()
        out.append((float(loss), float(gnorm), grads,
                    time.perf_counter() - t0))
        if t == 0 and ctx is None and steps > 1:
            torch.save({k: v.detach().cpu() for k, v in
                        LM.named_params(params).items()},
                       f"{tmp}/p14b-params1.pt")
    return (params, opt, st), out


def p14b_decode(cfg, params, dev, tmp: str, ctx=None) -> torch.Tensor:
    """One decode step of olmo-1b's bf16 cut on the caches and token in
    ``tmp`` (under the decode rules, ``ctx``, a rank's block of their
    positions: ``shard_caches``)."""
    spec = torch.load(f"{tmp}/p14b-decode.pt")
    caches = {k: v.to(dev) for k, v in spec["caches"].items()}
    if ctx is not None:
        caches = LM.shard_caches(caches, cfg, ctx)
    with torch.no_grad():
        logits, _ = LM.decode_step(params, cfg, spec["token"].to(dev), caches,
                                   P14_DECODE_T - 1, ctx=ctx)
    return logits.float().cpu()


def p14b_reference(seed: int, dev, tmp: str) -> dict:
    """14b's parent side: olmo-1b at full width, ``P14_OLMO_LAYERS`` of
    its 16 layers, two one-process AdamW steps in f32 compute (each
    step's gradients, and the parameters after the first, written for
    the ranks), one in bf16, and one bf16 decode step on random caches of
    ``P14_DECODE_T`` positions."""
    g = torch.Generator(dev).manual_seed(seed + 183)
    cfg32 = p14_olmo("float32")
    torch.save(lm_tokens(cfg32, g, 1, P14_OLMO_S, dev).cpu(),
               f"{tmp}/p14b-tokens.pt")
    _, f32 = p14b_steps(cfg32, seed, dev, tmp, steps=2)
    for t, (_, _, grads, _) in enumerate(f32):
        torch.save({k: v.cpu() for k, v in grads.items()},
                   f"{tmp}/p14b-grads{t}.pt")
    cfg16 = p14_olmo("bfloat16")
    _, b16 = p14b_steps(cfg16, seed, dev, tmp, steps=1)
    fresh = LM.init_params(cfg16, generator=torch.Generator(dev).manual_seed(
        seed + 181), device=dev)
    caches = random_caches(cfg16, 1, P14_DECODE_T, g, dev)
    torch.save(dict(caches={k: v.cpu() for k, v in caches.items()},
                    token=lm_tokens(cfg16, g, 1, 1, dev).cpu()),
               f"{tmp}/p14b-decode.pt")
    logits = p14b_decode(cfg16, fresh, dev, tmp)
    out = dict(f32=[(l, n, s) for l, n, _, s in f32],
               bf16=[(l, n, s) for l, n, _, s in b16], decode=logits)
    del fresh, caches, f32
    torch.cuda.empty_cache()
    return out


def p14b_rank(seed: int, dev, tmp: str, mesh) -> dict:
    """14b on this rank at mesh (1, 4) under olmo-1b's train rules (tensor
    and sequence parallelism): two f32 steps, the second from the
    parent's parameters after its first, each gradient's block held
    against the parent's
    (its squared gap and norm returned), one bf16 step, then one decode
    step under the decode rules."""
    train = next(s for s in LM_SHAPES if s.step == "train")
    ctx = ShardingCtx(lm_rules("olmo-1b", train, mesh), mesh)
    cfg32 = p14_olmo("float32")
    common.reset_launches()
    # the second step from the one-process parameters after the first:
    # AdamW's first update is about lr times each gradient's sign, so the
    # two sides' roundings would part their parameters before it
    start, f32 = p14b_steps(cfg32, seed, dev, tmp, ctx, steps=1)
    lay = LM.named_params(LM.param_layout(cfg32, ctx))
    saved = torch.load(f"{tmp}/p14b-params1.pt", mmap=True)
    with torch.no_grad():
        for k, v in LM.named_params(start[0]).items():
            v.copy_(shard_of(saved[k], lay[k], ctx))
    del saved
    f32 += p14b_steps(cfg32, seed, dev, tmp, ctx, start=start)[1]
    del start
    gaps = []
    for t, (_, _, grads, _) in enumerate(f32):
        want = torch.load(f"{tmp}/p14b-grads{t}.pt", mmap=True)
        gaps.append({})
        for k, g in grads.items():
            w = shard_of(want[k], lay[k], ctx).to(dev)
            gaps[t][k] = (float((g.float() - w).square().sum()),
                          float(w.square().sum()),
                          any(x is not None for x in lay[k]))
    cfg16 = p14_olmo("bfloat16")
    _, b16 = p14b_steps(cfg16, seed, dev, tmp, ctx, steps=1)
    decode = next(s for s in LM_SHAPES if s.name == "decode_32k")
    dctx = ShardingCtx(lm_rules("olmo-1b", decode, mesh), mesh)
    fresh = LM.shard_params(LM.init_params(
        cfg16, generator=torch.Generator(dev).manual_seed(seed + 181),
        device=dev), cfg16, dctx)
    logits = p14b_decode(cfg16, fresh, dev, tmp, dctx)
    launches = common.launch_counts()
    return dict(f32=[(l, n, s) for l, n, _, s in f32],
                bf16=[(l, n, s) for l, n, _, s in b16], gaps=gaps,
                decode=logits, launches=launches)


def p14c_params(arch: str, seed: int, dev, ctx=None):
    cfg = dataclasses.replace(get_arch(arch).config, n_layers=2)
    params = LM.init_params(cfg, generator=torch.Generator(dev).manual_seed(
        seed + 191), device=dev)
    return cfg, params if ctx is None else LM.shard_params(params, cfg, ctx)


def p14c_reference(seed: int, dev, tmp: str) -> dict:
    """14c's parent side: llama3.2-3b and gemma-2b at full width, 2
    layers, a one-process prefill of B 1 x S ``P14_PREFILL_S``."""
    out = {}
    for arch in P14_PREFILL_ARCHS:
        cfg, params = p14c_params(arch, seed, dev)
        toks = lm_tokens(cfg, torch.Generator(dev).manual_seed(seed + 193), 1,
                         P14_PREFILL_S, dev)
        torch.save(toks.cpu(), f"{tmp}/p14c-{arch}.pt")
        last, caches = lm_prefill_step(params, cfg, toks)
        out[arch] = (last.float().cpu(),
                     {k: v.cpu() for k, v in caches.items()})
        del params, caches
        torch.cuda.empty_cache()
    return out


def p14c_rank(seed: int, dev, tmp: str, mesh) -> dict:
    """14c on this rank at mesh (1, 4) under the prefill rules: the
    prefill's last logits (whole on every rank), its caches (the rank's
    KV heads) and flash-attention launches."""
    prefill = next(s for s in LM_SHAPES if s.step == "prefill")
    out = {}
    for arch in P14_PREFILL_ARCHS:
        ctx = ShardingCtx(lm_rules(arch, prefill, mesh), mesh)
        cfg, params = p14c_params(arch, seed, dev, ctx)
        toks = torch.load(f"{tmp}/p14c-{arch}.pt").to(dev)
        common.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last, caches = lm_prefill_step(params, cfg, toks, ctx)
        torch.cuda.synchronize()
        out[arch] = dict(last=last.float().cpu(),
                         caches={k: v.cpu() for k, v in caches.items()},
                         secs=time.perf_counter() - t0,
                         launches=common.launch_counts(),
                         heads=(LM.cache_heads(cfg, ctx),
                                ctx.axis_index("model")))
        del params, caches
        torch.cuda.empty_cache()
    return out


def p14d_reference(seed: int, dev, tmp: str) -> dict:
    """14d's parent side: one grok-1-314b layer at full width, bf16
    (9.66 GB of experts), on random inputs at each of ``P14_GROK_S``,
    without the embedding and head; freed before the spawn."""
    cfg = dataclasses.replace(GROK, n_layers=1)
    lp = grok_layer(cfg, seed, dev)
    out = {}
    g = torch.Generator(dev).manual_seed(seed + 197)
    block = LM._moe_block
    for kind, S in P14_GROK_S.items():
        x = torch.randn((1, S, cfg.d_model), generator=g, device=dev).to(
            torch.bfloat16)
        torch.save(x.cpu(), f"{tmp}/p14d-{kind}.pt")
        # one process takes the scatter; the dense loop where the ranks do
        if kind == "dense":
            LM._moe_block = lambda p, c, x_, ctx=None, lay=None: \
                LM._moe_dense(p, c, x_)
        try:
            with torch.no_grad():
                out[kind] = p14_layer(lp, cfg, x, None, None).float().cpu()
        finally:
            LM._moe_block = block
    del lp
    torch.cuda.empty_cache()
    return out


def p14d_rank(seed: int, dev, tmp: str, mesh) -> dict:
    """14d on this rank at mesh (1, 4) under grok's train rules: each
    expert split over ``expert_mlp`` (8,192 of its 32,768 ff columns a
    rank), the attention over heads, the residual over the sequence."""
    train = next(s for s in LM_SHAPES if s.step == "train")
    ctx = ShardingCtx(lm_rules("grok-1-314b", train, mesh), mesh)
    cfg = dataclasses.replace(GROK, n_layers=1)
    torch.cuda.reset_peak_memory_stats(dev)
    lp = grok_layer(cfg, seed, dev, ctx)
    lay = LM.param_layout(cfg, ctx)["layers"][0]
    out = {"ff": tuple(lp["w_gate"].shape)}
    for kind, S in P14_GROK_S.items():
        x = torch.load(f"{tmp}/p14d-{kind}.pt").to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            y = p14_layer(lp, cfg, x, ctx, lay)
        torch.cuda.synchronize()
        out[kind] = (y.float().cpu(), time.perf_counter() - t0,
                     LM.moe_dispatch(cfg, S, ctx))
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    del lp
    torch.cuda.empty_cache()
    return out


def p14_rank(rank: int, world: int, tmp: str, role: str, seed: int) -> None:
    """One rank of Phase 14 (``torch.multiprocessing.spawn``), mesh (1,
    world): 14a-14d, written with its launch counts to
    ``tmp/14<role>-rank<rank>.pt``."""
    import torch.distributed as dist
    backend, dev = init_distributed(rank, world, f"{tmp}/rdv14-{role}")
    if backend == "gloo":
        p11_gloo_cuda(rank, world, dev)
    mesh = make_mesh((1, world), ("data", "model"))
    out = {"backend": backend}
    t = time.perf_counter()
    common.reset_launches()
    out["a"] = p14a_rank(tmp, dev, ShardingCtx(make_rules(mesh), mesh))
    total = common.launch_counts()
    out["a_s"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    out["b"] = p14b_rank(seed, dev, tmp, mesh)
    total = add_counts(total, out["b"]["launches"])
    out["b_s"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    out["c"] = p14c_rank(seed, dev, tmp, mesh)
    for arch in P14_PREFILL_ARCHS:
        total = add_counts(total, out["c"][arch]["launches"])
    out["c_s"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    out["d"] = p14d_rank(seed, dev, tmp, mesh)
    out["d_s"] = time.perf_counter() - t
    out["launches"] = total
    torch.save(out, f"{tmp}/14{role}-rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def p14a_held(role: str, outs: list, ref: dict) -> str:
    """14a's checks; returns its line's body."""
    cfg = ref["cfg"]
    a0 = outs[0]["a"]
    check(len({o["a"]["hash"] for o in outs}) == 1,
          f"14{role}a: the ranks' replicated states differ")
    check(all(o["a"]["metrics"] == a0["metrics"] for o in outs),
          f"14{role}a: the ranks' losses differ")
    check(a0["hidden"] == (cfg.d_hidden // P14_WORLD, cfg.d_user_feat)
          and a0["heads"][0] == cfg.n_heads // P14_WORLD,
          f"14{role}a: shards {a0['hidden']} and {a0['heads']}")
    gaps = [f32_gap(x, y) for x, y in zip(a0["metrics"], ref["metrics"])]
    check(max(gaps) <= 1, f"14{role}a: losses {a0['metrics']} vs the plain "
          f"step's {ref['metrics']}")
    flips = []
    for t in range(P14_STEPS):
        h, tot_p, books_p = ref["starts"][t]
        tot_k, books_k = a0["starts"][t]
        n, lead = selection_ties(h, a0["codes"][t], ref["codes"][t], books_p,
                                 books_k, tot_p, tot_k, cfg.rq,
                                 f"14{role}a step {t}")
        flips.append((n, round(lead, 4)))
    sizes = cfg.rq.codebook_sizes
    serve = []
    for n in P14_SERVE:
        pk, ck = a0["serve"][n]
        pp, cp = ref["serve"][n]
        check(all(torch.equal(o["a"]["serve"][n][0], pk) for o in outs),
              f"14{role}a: the ranks' primaries differ at {n} rows")
        rel = float((pk - pp).norm() / pp.norm())
        check(rel <= P14_F32_REL, f"14{role}a serve {n}: primaries {rel:.3g}"
              f" apart, past {P14_F32_REL}")
        check(all(torch.equal(x, y) for x, y in zip(ref["books"],
                                                     a0["books"])),
              f"14{role}a: the initial codebooks differ")
        near = near_ties(pp, torch.from_numpy(layer_codes(ck, sizes)),
                         torch.from_numpy(layer_codes(cp, sizes)),
                         ref["books"], f"14{role}a serve {n}")
        serve.append(f"{n} rows: primaries {rel:.3g} apart (norm-wise), "
                     f"codes differing {near} (near ties), seconds "
                     f"{[round(o['a']['serve_s'][n], 4) for o in outs]}")
    return (f"rankgraph2 at full width (d_hidden {cfg.d_hidden}, "
            f"{cfg.n_heads} heads, d_embed {cfg.d_embed}, RQ "
            f"{' x '.join(map(str, sizes))}, f32), a rank "
            f"{a0['hidden'][0]} hidden units and {a0['heads'][0]} head: "
            f"{P14_STEPS} steps of {P14_ROWS} edges a type against the "
            f"plain step (deterministic sums on both): loss gaps "
            f"{[round(x, 3) for x in gaps]} of the f32 tolerance, selections "
            f"differing (rows, largest lead over its allowance) {flips}; the "
            f"replicated state bitwise equal on every rank ({a0['hash']}); "
            f"serve {'; '.join(serve)}; step seconds "
            f"{[[round(x, 3) for x in o['a']['secs']] for o in outs]} (the "
            f"plain step's {[round(x, 3) for x in ref['secs']]}), peak GB "
            f"{[round(o['a']['peak_gb'], 3) for o in outs]}; stage seconds, "
            f"a rank {a0['laps']}, the parent {ref['laps']}")


def p14b_held(role: str, outs: list, ref: dict) -> str:
    b0 = outs[0]["b"]
    for o in outs:
        check([x[:2] for x in o["b"]["f32"]] == [x[:2] for x in b0["f32"]],
              f"14{role}b: the ranks' losses or norms differ")
    rel = []
    for side, want in (("f32", ref["f32"]), ("bf16", ref["bf16"])):
        for t, ((lk, nk, _), (lp, np_, _)) in enumerate(zip(b0[side], want)):
            r = abs(lk - lp) / abs(lp)
            tol = P14_F32_REL if side == "f32" else BF16_LM_TOL
            check(r <= tol, f"14{role}b {side} step {t}: loss {lk} vs the "
                  f"one-process {lp}")
            if side == "f32":
                check(abs(nk - np_) <= P14_F32_REL * np_, f"14{role}b f32 "
                      f"step {t}: norm {nk} vs {np_}")
            rel.append(round(r, 9))
    worst = []
    for t in range(2):
        # each leaf norm-wise: a split leaf's blocks' squared gaps and
        # norms summed over the ranks, a whole leaf's from rank 0
        per = {}
        for k, (_, _, split) in b0["gaps"][t].items():
            parts = [o["b"]["gaps"][t][k] for o in (outs if split
                                                    else outs[:1])]
            per[k] = (sum(p[0] for p in parts)
                      / max(sum(p[1] for p in parts), 1e-30)) ** 0.5
        k = max(per, key=per.get)
        check(per[k] <= P14_F32_REL, f"14{role}b f32 step {t}: {k}'s "
              f"gradient {per[k]:.3g} apart, norm-wise")
        worst.append((k, float(f"{per[k]:.3g}")))
    gap = near(b0["decode"], ref["decode"], BF16_LM_TOL)
    check(all(torch.equal(o["b"]["decode"], b0["decode"]) for o in outs),
          f"14{role}b: the ranks' decode logits differ")
    check(gap <= 1, f"14{role}b decode: logits {gap:.3g} of {BF16_LM_TOL}")
    L = P14_OLMO_LAYERS
    for r, o in enumerate(outs):
        got = nonzero(o["b"]["launches"])
        check(set(got) == P14B_KERNELS, f"14{role}b rank {r}: launches "
              f"{got}, want each of {sorted(P14B_KERNELS)}")
    return (f"olmo-1b at full width, {L} of 16 layers, B 1 x S "
            f"{P14_OLMO_S}, train rules (heads, mlp and vocab over model, "
            f"the residual over the sequence): 2 AdamW steps in f32 compute, "
            f"losses {[x[0] for x in b0['f32']]} vs "
            f"{[x[0] for x in ref['f32']]}, each gradient's worst leaf "
            f"{worst} (limit {P14_F32_REL}); a bf16 step's loss "
            f"{b0['bf16'][0][0]} vs {ref['bf16'][0][0]} (relative gaps "
            f"{rel}); a decode step under the decode rules (heads whole, "
            f"mlp and vocab split, the caches' positions over kv_seq) on "
            f"{P14_DECODE_T} cached positions: "
            f"logits {gap:.3g} of {BF16_LM_TOL}; step seconds "
            f"{[[round(x[2], 3) for x in o['b']['f32']] for o in outs]} "
            f"(one process {[round(x[2], 3) for x in ref['f32']]}); launches "
            f"a rank {nonzero(b0['launches'])}")


def p14c_held(role: str, outs: list, ref: dict) -> str:
    parts = []
    for arch in P14_PREFILL_ARCHS:
        last_p, caches_p = ref[arch]
        cfg = get_arch(arch).config
        c0 = outs[0]["c"][arch]
        gap = near(c0["last"], last_p, BF16_LM_TOL)
        check(gap <= 1, f"14{role}c {arch}: last logits {gap:.3g} of "
              f"{BF16_LM_TOL}")
        cg = 0.0
        for o in outs:
            c = o["c"][arch]
            check(torch.equal(c["last"], c0["last"]),
                  f"14{role}c {arch}: the ranks' logits differ")
            h, mi = c["heads"]
            check(c["caches"]["k"].shape[3] == h, f"14{role}c {arch}: "
                  f"caches of {c['caches']['k'].shape[3]} heads, want {h}")
            lo = mi * h if h < cfg.n_kv_heads else 0
            for k in ("k", "v"):
                cg = max(cg, near(c["caches"][k],
                                  caches_p[k][:, :, :, lo:lo + h],
                                  BF16_LM_TOL))
            got = {k: v for k, v in c["launches"].items() if v}
            check(got == {"flash_attention": 2}, f"14{role}c {arch}: "
                  f"launches {got}")
        check(cg <= 1, f"14{role}c {arch}: caches {cg:.3g} of {BF16_LM_TOL}")
        h = c0["heads"][0]
        parts.append(f"{arch} ({cfg.n_heads // P14_WORLD} query heads over "
                     f"{h} KV head{'s' if h > 1 else ''} a rank): last "
                     f"logits {gap:.3g}, the ranks' caches against their "
                     f"heads of the one-process caches {cg:.3g} of "
                     f"{BF16_LM_TOL}, 2 flash_attention launches a rank, "
                     f"seconds {[round(o['c'][arch]['secs'], 3) for o in outs]}")
    return (f"prefill B 1 x S {P14_PREFILL_S}, 2 layers at full width, "
            f"prefill rules: " + "; ".join(parts))


def p14d_held(role: str, outs: list, ref: dict) -> str:
    d0 = outs[0]["d"]
    parts = []
    for kind in P14_GROK_S:
        y0 = d0[kind][0]
        check(all(torch.equal(o["d"][kind][0], y0) for o in outs),
              f"14{role}d {kind}: the ranks' outputs differ")
        check(all(o["d"][kind][2] == kind for o in outs),
              f"14{role}d {kind}: dispatch {d0[kind][2]}")
        gap = near(y0, ref[kind], BF16_LM_TOL)
        check(gap <= 1, f"14{role}d {kind}: output {gap:.3g} of "
              f"{BF16_LM_TOL}")
        parts.append(f"S {P14_GROK_S[kind]} ({kind}): output {gap:.3g} of "
                     f"{BF16_LM_TOL}, seconds "
                     f"{[round(o['d'][kind][1], 3) for o in outs]}")
    return (f"one grok-1-314b layer at full width, bf16, train rules, a "
            f"rank's experts {d0['ff']} (expert_mlp over model): "
            + "; ".join(parts) + f"; peak GB "
            f"{[round(o['d']['peak_gb'], 3) for o in outs]}")


def phase14(seed: int, dev, corpus, smi: str) -> dict:
    """Phase 14 (module docstring): the parent's sides, then four gloo
    ranks sharing the card run 14a-14d (and four NCCL ranks, one a card,
    where the machine has four cards).  Returns the ranks' launch
    counts, summed."""
    t_all = time.perf_counter()
    print(f"[phase14] bytes reckoned: {p14_reckon()} ({smi})")
    total = {}
    with tempfile.TemporaryDirectory(prefix="phase14-") as tmp:
        ref, ref_s = {}, {}
        for part, fn in (("a", lambda: p14a_reference(seed, dev, corpus,
                                                      tmp)),
                         ("b", lambda: p14b_reference(seed, dev, tmp)),
                         ("c", lambda: p14c_reference(seed, dev, tmp)),
                         ("d", lambda: p14d_reference(seed, dev, tmp))):
            t = time.perf_counter()
            ref[part] = fn()
            ref_s[part] = round(time.perf_counter() - t, 2)
        print(f"[phase14] the parent's sides took {sum(ref_s.values()):.2f}"
              f" s (14a-14d: {list(ref_s.values())})")
        roles = [("", P14_WORLD)]
        if torch.cuda.device_count() >= P14_WORLD:
            roles.insert(0, ("nccl", P14_WORLD))
        for role, world in roles:
            t = time.perf_counter()
            spawn_ranks(p14_rank, (world, tmp, role, seed), world,
                        P14_TIMEOUT_S, f"phase 14{role}")
            print(f"[phase14{role}] the ranks took "
                  f"{time.perf_counter() - t:.2f} s")
            outs = [torch.load(f"{tmp}/14{role}-rank{r}.pt",
                               weights_only=False) for r in range(world)]
            backend = outs[0]["backend"]
            check(backend == ("nccl" if role == "nccl" else "gloo"),
                  f"14{role} chose {backend}")
            for o in outs:
                total = add_counts(total, o["launches"])
            note = ("gloo stages CUDA tensors through the host: these times "
                    "say nothing of NCCL" if backend == "gloo" else
                    "one rank a card")
            secs = {p: [round(o[f"{p}_s"], 2) for o in outs]
                    for p in "abcd"}
            failed = []
            for part, held in (("a", p14a_held), ("b", p14b_held),
                               ("c", p14c_held), ("d", p14d_held)):
                try:        # every part's line, then the first failure
                    line = held(role, outs, ref[part])
                except AssertionError as e:
                    failed.append(str(e))
                    line = f"FAILED: {e}"
                print(f"[phase14{role}{part}] mesh (1, {world}), backend "
                      f"{backend}: {line}; each rank's seconds "
                      f"{secs[part]} ({note}; {smi})", flush=True)
            print(f"[phase14{role}] wall {time.perf_counter() - t:.2f} s")
            for what in failed:
                check(False, what)
    print(f"[phase14] wall {time.perf_counter() - t_all:.2f} s; the ranks' "
          f"launches {json.dumps(nonzero(total))}")
    return total


# ---------------------------------------------------------------------------
# Phase 15: the recsys family's tensor parallelism, the decode rules'
# sequence-sharded KV cache
# ---------------------------------------------------------------------------

def p15a_cfgs(arch: str) -> tuple:
    """(f32, bf16) configs of a recsys arch at Phase 11's cut."""
    cfg = p11_kind_cfg(arch)
    return dataclasses.replace(cfg, dtype="float32"), cfg


def p15a_inputs(arch: str, seed: int, dev, ctx=None) -> tuple:
    """(parameters, batch): ``init_params`` from the arch's own seed (under
    ``ctx`` this rank's shards of the same draws) and its train batch of
    ``P15A_ROWS`` rows (dlrm: multi-hot bags of 1..``BAG`` ids)."""
    i = P15_KINDS.index(arch)
    cfg = p11_kind_cfg(arch)
    params = R.init_params(cfg, generator=torch.Generator(dev).manual_seed(
        seed + 211 + i), device=dev, ctx=ctx)
    g = torch.Generator(dev).manual_seed(seed + 221 + i)
    batch = (recsys_batch(cfg, g, P15A_ROWS, dev, bags=BAG)
             if cfg.kind == "dlrm" else
             p11_train_batch(cfg, g, P15A_ROWS, dev))
    return params, batch


class relu_masks:
    """Inside the block every ReLU of the recsys models (``_mlp``'s
    ``act``, the ``F.relu`` calls) records its input's mask ``x > 0`` in
    ``masks`` and applies it (the ReLU itself), or with ``replay`` applies
    ``masks`` in call order instead of its own: ``x * mask``, the mask the
    rank's column block (``mi`` of the model group) where the rank's input
    is its block of the parent's columns.  Both sides then take the same
    masks, so a ReLU whose input lies within rounding of zero cannot flip
    between them."""

    def __init__(self, masks: list, replay: bool = False, mi: int = 0):
        self.masks, self.replay, self.mi = masks, replay, mi
        self.i = 0

    def relu(self, x, inplace=False):
        if not self.replay:
            m = x > 0
            self.masks.append(m.detach())
            return x * m.to(x.dtype)
        m = self.masks[self.i].to(x.device)
        self.i += 1
        if m.shape != x.shape:
            m = m.chunk(m.shape[-1] // x.shape[-1], dim=-1)[self.mi]
        check(m.shape == x.shape, f"a ReLU's mask {tuple(m.shape)} does "
              f"not fit its input {tuple(x.shape)}")
        return x * m.to(x.dtype)

    def __enter__(self):
        import torch.nn.functional as F
        self.real = F.relu
        self.kw = R._mlp.__kwdefaults__
        self.act = self.kw["act"]
        F.relu = self.kw["act"] = self.relu
        return self

    def __exit__(self, *exc):
        import torch.nn.functional as F
        F.relu = self.real
        self.kw["act"] = self.act
        return False


def p15a_run(arch: str, params, batch, ctx=None, masks=None) -> dict:
    """f32: the serve outputs, the loss and the dense leaves' gradients
    (those ``ROW_SHARDED`` does not name) from the models' own ReLUs;
    with ``masks`` (a rank) also the dense gradients of a pass whose
    ReLUs take the parent's masks (``masked``), without them (the parent)
    the masks its own ReLUs took, which are its gradients' too; bf16: the
    serve outputs."""
    c32, c16 = p15a_cfgs(arch)
    out32 = recsys_serve_step(params, c32, batch, ctx)
    rec = masks is None

    def dense(grads):
        return {k: g.detach() for k, g in grads.items()
                if k.split(".")[0] not in R.ROW_SHARDED[c32.kind]}
    masks = [] if rec else masks
    mi = 0 if ctx is None else ctx.axis_index("model")
    # the parent records its masks in its own pass (x * (x > 0) is its
    # ReLU, gradient too); a rank runs its own ReLUs, then the masks
    if rec:
        with relu_masks(masks, mi=mi):
            loss, grads = loss_and_grads(params, c32, batch, ctx)
    else:
        loss, grads = loss_and_grads(params, c32, batch, ctx)
    own = dense(grads)
    del grads
    masked = None
    if not rec:
        with relu_masks(masks, replay=True, mi=mi):
            masked = dense(loss_and_grads(params, c32, batch, ctx)[1])
    out16 = recsys_serve_step(params, c16, batch, ctx)
    return dict(out32=out32.float(), loss=float(loss), dense=own,
                masked=masked, out16=out16.float(),
                masks=masks if rec else None)


def p15a_reference(seed: int, dev, tmp: str) -> dict:
    """15a's one-process side on the card, written for the ranks."""
    secs = {}
    for arch in P15_KINDS:
        t = time.perf_counter()
        params, batch = p15a_inputs(arch, seed, dev)
        res = p15a_run(arch, params, batch)
        torch.save([m.cpu() for m in res.pop("masks")],
                   f"{tmp}/p15a-{arch}-masks.pt")
        torch.save({k: ({n: g.cpu() for n, g in v.items()}
                        if k == "dense" else
                        v.cpu() if torch.is_tensor(v) else v)
                    for k, v in res.items()}, f"{tmp}/p15a-{arch}.pt")
        del params, batch, res
        torch.cuda.empty_cache()
        secs[arch] = round(time.perf_counter() - t, 2)
    return secs


def p15a_rank(seed: int, dev, tmp: str) -> dict:
    """15a on this rank at each of ``P15_MESHES`` under the default rules
    (``mlp``, ``heads`` and ``table_rows`` over ``model``): each kind's
    shards, the same batch, and the gaps to the parent's outputs, loss
    and dense gradients (each leaf's block, by ``param_layout``)."""
    out = {}
    for shape in P15_MESHES:
        mesh = make_mesh(shape, ("data", "model"))
        ctx = ShardingCtx(make_rules(mesh), mesh)
        m = f"{shape[0]}x{shape[1]}"
        for arch in P15_KINDS:
            torch.cuda.synchronize()
            t = time.perf_counter()
            params, batch = p15a_inputs(arch, seed, dev, ctx)
            got = p15a_run(arch, params, batch, ctx,
                           torch.load(f"{tmp}/p15a-{arch}-masks.pt"))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
            ref = torch.load(f"{tmp}/p15a-{arch}.pt")
            lay = R.param_layout(p11_kind_cfg(arch), ctx)
            grad_gap, masked_gap, split = {}, {}, []
            for k, g in got["dense"].items():
                w = shard_of(ref["dense"][k], lay[k], ctx).to(dev)
                wn = max(float(w.norm()), 1e-30)
                grad_gap[k] = float((g.float() - w).norm() / wn)
                masked_gap[k] = float((got["masked"][k].float() - w).norm()
                                      / wn)
                if any(lay[k]):
                    split.append(k)
            out[f"{m}/{arch}"] = dict(
                out32=near(got["out32"], ref["out32"], P15_F32_REL),
                loss=abs(got["loss"] - ref["loss"]) / abs(ref["loss"]),
                grad=max(grad_gap.values()),
                worst=max(grad_gap, key=grad_gap.get),
                masked=max(masked_gap.values()),
                worst_masked=max(masked_gap, key=masked_gap.get),
                out16=near(got["out16"], ref["out16"], P15_BF16_OUT),
                split=len(split), secs=secs)
            del params, batch, got, ref
            torch.cuda.empty_cache()
    return out


def p15_decode_cases() -> list:
    """(tag, arch, shape name, mesh, B, T): 15b's two archs under
    decode_32k's rules at (1, 4), B 8; 15c's llama under long_500k's at
    (2, 2), B 1 (the batch whole over the data ranks)."""
    return ([(f"b/{a}", a, "decode_32k", (1, 4), P5_DECODE_B, P15_DECODE_T)
             for a in P15_DECODE_ARCHS]
            + [("c/llama3.2-3b", "llama3.2-3b", "long_500k", (2, 2), 1,
                P15_LONG_T)])


def p15_lens(T: int) -> tuple:
    """T - 1 (every block holds keys), T / 4 (the first position of block
    1 of 4), T / 4 + 100 (blocks 2 and 3 hold none)."""
    return (T - 1, T // 4, T // 4 + 100)


def p15_decode_inputs(arch: str, B: int, T: int, cache_len: int, seed: int,
                      dev, ctx=None) -> tuple:
    """(parameters, caches, token) of a 15b/15c step: ``init_params`` at
    ``P15_LAYERS`` layers and N(0, 1) bf16 caches, each from its own seed
    (under ``ctx`` this rank's shards and block of the same draws)."""
    cfg = dataclasses.replace(get_arch(arch).config, n_layers=P15_LAYERS)
    i = P15_DECODE_ARCHS.index(arch)
    params = LM.init_params(cfg, generator=torch.Generator(dev).manual_seed(
        seed + 231 + i), device=dev)
    g = torch.Generator(dev).manual_seed(seed + 241 + i + cache_len % 97)
    caches = random_caches(cfg, B, T, g, dev)
    tok = lm_tokens(cfg, g, B, 1, dev)
    if ctx is not None:
        params = LM.shard_params(params, cfg, ctx)
        caches = LM.shard_caches(caches, cfg, ctx)
    return cfg, params, caches, tok


def p15_decode_reference(seed: int, dev, tmp: str) -> dict:
    """15b's and 15c's one-process steps on whole caches: each step's
    logits and the new key and value at ``cache_len``, written for the
    ranks."""
    secs = {}
    for tag, arch, _, _, B, T in p15_decode_cases():
        t = time.perf_counter()
        for n in p15_lens(T):
            cfg, params, caches, tok = p15_decode_inputs(arch, B, T, n,
                                                         seed, dev)
            with torch.no_grad():
                logits, caches = LM.decode_step(params, cfg, tok, caches, n)
            torch.save(dict(logits=logits.float().cpu(),
                            k=caches["k"][:, :, n].cpu(),
                            v=caches["v"][:, :, n].cpu()),
                       f"{tmp}/p15-{tag.replace('/', '-')}-{n}.pt")
            del params, caches, logits
            torch.cuda.empty_cache()
        secs[tag] = round(time.perf_counter() - t, 2)
    return secs


def p15_decode_rank(seed: int, dev, tmp: str) -> dict:
    """15b and 15c on this rank: each case's rules (``lm_rules``) at its
    mesh, each ``cache_len`` from fresh draws: the rank's block
    (``shard_caches``), one ``decode_step``, and what it held: the logits'
    gap to the parent's, its block after the step equal to its block
    before it but at the new position (written only where the block holds
    it, there near the parent's new key and value), and its
    ``flash_attention_decode`` launches (one a layer where its block
    holds a key, none elsewhere)."""
    out = {}
    for tag, arch, shape_name, shape, B, T in p15_decode_cases():
        mesh = make_mesh(shape, ("data", "model"))
        sh = next(s for s in LM_SHAPES if s.name == shape_name)
        ctx = ShardingCtx(lm_rules(arch, sh, mesh), mesh)
        for n in p15_lens(T):
            cfg, params, caches, tok = p15_decode_inputs(arch, B, T, n,
                                                         seed, dev, ctx)
            seq = LM._kv_seq(ctx)
            t_loc = caches["k"].shape[2]
            lo = seq.j * t_loc
            before = {k: c.clone() for k, c in caches.items()}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            common.reset_launches()
            t = time.perf_counter()
            with torch.no_grad():
                logits, caches = LM.decode_step(params, cfg, tok, caches, n,
                                                ctx=ctx)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
            launches = common.launch_counts().get("flash_attention_decode",
                                                  0)
            ref = torch.load(f"{tmp}/p15-{tag.replace('/', '-')}-{n}.pt")
            mine = lo <= n < lo + t_loc
            same = True
            new_gap = 0.0
            for k in ("k", "v"):
                diff = (caches[k] != before[k]).transpose(0, 2).reshape(
                    t_loc, -1).any(dim=1)
                if mine:
                    diff[n - lo] = False
                    new_gap = max(new_gap, near(caches[k][:, :, n - lo],
                                                ref[k], BF16_LM_TOL))
                same = same and not bool(diff.any())
            kv_len = min(max(n + 1 - lo, 0), t_loc)
            out[f"{tag}/{n}"] = dict(
                logits=near(logits, ref["logits"], BF16_LM_TOL),
                bits=sha16(logits), same=same, mine=mine,
                new_gap=new_gap, launches=launches,
                want=cfg.n_layers if kv_len else 0, kv_len=kv_len,
                block=seq.j, secs=secs,
                cache_gb=sum(c.numel() * c.element_size()
                             for c in caches.values()) / 1e9,
                fold_kb=B * cfg.n_heads * (cfg.resolved_head_dim + 1)
                * 4 / 1e3,
                peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
            del params, caches, before, logits
            torch.cuda.empty_cache()
    return out


def p15_rank(rank: int, world: int, tmp: str, role: str, seed: int) -> None:
    """One rank of Phase 15 (``torch.multiprocessing.spawn``): 15a, then
    15b and 15c, written with its launch counts to
    ``tmp/15<role>-rank<rank>.pt``."""
    import torch.distributed as dist
    backend, dev = init_distributed(rank, world, f"{tmp}/rdv15-{role}")
    if backend == "gloo":
        p11_gloo_cuda(rank, world, dev)
    out = {"backend": backend}
    common.reset_launches()
    t = time.perf_counter()
    out["a"] = p15a_rank(seed, dev, tmp)
    total = common.launch_counts()
    out["a_s"] = time.perf_counter() - t
    t = time.perf_counter()
    out["bc"] = p15_decode_rank(seed, dev, tmp)
    total = add_counts(total, {"flash_attention_decode": sum(
        o["launches"] for o in out["bc"].values())})
    out["bc_s"] = time.perf_counter() - t
    out["launches"] = total
    torch.save(out, f"{tmp}/15{role}-rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def p15a_held(role: str, outs: list) -> str:
    """Every kind's line at both meshes; raises with them all and each
    failed check after the last."""
    parts, failed = [], []
    for shape in P15_MESHES:
        m = f"{shape[0]}x{shape[1]}"
        for arch in P15_KINDS:
            rs = [o["a"][f"{m}/{arch}"] for o in outs]
            worst = {k: max(r[k] for r in rs)
                     for k in ("out32", "loss", "grad", "masked", "out16")}
            gw = max(rs, key=lambda r: r["grad"])["worst"]
            mw = max(rs, key=lambda r: r["masked"])["worst_masked"]
            # ``grad`` from the ranks' own ReLUs, ``masked`` from a pass on
            # the parent's masks (``relu_masks``): flip-free, so held at
            # P15_GRAD_FLIPFREE
            what = f"15{role}a {arch} at ({shape[0]}, {shape[1]})"
            for ok, why in (
                    (all(r["split"] > 0 for r in rs),
                     "no dense leaf split over the model axis"),
                    (worst["out32"] <= 1, f"f32 outputs {worst['out32']:.3g}"
                     f" of {P15_F32_REL} of the largest"),
                    (worst["loss"] <= P15_F32_REL,
                     f"loss {worst['loss']:.3g} relative"),
                    (worst["grad"] <= P15_GRAD_REL, f"a dense gradient block "
                     f"{worst['grad']:.3g} apart norm-wise ({gw})"),
                    (worst["masked"] <= P15_GRAD_FLIPFREE, f"a dense "
                     f"gradient block on the parent's ReLU masks "
                     f"{worst['masked']:.3g} apart norm-wise ({mw}), past "
                     f"{P15_GRAD_FLIPFREE}"),
                    (worst["out16"] <= 1, f"bf16 outputs {worst['out16']:.3g}"
                     f" of {P15_BF16_OUT} of the largest")):
                if not ok:
                    failed.append(f"{what}: {why}")
            parts.append(f"{arch} ({shape[0]}, {shape[1]}): f32 out "
                         f"{worst['out32'] * P15_F32_REL:.3g}, loss "
                         f"{worst['loss']:.3g}, dense grads "
                         f"{worst['grad']:.3g} ({gw}), on the parent's ReLU "
                         f"masks {worst['masked']:.3g} ({mw}; "
                         f"{rs[0]['split']} split dense leaves), bf16 "
                         f"out {worst['out16'] * P15_BF16_OUT:.3g}; "
                         f"{max(r['secs'] for r in rs):.2f} s")
    check(not failed, "; ".join(parts) + " -- " + "; ".join(failed))
    return f"{P15A_ROWS:,} rows a batch: " + "; ".join(parts)


def p15_decode_held(role: str, outs: list) -> str:
    parts = []
    for tag, arch, shape_name, shape, B, T in p15_decode_cases():
        for n in p15_lens(T):
            rs = [o["bc"][f"{tag}/{n}"] for o in outs]
            what = f"15{role}{tag} cache_len {n}"
            worst = max(r["logits"] for r in rs)
            check(worst <= 1, f"{what}: logits {worst:.3g} of "
                  f"{BF16_LM_TOL} of the largest")
            check(all(r["same"] for r in rs), f"{what}: a block changed "
                  f"besides the new position")
            check(sum(r["mine"] for r in rs) == (shape[0] if shape_name
                                                 == "decode_32k" else 1),
                  f"{what}: the new position written on "
                  f"{sum(r['mine'] for r in rs)} ranks")
            check(max(r["new_gap"] for r in rs) <= 1, f"{what}: the new "
                  f"key or value off the parent's")
            check(all(r["launches"] == r["want"] for r in rs), f"{what}: "
                  f"launches {[r['launches'] for r in rs]}, want "
                  f"{[r['want'] for r in rs]} (none where a block holds "
                  f"no key)")
            check(len({r["bits"] for r in rs}) == 1, f"{what}: the ranks' "
                  f"logits differ")
            parts.append(
                f"{tag[2:]} {shape_name} ({shape[0]}, {shape[1]}) B {B} T "
                f"{T} cache_len {n}: logits {worst * BF16_LM_TOL:.3g}, "
                f"kv_len by rank {[r['kv_len'] for r in rs]}, launches "
                f"{[r['launches'] for r in rs]}, cache "
                f"{rs[0]['cache_gb']:.3f} GB a rank, fold "
                f"{rs[0]['fold_kb']:.1f} KB a layer a rank, step seconds "
                f"{[round(r['secs'], 3) for r in rs]}, peak "
                f"{max(r['peak_gb'] for r in rs):.2f} GB")
    return "; ".join(parts)


def phase15(seed: int, dev, smi: str) -> dict:
    """Phase 15 (module docstring): the parent's sides, then four gloo
    ranks sharing the card run 15a-15c (and four NCCL ranks, one a card,
    where the machine has four cards).  Returns the ranks' launch counts,
    summed."""
    t_all = time.perf_counter()
    total = {}
    with tempfile.TemporaryDirectory(prefix="phase15-") as tmp:
        t = time.perf_counter()
        ref_s = {"a": p15a_reference(seed, dev, tmp),
                 "bc": p15_decode_reference(seed, dev, tmp)}
        torch.cuda.empty_cache()
        print(f"[phase15] the parent's sides took "
              f"{time.perf_counter() - t:.2f} s ({ref_s})")
        roles = [("", P15_WORLD)]
        if torch.cuda.device_count() >= P15_WORLD:
            roles.insert(0, ("nccl", P15_WORLD))
        for role, world in roles:
            t = time.perf_counter()
            spawn_ranks(p15_rank, (world, tmp, role, seed), world,
                        P15_TIMEOUT_S, f"phase 15{role}")
            print(f"[phase15{role}] the ranks took "
                  f"{time.perf_counter() - t:.2f} s")
            outs = [torch.load(f"{tmp}/15{role}-rank{r}.pt",
                               weights_only=False) for r in range(world)]
            backend = outs[0]["backend"]
            check(backend == ("nccl" if role == "nccl" else "gloo"),
                  f"15{role} chose {backend}")
            for o in outs:
                total = add_counts(total, o["launches"])
            note = ("gloo stages CUDA tensors through the host: these times "
                    "say nothing of NCCL" if backend == "gloo" else
                    "one rank a card")
            failed = []
            for part, held in (("a", p15a_held), ("bc", p15_decode_held)):
                try:        # every part's line, then the first failure
                    line = held(role, outs)
                except AssertionError as e:
                    failed.append(str(e))
                    line = f"FAILED: {e}"
                secs = [round(o[f"{part}_s"], 2) for o in outs]
                print(f"[phase15{role}{part}] backend {backend}: {line}; "
                      f"each rank's seconds {secs} ({note}; {smi})",
                      flush=True)
            for what in failed:
                check(False, what)
    print(f"[phase15] wall {time.perf_counter() - t_all:.2f} s; the ranks' "
          f"launches {json.dumps(nonzero(total))}")
    return total


# ---------------------------------------------------------------------------
# Phase 16: the trainer's three batch layouts, the L' double draw, the cells
# ---------------------------------------------------------------------------

def p16_step(cfg, batch, draws, seed: int, dev, features=None) -> tuple:
    """One f32 train step from run ``seed``'s initial state on ``batch``
    with ``draws``: (metrics as tensors, parameters after it, seconds)."""
    state, opt = init_state(cfg, generator=torch.Generator().manual_seed(
        seed), pool_size=P3_POOL, device=dev)
    step = make_train_step(cfg, opt, features=features)
    torch.cuda.synchronize()
    t = time.perf_counter()
    state, m = step(state, batch, draws=draws)
    torch.cuda.synchronize()
    return ({k: v.detach() for k, v in m.items()},
            {k: p.detach() for k, p in named_params(state.params).items()},
            time.perf_counter() - t)


def differing_keys(a: dict, b: dict, skip=()) -> list:
    """The keys of two dicts of tensors whose values differ in a bit."""
    return [k for k in a if k not in skip and not torch.equal(a[k], b[k])]


def phase16(seed: int, dev, corpus, smi: str) -> dict:
    """Phase 16 (module docstring).  Returns the steps' launch counts."""
    t_all = time.perf_counter()
    cfg = dataclasses.replace(CONFIG, dtype="float32")
    dbl = dataclasses.replace(cfg, reuse_lprime_negatives=False)
    ds = EdgeDataset(corpus.tables, corpus.user_feat, corpus.item_feat,
                     k_train=cfg.k_train, device=dev, g=corpus.graph)
    per_type = {et: P16_ROWS for et in ("uu", "ui", "ii")}
    t = time.perf_counter()
    ids = ds.sample_batch(0, seed + P16_SEED, per_type)
    feat = ds.sample_batch(0, seed + P16_SEED, per_type, format="dedup")
    legacy = ds.expand_batch(ids)
    torch.cuda.synchronize()
    t_batch = time.perf_counter() - t
    # every bank's draws, the L' ones too, from one CPU generator (the
    # initial state's pool is empty: no pool rows to draw)
    g = torch.Generator().manual_seed(seed + P16_SEED)
    draws = {k: negative_draws(P16_ROWS, cfg.n_heads, cfg.n_negatives,
                               cfg.n_pool_neg, 0, generator=g)
             for k in draw_keys(dbl, ids)}
    draws_l = {k: draws[k] for k in draw_keys(cfg, ids)}
    feats = FeatureStore(ds.user_feat, ds.item_feat)
    common.reset_launches()
    runs = {}
    with deterministic_sums():     # the scatter sums repeat (its docstring)
        runs["dedup_ids"] = p16_step(cfg, ids, draws_l, seed, dev, feats)
        runs["dedup"] = p16_step(cfg, feat, draws_l, seed, dev)
        runs["legacy"] = p16_step(cfg, legacy, draws_l, seed, dev)
        reused = dict(draws_l, **{f"lprime_{et}": draws_l[et]
                                  for et in ("ii", "ui", "uu")})
        runs["double-same"] = p16_step(dbl, ids, reused, seed, dev, feats)
        runs["double"] = p16_step(dbl, ids, draws, seed, dev, feats)
    launches = common.launch_counts()
    base_m, base_p, _ = runs["dedup_ids"]
    floats = {name: {k: float(v) for k, v in r[0].items()}
              for name, r in runs.items()}
    for name, m in floats.items():
        print(f"[phase16a] {name}: " + ", ".join(
            f"{k} {v:.6f}" for k, v in sorted(m.items()))
            + f"; step {runs[name][2]:.3f} s")
    bad_m = differing_keys(runs["dedup"][0], base_m)
    bad_p = differing_keys(runs["dedup"][1], base_p)
    check(not bad_m and not bad_p, f"16a dedup is not dedup_ids' bitwise: "
          f"losses {bad_m}, parameters {bad_p}")
    gap = f32_gap(floats["legacy"], floats["dedup_ids"])
    worst = max(floats["dedup_ids"], key=lambda k: abs(
        floats["legacy"][k] - floats["dedup_ids"][k]))
    print(f"[phase16a] dedup == dedup_ids bitwise (losses and "
          f"{len(base_p)} parameters); legacy against dedup_ids "
          f"{gap:.4g} of the f32 tolerance (F32_REL {F32_REL}, RQ losses "
          f"{F32_RQ_REL}, F32_ABS {F32_ABS}; the farthest {worst}: "
          f"{abs(floats['legacy'][worst] - floats['dedup_ids'][worst]):.3g})")
    check(gap <= 1, f"16a legacy against dedup_ids: {gap:.3g} of the f32 "
          f"tolerance ({worst})")
    bad_same = differing_keys(runs["double-same"][0], base_m)
    p_same = max(float((runs["double-same"][1][k] - base_p[k]).abs().max())
                 for k in base_p)
    print(f"[phase16b] double draw, each L' bank the bank it reuses: losses "
          f"{'bitwise' if not bad_same else 'differ: ' + str(bad_same)}; "
          f"grad_norm {floats['double-same']['grad_norm']:.9g} against "
          f"{floats['dedup_ids']['grad_norm']:.9g}, largest parameter gap "
          f"{p_same:.3g} (the banks' gradients reach their rows through two "
          f"gathers, not one)")
    check(not bad_same, f"16b double draw on the reused banks: {bad_same} "
          f"differ from the reusing step")
    check(p_same <= P16_SAME_GAP, f"16b double draw on the reused banks: "
          f"a parameter {p_same:.3g} from the reusing step's, past "
          f"{P16_SAME_GAP}")
    bad_d = differing_keys(runs["double"][0], base_m,
                           skip=("rq_contrastive", "total", "grad_norm"))
    moved = floats["double"]["rq_contrastive"] - \
        floats["dedup_ids"]["rq_contrastive"]
    print(f"[phase16b] double draw, distinct L' banks: rq_contrastive moved "
          f"{moved:.6g}, grad_norm {floats['double']['grad_norm']:.9g}; "
          f"the other task losses "
          f"{'bitwise' if not bad_d else 'differ: ' + str(bad_d)}")
    check(not bad_d, f"16b distinct L' banks moved {bad_d}")
    check(moved != 0.0, "16b distinct L' banks left rq_contrastive")
    check(floats["double"]["grad_norm"] != floats["dedup_ids"]["grad_norm"],
          "16b distinct L' banks left grad_norm")
    # 16c: every cell at both production meshes, on meta
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t = time.perf_counter()
    n = 0
    for multi in (False, True):
        mesh = abstract_production_mesh(multi)
        for arch_id, shape_name in all_cells():
            build_cell(arch_id, shape_name, mesh)
            n += 1
    t_cells = time.perf_counter() - t
    after = torch.cuda.memory_allocated()
    print(f"[phase16c] built {n} cells (the 40 at (16, 16) and (2, 16, 16)) "
          f"in {t_cells:.2f} s; card memory allocated {before} -> {after} "
          f"bytes")
    check(after == before, f"16c building the cells allocated "
          f"{after - before} bytes on the card")
    print(f"[phase16] {P16_ROWS:,} edges a type, batches {t_batch:.2f} s; "
          f"launches {json.dumps(nonzero(launches))}; wall "
          f"{time.perf_counter() - t_all:.2f} s ({smi})")
    return launches


def nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


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


def progress(t0: float, what: str) -> None:
    """One line on stderr as a phase starts, with the seconds since
    ``t0``: where a run cut at its time limit stood."""
    print(f"[chip_smoke] {time.perf_counter() - t0:.1f} s: {what}",
          file=sys.stderr, flush=True)


def main() -> int:
    t_main = time.perf_counter()
    sys.stdout.reconfigure(line_buffering=True)
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
    ap.add_argument("--lm-train-only", action="store_true",
                    help="only build the flash-attention kernels and run "
                         "Phase 10 (run_lm, dense and MoE training, kimi "
                         "serving)")
    ap.add_argument("--kimi-train-only", action="store_true",
                    help="only build the flash-attention kernels and run "
                         "Phase 13 (kimi-k2's training at head dim 112: one "
                         "layer at full width with 64 experts, and card "
                         "against CPU at a cut width)")
    ap.add_argument("--distributed-only", action="store_true",
                    help="only build the kernels Phase 3's construction "
                         "and training use, make Phase 3's corpus (no "
                         "training) and run Phase 11 (the distributed "
                         "paths)")
    ap.add_argument("--lm-mesh-only", action="store_true",
                    help="only build the flash-attention kernels and run "
                         "Phase 12 (the LM family under a mesh: kimi's "
                         "expert-parallel prefill and MoE backward, "
                         "olmo's FSDP train steps)")
    ap.add_argument("--tp-only", action="store_true",
                    help="only build the kernels Phase 3's construction, "
                         "training and the LM's attention use, make Phase "
                         "3's corpus (no training) and run Phase 14 "
                         "(tensor parallelism over the model axis)")
    ap.add_argument("--tp2-only", action="store_true",
                    help="only build embedding_bag and the flash-attention "
                         "kernels and run Phase 15 (the recsys family's "
                         "tensor parallelism, the decode rules' "
                         "sequence-sharded KV cache)")
    ap.add_argument("--layouts-only", action="store_true",
                    help="only build the kernels Phase 3's construction "
                         "and training use, make Phase 3's corpus (no "
                         "training) and run Phase 16 (the trainer's batch "
                         "layouts, the L' double draw, the cells)")
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
        phase1_decode_lse(g, dev, peaks)
        phase1_flash_attention_bwd(torch.Generator(device=dev).manual_seed(
            args.seed), dev, peaks)
        return 0
    if args.decode_only > 0:
        print_build(common.build(["flash_attention"]))
        decode_only(args.seed, dev, args.decode_only)
        return 0
    if args.distributed_only:
        print_build(common.build(["rq_assign", "ppr_walk",
                                  "fused_contrastive", "embedding_bag"]))
        t = time.perf_counter()
        corpus = p11_corpus(args.seed, dev)
        print(f"[phase11] Phase 3's corpus made in "
              f"{time.perf_counter() - t:.2f} s")
        phase11(args.seed, dev, corpus, smi)
        return 0
    if args.lm_mesh_only:
        print_build(common.build(["flash_attention", "flash_attention_bwd"]))
        phase12(args.seed, dev, smi)
        return 0
    if args.tp_only:
        print_build(common.build(["rq_assign", "ppr_walk",
                                  "fused_contrastive", "flash_attention",
                                  "flash_attention_bwd"]))
        t = time.perf_counter()
        corpus = p11_corpus(args.seed, dev)
        print(f"[phase14] Phase 3's corpus made in "
              f"{time.perf_counter() - t:.2f} s")
        phase14(args.seed, dev, corpus, smi)
        return 0
    if args.tp2_only:
        print_build(common.build(["embedding_bag", "flash_attention"]))
        phase15(args.seed, dev, smi)
        return 0
    if args.layouts_only:
        print_build(common.build(["rq_assign", "ppr_walk",
                                  "fused_contrastive"]))
        t = time.perf_counter()
        corpus = p11_corpus(args.seed, dev)
        print(f"[phase16] Phase 3's corpus made in "
              f"{time.perf_counter() - t:.2f} s")
        phase16(args.seed, dev, corpus, smi)
        return 0
    if args.lm_train_only:
        print_build(common.build(["flash_attention", "flash_attention_bwd"]))
        t = time.perf_counter()
        phase10(args.seed, dev)
        print(f"[phase10] wall {time.perf_counter() - t:.2f} s")
        return 0
    if args.kimi_train_only:
        print_build(common.build(["flash_attention", "flash_attention_bwd"]))
        t = time.perf_counter()
        phase13(args.seed, dev)
        print(f"[phase13] wall {time.perf_counter() - t:.2f} s")
        return 0
    progress(t_main, "Phase 0 (build)")
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
    for kname, dec in (("tile (fa_wgmma at D 64-256, 112 on the 128 tiles; "
                        "fa_mma at D 32)",
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
                  for d in FA.BWD_HEAD_DIMS))

    progress(t_main, "Phase 1")
    g = torch.Generator(device=dev).manual_seed(args.seed)
    rows = [phase1_rq_assign(g, dev, peaks), phase1_queue_gather(g, dev, peaks),
            phase1_ppr_walk(g, dev, peaks),
            *phase1_fused_contrastive(g, dev, peaks),
            *phase1_embedding_bag(g, dev, peaks)]
    rows += phase1_flash_attention(g, dev, peaks)
    progress(t_main, "Phase 1 (decode with lse)")
    rows.append(phase1_decode_lse(g, dev, peaks))
    progress(t_main, "Phase 1 (the attention backward)")
    rows += phase1_flash_attention_bwd(g, dev, peaks)
    progress(t_main, "Phase 2")
    t = time.perf_counter()
    launches, p2 = phase2(args.seed, dev)
    print(f"[phase2] wall {time.perf_counter() - t:.2f} s")
    progress(t_main, "Phase 8")
    t = time.perf_counter()
    launches8 = phase8(args.seed, dev, p2)
    print(f"[phase8] wall {time.perf_counter() - t:.2f} s")
    del p2
    torch.cuda.empty_cache()
    progress(t_main, "Phase 3")
    launches3, corpus = phase3(args.seed, dev)
    torch.cuda.empty_cache()
    progress(t_main, "Phase 6")
    t = time.perf_counter()
    launches6, p6 = phase6(args.seed, dev)
    print(f"[phase6] wall {time.perf_counter() - t:.2f} s")
    torch.cuda.empty_cache()
    progress(t_main, "Phase 7")
    t = time.perf_counter()
    launches7 = phase7(args.seed, dev, p6)
    print(f"[phase7] wall {time.perf_counter() - t:.2f} s")
    del p6
    torch.cuda.empty_cache()
    progress(t_main, "Phase 4")
    t = time.perf_counter()
    launches4 = phase4(args.seed, dev)
    print(f"[phase4] wall {time.perf_counter() - t:.2f} s")
    torch.cuda.empty_cache()             # Phase 4's tables took 66.56 GB
    progress(t_main, "Phase 5")
    t = time.perf_counter()
    launches5 = phase5(args.seed, dev)
    print(f"[phase5] wall {time.perf_counter() - t:.2f} s")
    torch.cuda.empty_cache()
    progress(t_main, "Phase 9")
    t = time.perf_counter()
    launches9 = phase9(args.seed, dev)
    print(f"[phase9] wall {time.perf_counter() - t:.2f} s")
    torch.cuda.empty_cache()
    progress(t_main, "Phase 10")
    t = time.perf_counter()
    launches10 = phase10(args.seed, dev)
    print(f"[phase10] wall {time.perf_counter() - t:.2f} s")
    torch.cuda.empty_cache()
    progress(t_main, "Phase 13")
    t = time.perf_counter()
    launches13 = phase13(args.seed, dev)
    print(f"[phase13] wall {time.perf_counter() - t:.2f} s")
    torch.cuda.empty_cache()
    progress(t_main, "Phase 11")
    launches11 = phase11(args.seed, dev, corpus, smi)
    torch.cuda.empty_cache()
    progress(t_main, "Phase 14")
    launches14 = phase14(args.seed, dev, corpus, smi)
    torch.cuda.empty_cache()
    progress(t_main, "Phase 16")
    launches16 = phase16(args.seed, dev, corpus, smi)
    del corpus
    torch.cuda.empty_cache()
    progress(t_main, "Phase 12")
    launches12 = phase12(args.seed, dev, smi)
    torch.cuda.empty_cache()
    progress(t_main, "Phase 15")
    launches15 = phase15(args.seed, dev, smi)
    for r in rows:     # each path's launches, Phases 6-13's added to its own
        counter = r.get("counter", r["name"])
        r["launches"] = (next((ls[counter] for ls in (
            {n: launches[n] for n in SLICE1}, launches4, launches5,
            launches3) if counter in ls), 0)
            + sum(ls.get(counter, 0)
                  for ls in (launches6, launches7, launches8, launches9,
                             launches10, launches11, launches12,
                             launches13, launches14, launches15,
                             launches16)))
        check(r["launches"] > 0, f"{r['name']} was not launched on its "
              f"main path")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    progress(t_main, "the kernels line")
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
