"""Data-parallel rankgraph2 training of the port against the JAX package's
global step under a ``ShardingCtx`` on a 4-device mesh, at the small
``RankGraph2Config`` of ``tests/test_distributed.py`` (d 16, 2 heads, RQ
(8, 4)), 32 edges per type:

  * the JAX side runs in a child with 4 host devices (``_run_child``):
    two ``make_train_step(cfg, opt, ShardingCtx(make_rules(mesh),
    mesh))`` steps from ``init_state(key(0))`` (shard-local negatives,
    block 8), each step's gradients by ``jax.grad`` of the same loss
    under the same context, and the per-direction negative draws the
    step makes from its key;
  * the port runs the same two steps in four gloo ranks on the CPU
    (``_run_ranks``: one process a rank, rendezvous through a file under
    ``tmp_path``) from ``convert.train_state_from_jax`` of the same
    state, on the same batches with the JAX draws injected.  Held: every
    rank ends with the same state bit for bit; each step's losses within
    1e-5 relative; each parameter's gradient within 1e-5 relative
    (norm-wise), which a replicated term counted once a rank would miss
    by a factor of 4; the parameters by the distribution of their gaps
    (ROADMAP's "Optimizer sign" hazard: each parameter's median gap
    within 1e-6, at most 1% of entries more than 1e-4 apart); the pool
    within 1e-5, its pointers equal; the RQ histograms equal and the
    usage within 1e-6; the ranks' RQ selections, put in global row
    order, equal the one-process global step's (shard-local negatives,
    the same draws) at both steps.  Gradients and selections come from
    ``make_grad_step``, which ``apply_grads`` completes into the step.
  * The same at ``B`` that 4 does not divide (30 uu and 29 ii edges, 32
    ui: the reference's whole-batch negatives beside shard-local ones in
    one step; JAX's global step runs there under the same 4-device
    mesh): each rank keeps ``block_rows`` (8, 8, 8, 6 of 30), gathers the
    whole batch's destination rows for those types' banks, and every
    loss is the global mean; held as above, against the one-process
    global step's selections with the same draws.
  * A rank with no rows of a type (5 uu and 3 ii edges over 4 ranks:
    blocks 2, 2, 1, 0 and 1, 1, 1, 0; 32 ui) runs the same step, held
    against JAX's global step under the same mesh as above; each
    log-variance's gradient ``1 - exp(-s) L`` there within 1e-5 of the
    larger of its terms, since its two terms nearly cancel at one step.
  * ``dp = 1`` (a one-rank mesh) is bitwise the one-process step;
    ``rank_batch`` keeps each rank's edges' endpoints and neighbours,
    also in ragged blocks (dp 3: 11, 11, 10 of 32; dp 12: the last rank
    empty).
"""
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import RankGraph2Config as JCfg, RQConfig as JRQCfg
from repro.core import trainer as JT
from repro_torch.configs.base import RankGraph2Config, RQConfig
from repro_torch.convert import train_state_from_jax
from repro_torch.core import trainer as T
from repro_torch.distributed.collectives import block_rows
from repro_torch.optim import optimizers as O

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(d_user_feat=64, d_item_feat=64, d_embed=16, n_heads=2,
             d_hidden=32, k_imp=6, k_train=4, n_negatives=8, n_pool_neg=4,
             dtype="float32")
RQ_SIZES = (8, 4)
PER_TYPE = {"uu": 32, "ui": 32, "ii": 32}
RAGGED = {"uu": 30, "ui": 32, "ii": 29}     # 4 divides only ui
EMPTY = {"uu": 5, "ui": 32, "ii": 3}        # a rank with no uu or ii rows
DP, STEPS, POOL = 4, 2, 64
LOSS_REL, GRAD_REL, USAGE_ABS, POOL_ABS = 1e-5, 1e-5, 1e-6, 1e-5
GAP_MEDIAN, GAP_FAR, GAP_FAR_SHARE = 1e-6, 1e-4, 0.01


def _run_child(script: str, *args: str) -> str:
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", script, *args], env=env,
                       capture_output=True, text=True, cwd=REPO,
                       timeout=300)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    return r.stdout


def _run_ranks(script: str, world: int, tmp, timeout: float = 180.0):
    """Run ``script`` as ``world`` processes (argv: rank, world, tmp dir),
    the port's ranks on the CPU; every one must exit 0 in ``timeout``
    seconds."""
    env = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r),
                               str(world), str(tmp)], env=env, cwd=REPO,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (o, e)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (r, o[-2000:], e[-3000:])
    return [o for o, _ in outs]


JAX_CHILD = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs.base import RankGraph2Config, RQConfig
    from repro.core import losses as L
    from repro.core import trainer as T
    from repro.core.graph_builder import build_graph
    from repro.data.edge_dataset import build_neighbor_tables, EdgeDataset
    from repro.data.synthetic import make_world
    from repro.distributed.sharding import ShardingCtx, make_rules
    SMALL, RQ_SIZES, PER, DP, STEPS, POOL = %s
    out = {}
    def put(prefix, tree):
        if isinstance(tree, dict):
            for k, v in tree.items():
                put(f"{prefix}/{k}", v)
        else:
            out[prefix] = np.asarray(tree)
    cfg = RankGraph2Config(**SMALL, rq=RQConfig(codebook_sizes=RQ_SIZES,
                                                hist_len=8))
    world = make_world(n_users=150, n_items=200, seed=3)
    g = build_graph(world.day0, k_cap=8, hub_cap=8)
    tables = build_neighbor_tables(g, k_imp=6, n_walks=8, walk_len=3)
    ds = EdgeDataset(g, tables, world.user_feat, world.item_feat, 4,
                     batch_format="dedup_ids")
    feats = T.make_feature_store(world.user_feat, world.item_feat)
    out["user_feat"], out["item_feat"] = world.user_feat, world.item_feat
    state, _, opt = T.init_state(jax.random.key(0), cfg, pool_size=POOL)
    mesh = jax.make_mesh((DP,), ("data",))
    ctx = ShardingCtx(make_rules(mesh), mesh)
    assert ctx.axis_size("batch") == DP
    step = T.make_train_step(cfg, opt, ctx, features=feats, donate=False)

    def loss(params, state, batch, key):
        tasks, _ = T._forward_losses(params, cfg, batch, state.pool,
                                     state.rq_state, key, ctx, True, feats)
        return L.uncertainty_combine(tasks, params["uncertainty"])
    gradf = jax.jit(jax.grad(loss))

    def draws(key, B, fill, blk):
        H, n_neg, n_pool = cfg.n_heads, cfg.n_negatives, cfg.n_pool_neg
        n_aug = max(n_neg // 8, 1) if H > 1 else 0
        n_pool = min(n_pool, n_neg - n_aug)
        n_inb = n_neg - n_pool - n_aug
        hi = jnp.maximum(blk, 2)
        k1, k2, k3 = jax.random.split(key, 3)
        f = jnp.maximum(fill, 1)
        return dict(inb=jax.random.randint(k1, (B, n_inb), 1, hi),
                    pool=jax.random.randint(k2, (B, n_pool), 0, f),
                    fallback=jax.random.randint(k3, (B, n_pool), 1, hi),
                    aug_off=jax.random.randint(jax.random.fold_in(key, 7),
                                               (B, n_aug), 1, hi),
                    aug_head=jax.random.randint(jax.random.fold_in(key, 8),
                                                (B, n_aug), 0, H))
    with mesh:
        for t in range(STEPS):
            batch = ds.sample_batch(t, 7, PER, format="dedup_ids")
            put(f"batch{t}", batch)
            jb = jax.tree.map(jnp.asarray, batch)
            key = jax.random.key(1000 + t)
            keys = jax.random.split(key, 8)
            dirs = []
            for et in sorted(batch["edges"]):
                dirs += [et, "iu"] if et == "ui" else [et]
            for i, dn in enumerate(dirs):
                fill = state.pool.user_fill if dn in ("uu", "iu") \\
                    else state.pool.item_fill
                B = PER["ui" if dn == "iu" else dn]
                blk = B // DP if B %% DP == 0 else B   # whole-batch
                put(f"draws{t}/{dn}", draws(keys[i], B, fill, blk))
            put(f"grads{t}", gradf(state.params, state, jb, key))
            state, m = step(state, jb, key)
            put(f"metrics{t}", dict(m))
    put("params", state.params)
    for f in ("user", "item", "user_ptr", "item_ptr", "user_fill",
              "item_fill"):
        out[f"pool/{f}"] = np.asarray(getattr(state.pool, f))
    for l in range(len(RQ_SIZES)):
        out[f"hist{l}"] = np.asarray(state.rq_state.hists[l])
        out[f"usage{l}"] = np.asarray(state.rq_state.usage[l])
    np.savez(sys.argv[1], **out)
    print("JAX_DP_OK")
""")

RANK = textwrap.dedent("""
    import sys, torch
    torch.set_num_threads(1)
    from repro_torch.core import negatives as N
    from repro_torch.core import trainer as T
    from repro_torch.distributed.sharding import ShardingCtx, make_rules
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.optim import optimizers as O
    rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    init_distributed(rank, world, f"{tmp}/rdv", device="cpu")
    mesh = make_mesh((world,), ("data",))
    ctx = ShardingCtx(make_rules(mesh), mesh)
    inp = torch.load(f"{tmp}/inputs.pt", weights_only=False)
    st, cfg = inp["state"], inp["cfg"]
    feats = T.FeatureStore(*inp["feats"])
    grad_step = T.make_grad_step(cfg, ctx, features=feats)
    opt = O.rankgraph2_optimizer()
    res = []
    for batch, draws in zip(inp["batches"], inp["draws"]):
        sg = grad_step(st, batch, draws=draws)
        grads = {k: g.detach().clone() for k, g in sg.grads.items()}
        codes = sg.aux["codes"].clone()
        st, m = T.apply_grads(st, sg, opt)
        res.append(({k: float(v) for k, v in m.items()}, grads, codes))
    # the one-process global step on the same inputs (shard-local blocks
    # where world divides B, else the whole batch): its metrics,
    # gradients and RQ selections
    glob = []
    if rank == 0:
        gst = torch.load(f"{tmp}/inputs.pt", weights_only=False)["state"]
        blks = {N.shard_block_for(e["src_map"].shape[0], world)
                for e in inp["batches"][0]["edges"].values()} - {0}
        assert len(blks) <= 1
        gstep = T.make_grad_step(cfg, features=feats,
                                 shard_block=blks.pop() if blks else 0)
        for batch, draws in zip(inp["batches"], inp["draws"]):
            sg = gstep(gst, batch, draws=draws)
            grads = {k: g.detach().clone() for k, g in sg.grads.items()}
            codes = sg.aux["codes"].clone()
            gst, m = T.apply_grads(gst, sg, opt)
            glob.append(({k: float(v) for k, v in m.items()}, grads, codes))
    torch.save(dict(steps=res, params={k: v.detach() for k, v in
                                       T.named_params(st.params).items()},
                    pool=st.pool, rq=st.rq_state, global_codes=glob),
               f"{tmp}/rank{rank}.pt")
    torch.distributed.destroy_process_group()
""")


def _global_rows(parts, per):
    """The ranks' RQ rows (each laid out as its block's endpoints: every
    edge type in sorted order, its src rows then its dst rows, a rank's
    ``block_rows`` of each) in the whole batch's order."""
    out, offs = [], [0] * len(parts)
    for et in sorted(per):
        for _ in ("src", "dst"):
            for r, p in enumerate(parts):
                n = len(range(*block_rows(per[et], len(parts), r)
                              .indices(per[et])))
                out.append(p[offs[r]:offs[r] + n])
                offs[r] += n
    assert all(o == p.shape[0] for o, p in zip(offs, parts))
    return torch.cat(out)


def _cfgs():
    jcfg = JCfg(**SMALL, rq=JRQCfg(codebook_sizes=RQ_SIZES, hist_len=8))
    pcfg = RankGraph2Config(**SMALL, rq=RQConfig(codebook_sizes=RQ_SIZES,
                                                 hist_len=8))
    return jcfg, pcfg


def _nest(flat, prefix):
    out = {}
    for k, v in flat.items():
        if not k.startswith(prefix + "/"):
            continue
        node = out
        parts = k[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _port_param_name(name):
    """Port parameter name -> (JAX tree path, transpose?)."""
    parts = name.split(".")
    if parts[-1] == "weight":
        return parts[:-1] + ["w"], True
    if parts[-1] == "bias":
        return parts[:-1] + ["b"], False
    return parts, False


def _jax_leaf(flat, prefix, name):
    path, tr = _port_param_name(name)
    a = flat["/".join([prefix, *path])]
    return a.T if tr else a


def _norm_rel(a, b):
    return float(np.linalg.norm((a - b).ravel())
                 / max(np.linalg.norm(np.asarray(b).ravel()), 1e-30))


def _jax_global(tmp_path_factory, per):
    path = tmp_path_factory.mktemp("jaxdp") / "jax.npz"
    consts = repr((SMALL, RQ_SIZES, per, DP, STEPS, POOL))
    assert "JAX_DP_OK" in _run_child(JAX_CHILD % consts, str(path))
    return dict(np.load(path))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    return _jax_global(tmp_path_factory, PER_TYPE)


@pytest.fixture(scope="module")
def jax_ragged(tmp_path_factory):
    return _jax_global(tmp_path_factory, RAGGED)


@pytest.fixture(scope="module")
def jax_empty(tmp_path_factory):
    return _jax_global(tmp_path_factory, EMPTY)


def _initial_state(device="cpu"):
    jcfg, _ = _cfgs()
    state, _, _ = JT.init_state(jax.random.key(0), jcfg, pool_size=POOL)
    return train_state_from_jax(jax.tree.map(np.asarray, state),
                                device=device)


def _dp4_ranks(j, tmp_path, batches=None, draws=None):
    """The port's ``DP`` ranks (and rank 0's one-process global step) on
    the JAX run's batches and draws (or the given ones), from its
    initial state; checks that every rank ends with the same state and
    returns the ranks' results."""
    _, pcfg = _cfgs()
    batches = batches or [_to_torch(_nest(j, f"batch{t}"))
                          for t in range(STEPS)]
    draws = draws or [{d: {k: v.long() for k, v in sub.items()}
                       for d, sub in _to_torch(_nest(j, f"draws{t}")).items()}
                      for t in range(STEPS)]
    torch.save(dict(state=_initial_state(), cfg=pcfg, batches=batches,
                    draws=draws,
                    feats=(torch.from_numpy(j["user_feat"]),
                           torch.from_numpy(j["item_feat"]))),
               tmp_path / "inputs.pt")
    _run_ranks(RANK, DP, tmp_path)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(DP)]
    r0 = ranks[0]
    # every rank holds the same state
    for r in ranks[1:]:
        for k, v in r0["params"].items():
            assert torch.equal(v, r["params"][k]), k
        assert torch.equal(r0["pool"].user, r["pool"].user)
        assert torch.equal(r0["pool"].item, r["pool"].item)
        for a, b in zip(r0["rq"].hists + r0["rq"].usage,
                        r["rq"].hists + r["rq"].usage):
            assert torch.equal(a, b)
    return ranks


def test_dp4_step_matches_jax_global_step(jax_run, tmp_path):
    _held_against_jax(jax_run, tmp_path, PER_TYPE)


def test_dp4_ragged_step_matches_jax_global_step(jax_ragged, tmp_path):
    """30 uu and 29 ii edges over 4 ranks (whole-batch negatives), 32 ui
    (shard-local): held as the even case."""
    _held_against_jax(jax_ragged, tmp_path, RAGGED)


def _held_against_jax(j, tmp_path, per, log_var_terms=False):
    """The checks of the module docstring.  ``log_var_terms``: hold each
    log-variance's gradient, ``1 - exp(-s) L``, within ``GRAD_REL`` of
    the larger of its two terms (``exp(-s) L`` is ``1`` less JAX's
    gradient) rather than of their difference, which cancels where a
    task loss is near ``exp(s)``."""
    ranks = _dp4_ranks(j, tmp_path)
    r0 = ranks[0]
    for t, (metrics, grads, _) in enumerate(r0["steps"]):
        jm = _nest(j, f"metrics{t}")
        assert set(metrics) == set(jm)
        for k, v in jm.items():
            assert abs(metrics[k] - float(v)) <= LOSS_REL * max(
                abs(float(v)), 1e-6), (t, k, metrics[k], float(v))
        names = sorted(grads)
        assert len(names) == len([k for k in j if k.startswith(
            f"grads{t}/")])
        for name in names:
            want = _jax_leaf(j, f"grads{t}", name)
            if log_var_terms and name.startswith("uncertainty."):
                w = float(want)
                rel = abs(float(grads[name]) - w) / max(abs(w), abs(1 - w))
            else:
                rel = _norm_rel(grads[name].numpy(), want)
            assert rel <= GRAD_REL, (t, name, rel)
    for name, p in r0["params"].items():
        d = np.abs(p.numpy() - _jax_leaf(j, "params", name)).ravel()
        far = float(np.mean(d > GAP_FAR))
        assert np.median(d) <= GAP_MEDIAN and far <= GAP_FAR_SHARE, \
            (name, np.median(d), far, d.max())
    # the ranks' RQ selections, in global row order, are the one-process
    # global step's at every step
    for t, (_, _, want) in enumerate(r0["global_codes"]):
        got = _global_rows([r["steps"][t][2] for r in ranks], per)
        assert torch.equal(got, want), t
    assert len(r0["global_codes"]) == STEPS
    pool = r0["pool"]
    for f in ("user", "item"):
        np.testing.assert_allclose(getattr(pool, f).numpy(), j[f"pool/{f}"],
                                   atol=POOL_ABS)
    assert (pool.user_ptr, pool.item_ptr, pool.user_fill, pool.item_fill) \
        == tuple(int(j[f"pool/{f}"]) for f in ("user_ptr", "item_ptr",
                                                "user_fill", "item_fill"))
    for l in range(len(RQ_SIZES)):
        np.testing.assert_array_equal(r0["rq"].hists[l].numpy(),
                                      j[f"hist{l}"])
        np.testing.assert_allclose(r0["rq"].usage[l].numpy(),
                                   j[f"usage{l}"], atol=USAGE_ABS)
    return ranks


def test_dp4_step_with_an_empty_rank(jax_empty, tmp_path):
    """``EMPTY``: 5 uu and 3 ii edges (32 ui) over 4 ranks, so rank 3
    holds none of either (blocks 2, 2, 1, 0 and 1, 1, 1, 0); JAX's global
    step runs there under the same 4-device mesh.  Held as the even
    case, the log-variances' gradients in the units of their terms: at
    the first step rq_recon's loss is 1.00486, its gradient ``1 - L``
    -0.00486, and the loss's f32 gap to JAX's (2.4e-7) reads 4.9e-5 of
    that difference."""
    ranks = _held_against_jax(jax_empty, tmp_path, EMPTY, log_var_terms=True)
    batch = _to_torch(_nest(jax_empty, "batch0"))
    for r in range(DP):
        assert ranks[r]["steps"][0][2].shape[0] == 2 * sum(
            len(range(*block_rows(b["src_map"].shape[0], DP, r).indices(
                b["src_map"].shape[0]))) for b in batch["edges"].values())
    assert ranks[3]["steps"][0][2].shape[0] == 2 * 8      # ui's rows only


def test_dp1_step_is_bitwise_the_one_process_step(jax_run, tmp_path):
    import torch.distributed as dist
    from repro_torch.distributed.sharding import ShardingCtx, make_rules
    from repro_torch.launch.mesh import init_distributed, make_mesh
    _, pcfg = _cfgs()
    j = jax_run
    feats = T.FeatureStore(torch.from_numpy(j["user_feat"]),
                           torch.from_numpy(j["item_feat"]))
    batches = [_to_torch(_nest(j, f"batch{t}")) for t in range(STEPS)]
    init_distributed(0, 1, str(tmp_path / "rdv"), device="cpu")
    try:
        mesh = make_mesh((1,), ("data",))
        ctx = ShardingCtx(make_rules(mesh), mesh)
        runs = []
        for c in (None, ctx):
            st = _initial_state()
            step = T.make_train_step(pcfg, O.rankgraph2_optimizer(), c,
                                     features=feats)
            ms = []
            for t, b in enumerate(batches):
                st, m = step(st, b, generator=torch.Generator().manual_seed(t))
                ms.append(m)
            runs.append((st, ms))
    finally:
        dist.destroy_process_group()
    (a, ma), (b, mb) = runs
    for x, y in zip(ma, mb):
        assert all(torch.equal(x[k], y[k]) for k in x)
    pa, pb = T.named_params(a.params), T.named_params(b.params)
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert torch.equal(a.pool.user, b.pool.user)
    assert torch.equal(a.pool.item, b.pool.item)


def test_rank_batch_keeps_each_rank_s_rows(jax_run):
    j = jax_run
    batch = _to_torch(_nest(j, "batch0"))
    names = {"uu": ("user", "user"), "ui": ("user", "item"),
             "ii": ("item", "item")}

    def endpoint_ids(b, et, side):
        t = names[et][0 if side == "src_map" else 1]
        return b["nodes"][t]["ids"][b["edges"][et][side].long()]

    def nbr_ids(b, et, side, key, nbr_type):
        t = names[et][0 if side == "src_map" else 1]
        rows = b["edges"][et][side].long()
        idx = b["nodes"][t][key][rows].long()
        mask = b["nodes"][t][key.replace("idx", "mask")][rows]
        return b["nodes"][nbr_type]["ids"][idx] * (mask > 0)

    sizes = []
    for r in range(DP):
        sub = T.rank_batch(batch, r, DP)
        for et in batch["edges"]:
            b = batch["edges"][et]["src_map"].shape[0] // DP
            rows = slice(r * b, (r + 1) * b)
            for side in ("src_map", "dst_map"):
                assert torch.equal(endpoint_ids(sub, et, side),
                                   endpoint_ids(batch, et, side)[rows])
                for key, nt in (("unbr_idx", "user"), ("inbr_idx", "item")):
                    assert torch.equal(nbr_ids(sub, et, side, key, nt),
                                       nbr_ids(batch, et, side, key, nt)[rows])
            assert torch.equal(sub["edges"][et]["weight"],
                               batch["edges"][et]["weight"][rows])
        sizes.append(sum(sub["nodes"][t]["ids"].shape[0]
                         for t in ("user", "item")))
    # each rank encodes a part of the pack, not all of it
    assert max(sizes) < sum(batch["nodes"][t]["ids"].shape[0]
                            for t in ("user", "item"))
    # ragged blocks where dp does not divide B: ceil(B / dp) rows a rank,
    # the last ones fewer or none, covering every row once in order
    for dp, want in ((3, [11, 11, 10]), (12, [3] * 10 + [2, 0])):
        got = []
        for r in range(dp):
            sub = T.rank_batch(batch, r, dp)
            rows = block_rows(32, dp, r)
            for et in batch["edges"]:
                for side in ("src_map", "dst_map"):
                    assert torch.equal(endpoint_ids(sub, et, side),
                                       endpoint_ids(batch, et, side)[rows])
            got.append(sub["edges"]["uu"]["src_map"].shape[0])
        assert got == want, (dp, got)
