"""Tensor-parallel rankgraph2 of the port against the JAX package under the
same ``(data, model)`` mesh, at the small ``RankGraph2Config`` of
``tests/test_torch_dp_train.py`` (d 16, 2 heads, hidden 32, RQ (8, 4)),
32 edges per type:

  * the JAX side runs in a child with 4 host devices and meshes with
    ``AxisType.Auto`` axes: at (2, 2) and (1, 4), two
    ``make_train_step(cfg, opt, ShardingCtx(make_rules(mesh), mesh))``
    steps from ``init_state(key(0))`` (shard-local negatives, block
    ``B / dp``), each step's gradients by ``jax.grad`` of the same loss
    under the same context and the per-direction draws the step makes
    from its key; then ``embed_all(ctx=)`` of every user and item under
    the mesh and the RQ codes of those embeddings (``assign_codes``, the
    serve step's);
  * the port runs the same in four gloo ranks on the CPU a mesh, each
    step from JAX's state before it cut to the rank's shards
    (``core.trainer.shard_state``: at (2, 2) the encoders' hidden layer
    16 of 32 units a rank and one aggregator head a rank; at (1, 4) 8
    units a rank and the 2 heads whole, as ``_safe`` keeps a dim the
    axis does not divide), on the same batches with the JAX draws
    injected.  Each step starts from JAX's state because the first
    step's rq_reg loss is 1.0 up to rounding (the histograms are empty,
    so the regulariser is a sum over its own sum): JAX's gradient of its
    log-variance is 0 and the port's a rounding of f32, and AdamW turns
    that into a step of 3.4e-3 in the log-variance (ROADMAP's "Optimizer
    sign" hazard), which moves the second step's codebook gradients by
    2.7e-4 at either mesh.

Held, at both meshes: each step's losses within 1e-5 relative; each
parameter's gradient, each rank's block against the block of JAX's
whole gradient, within 1e-5 relative (norm-wise; a log-variance's
gradient ``1 - exp(-s) L`` within 1e-5 of the larger of its terms, as
``tests/test_torch_dp_train.py`` holds it where they cancel); after the
second step
the replicated state (RQ codebooks, histograms, pool, log-variances)
bitwise equal on every rank and a split leaf's block equal on the ranks
that hold it; the parameters by the distribution of their gaps (median
within 1e-6, at most 1% of entries more than 1e-4 apart); the pool
within 1e-5, its pointers equal; the RQ histograms equal and the usage
within 1e-6 (the test file's tolerances); the embeddings within 1e-5
and the codes equal but for near ties (``near_tie_mismatches``).
"""
import pickle
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro_torch.convert import train_state_from_jax

from test_torch_dp_train import (GAP_FAR, GAP_FAR_SHARE, GAP_MEDIAN,
                                 GRAD_REL, LOSS_REL, POOL, POOL_ABS, RQ_SIZES,
                                 SMALL, STEPS, USAGE_ABS, _cfgs, _jax_leaf,
                                 _nest, _norm_rel, _run_child, _to_torch)
from test_torch_lm_mesh_train import _run, _wait
from test_torch_rq_assign import near_tie_mismatches

torch.set_num_threads(2)

PER_TYPE = {"uu": 32, "ui": 32, "ii": 32}
MESHES = ((2, 2), (1, 4))
EMBED_BATCH, EMB_ABS = 64, 1e-5

JAX_CHILD = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs.base import RankGraph2Config, RQConfig
    from repro.core import losses as L
    from repro.core import rq_index as RQ
    from repro.core import trainer as T
    from repro.core.graph_builder import build_graph
    from repro.data.edge_dataset import build_neighbor_tables, EdgeDataset
    from repro.data.synthetic import make_world
    from repro.distributed.sharding import ShardingCtx, make_rules
    SMALL, RQ_SIZES, PER, MESHES, STEPS, POOL, EB = %s
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
    out["user_nbrs"], out["item_nbrs"] = tables.user_nbrs, tables.item_nbrs
    out["n_users"], out["n_items"] = tables.n_users, tables.n_items
    init, _, opt = T.init_state(jax.random.key(0), cfg, pool_size=POOL)
    AUTO = (jax.sharding.AxisType.Auto,) * 2

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
    for t in range(STEPS):
        put(f"batch{t}", ds.sample_batch(t, 7, PER, format="dedup_ids"))
    for mshape in MESHES:
        tag = f"{mshape[0]}x{mshape[1]}"
        dp = mshape[0]
        mesh = jax.make_mesh(mshape, ("data", "model"), axis_types=AUTO)
        ctx = ShardingCtx(make_rules(mesh), mesh)
        assert ctx.axis_size("batch") == dp
        step = T.make_train_step(cfg, opt, ctx, features=feats,
                                 donate=False)

        def loss(params, state, batch, key):
            tasks, _ = T._forward_losses(params, cfg, batch, state.pool,
                                         state.rq_state, key, ctx, True,
                                         feats)
            return L.uncertainty_combine(tasks, params["uncertainty"])
        gradf = jax.jit(jax.grad(loss))
        state = init
        with mesh:
            for t in range(STEPS):
                batch = ds.sample_batch(t, 7, PER, format="dedup_ids")
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
                    put(f"{tag}/draws{t}/{dn}", draws(keys[i], B, fill,
                                                      B // dp))
                put(f"{tag}/grads{t}", gradf(state.params, state, jb, key))
                if t:
                    with open(f"{sys.argv[1]}.{tag}.state{t}.pkl", "wb") as f:
                        pickle.dump(jax.tree.map(np.asarray, state), f)
                state, m = step(state, jb, key)
                put(f"{tag}/metrics{t}", dict(m))
            for nt, ids in ((0, np.arange(tables.n_users)),
                            (1, tables.n_users + np.arange(tables.n_items))):
                emb = T.embed_all(state.params, cfg, ds, node_type=nt,
                                  ids=ids, batch=EB, ctx=ctx)
                out[f"{tag}/emb{nt}"] = np.asarray(emb)
                out[f"{tag}/codes{nt}"] = np.asarray(RQ.assign_codes(
                    state.params["rq"], jnp.asarray(emb), cfg.rq))
        put(f"{tag}/params", state.params)
        for f in ("user", "item", "user_ptr", "item_ptr", "user_fill",
                  "item_fill"):
            out[f"{tag}/pool/{f}"] = np.asarray(getattr(state.pool, f))
        for l in range(len(RQ_SIZES)):
            out[f"{tag}/hist{l}"] = np.asarray(state.rq_state.hists[l])
            out[f"{tag}/usage{l}"] = np.asarray(state.rq_state.usage[l])
    np.savez(sys.argv[1], **out)
    print("JAX_TP_OK")
""")

RANK = textwrap.dedent("""
    import sys, numpy as np, torch
    torch.set_num_threads(1)
    from repro_torch.core import model as M
    from repro_torch.core import trainer as T
    from repro_torch.core.rq_index import assign_codes
    from repro_torch.data.edge_dataset import EdgeDataset, NeighborTables
    from repro_torch.distributed.sharding import ShardingCtx, make_rules
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.optim import optimizers as O
    rank, world, tmp, mtag = int(sys.argv[1]), int(sys.argv[2]), \\
        sys.argv[3], sys.argv[4]
    mshape = tuple(int(v) for v in mtag.split("x"))
    init_distributed(rank, world, f"{tmp}/rdv-{mtag}", device="cpu")
    mesh = make_mesh(mshape, ("data", "model"))
    ctx = ShardingCtx(make_rules(mesh), mesh)
    inp = torch.load(f"{tmp}/inputs.pt", weights_only=False)
    cfg = inp["cfg"]
    feats = T.FeatureStore(*inp["feats"])
    grad_step = T.make_grad_step(cfg, ctx, features=feats)
    opt = O.rankgraph2_optimizer()
    steps = []
    for t, (batch, draws) in enumerate(zip(inp["batches"],
                                           inp["draws"][mtag])):
        # each step from JAX's state before it (the whole state, cut to
        # this rank's shards)
        st = T.shard_state(inp["states"][mtag][t], cfg, ctx)
        sg = grad_step(st, batch, draws=draws)
        grads = {k: g.detach().clone() for k, g in sg.grads.items()}
        st, m = T.apply_grads(st, sg, opt)
        steps.append(({k: float(v) for k, v in m.items()}, grads))
    ds = EdgeDataset(NeighborTables(*inp["tables"]), *inp["feats"],
                     k_train=cfg.k_train, device="cpu")
    emb, codes = {}, {}
    for nt, ids in enumerate(inp["ids"]):
        emb[nt] = T.embed_all(st.params, cfg, ds, node_type=nt, ids=ids,
                              batch=inp["embed_batch"], ctx=ctx)
        with torch.no_grad():
            codes[nt] = assign_codes(st.params["rq"], emb[nt], cfg.rq)
    torch.save(dict(steps=steps, params={k: v.detach() for k, v in
                                         T.named_params(st.params).items()},
                    pool=st.pool, rq=st.rq_state, emb=emb, codes=codes,
                    coords=(ctx.axis_index("data"), ctx.axis_index("model")),
                    layout=M.param_layout(cfg, ctx)),
               f"{tmp}/tp-{mtag}-rank{rank}.pt")
    torch.distributed.barrier()     # no rank tears down mid-exchange
    torch.distributed.destroy_process_group()
""")


def _block(full, spec, coords, sizes):
    """The block of ``full`` a rank at ``coords`` holds under ``spec``."""
    for d, ax in enumerate(spec):
        if ax is not None:
            full = np.array_split(full, sizes[ax], axis=d)[coords[ax]]
    return full


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX child (both meshes), then both meshes' ranks at once."""
    tmp = tmp_path_factory.mktemp("tprg2")
    consts = repr((SMALL, RQ_SIZES, PER_TYPE, MESHES, STEPS, POOL,
                   EMBED_BATCH))
    assert "JAX_TP_OK" in _run_child(JAX_CHILD % consts, str(tmp / "j.npz"))
    j = dict(np.load(tmp / "j.npz"))
    jcfg, pcfg = _cfgs()
    from repro.core import trainer as JT
    from repro_torch.data.edge_dataset import NeighborTables
    state, _, _ = JT.init_state(jax.random.key(0), jcfg, pool_size=POOL)
    tags = [f"{m[0]}x{m[1]}" for m in MESHES]
    nu, ni = int(j["n_users"]), int(j["n_items"])
    init = train_state_from_jax(jax.tree.map(np.asarray, state),
                                device="cpu")
    states = {}
    for tag in tags:
        with open(f"{tmp}/j.npz.{tag}.state1.pkl", "rb") as f:
            states[tag] = [init, train_state_from_jax(pickle.load(f),
                                                      device="cpu")]
    torch.save(dict(
        cfg=pcfg, states=states,
        batches=[_to_torch(_nest(j, f"batch{t}")) for t in range(STEPS)],
        draws={tag: [{d: {k: v.long() for k, v in sub.items()}
                      for d, sub in _to_torch(
                          _nest(j, f"{tag}/draws{t}")).items()}
                     for t in range(STEPS)] for tag in tags},
        feats=(torch.from_numpy(j["user_feat"]),
               torch.from_numpy(j["item_feat"])),
        tables=(j["user_nbrs"], j["item_nbrs"], nu, ni),
        ids=(np.arange(nu), nu + np.arange(ni)), embed_batch=EMBED_BATCH),
        tmp / "inputs.pt")
    _wait([_run([RANK, str(r), "4", str(tmp), tag])
           for tag in tags for r in range(4)], timeout=180.0)
    ranks = {m: [torch.load(tmp / f"tp-{tag}-rank{r}.pt",
                            weights_only=False) for r in range(4)]
             for m, tag in zip(MESHES, tags)}
    return j, ranks


def test_layouts_split_mlp_and_heads_where_the_axis_divides(runs):
    _, ranks = runs
    lay = {m: r[0]["layout"] for m, r in ranks.items()}
    assert lay[(2, 2)]["f_user.l1.weight"] == ("model", None)
    assert lay[(2, 2)]["f_user.l1.bias"] == ("model",)
    assert lay[(2, 2)]["f_user.l2.weight"] == (None, "model")
    assert lay[(2, 2)]["f_user.l2.bias"] == (None,)
    assert lay[(2, 2)]["agg_item.w"] == ("model", None, None)
    assert lay[(1, 4)]["f_item.l1.weight"] == ("model", None)
    # 2 heads at model 4: whole (``_safe``)
    assert lay[(1, 4)]["agg_user.w"] == (None, None, None)
    assert lay[(1, 4)]["agg_user.b"] == (None, None)
    assert ranks[(2, 2)][1]["params"]["agg_user.w"].shape == (1, 48, 16)
    assert ranks[(1, 4)][3]["params"]["f_user.l1.weight"].shape == (8, 64)


@pytest.mark.parametrize("mshape", MESHES)
def test_tp_step_matches_jax_under_the_mesh(runs, mshape):
    j, all_ranks = runs
    ranks = all_ranks[mshape]
    tag = f"{mshape[0]}x{mshape[1]}"
    sizes = dict(zip(("data", "model"), mshape))
    lay = ranks[0]["layout"]
    for t in range(STEPS):
        jm = _nest(j, f"{tag}/metrics{t}")
        for r in ranks:
            metrics, grads = r["steps"][t]
            assert set(metrics) == set(jm)
            for k, v in jm.items():
                assert abs(metrics[k] - float(v)) <= LOSS_REL * max(
                    abs(float(v)), 1e-6), (tag, t, k, metrics[k], float(v))
            coords = dict(zip(("data", "model"), r["coords"]))
            for name, g in grads.items():
                want = _jax_leaf(j, f"{tag}/grads{t}", name)
                want = _block(want, lay.get(name, ()), coords, sizes)
                assert g.shape == want.shape, (tag, name)
                if name.startswith("uncertainty."):
                    # 1 - exp(-s) L against the larger of its terms
                    w = float(want)
                    rel = abs(float(g) - w) / max(abs(w), abs(1 - w))
                else:
                    rel = _norm_rel(g.numpy(), want)
                assert rel <= GRAD_REL, (tag, t, name, rel)
    # replicated state bitwise equal on every rank; a split leaf's block
    # equal on the ranks that hold it
    for r in ranks[1:]:
        same_block = r["coords"][1] == ranks[0]["coords"][1]
        for k, v in ranks[0]["params"].items():
            split = any(s is not None for s in lay.get(k, ()))
            if not split or same_block:
                assert torch.equal(v, r["params"][k]), (tag, k)
        assert torch.equal(ranks[0]["pool"].user, r["pool"].user)
        assert torch.equal(ranks[0]["pool"].item, r["pool"].item)
        for a, b in zip(ranks[0]["rq"].hists + ranks[0]["rq"].usage,
                        r["rq"].hists + r["rq"].usage):
            assert torch.equal(a, b)
    for r in ranks:
        coords = dict(zip(("data", "model"), r["coords"]))
        for name, p in r["params"].items():
            want = _block(_jax_leaf(j, f"{tag}/params", name),
                          lay.get(name, ()), coords, sizes)
            d = np.abs(p.numpy() - want).ravel()
            far = float(np.mean(d > GAP_FAR))
            assert np.median(d) <= GAP_MEDIAN and far <= GAP_FAR_SHARE, \
                (tag, name, np.median(d), far, d.max())
    r0 = ranks[0]
    for f in ("user", "item"):
        np.testing.assert_allclose(getattr(r0["pool"], f).numpy(),
                                   j[f"{tag}/pool/{f}"], atol=POOL_ABS)
    assert (r0["pool"].user_ptr, r0["pool"].item_ptr, r0["pool"].user_fill,
            r0["pool"].item_fill) == tuple(
        int(j[f"{tag}/pool/{f}"]) for f in ("user_ptr", "item_ptr",
                                            "user_fill", "item_fill"))
    for l in range(len(RQ_SIZES)):
        np.testing.assert_array_equal(r0["rq"].hists[l].numpy(),
                                      j[f"{tag}/hist{l}"])
        np.testing.assert_allclose(r0["rq"].usage[l].numpy(),
                                   j[f"{tag}/usage{l}"], atol=USAGE_ABS)


@pytest.mark.parametrize("mshape", MESHES)
def test_tp_embed_all_and_codes_match_jax(runs, mshape):
    j, all_ranks = runs
    tag = f"{mshape[0]}x{mshape[1]}"
    ranks = all_ranks[mshape]
    books = [_jax_leaf(j, f"{tag}/params", f"rq.codebooks.layer{l}")
             for l in range(len(RQ_SIZES))]
    for nt in (0, 1):
        for r in ranks:
            assert torch.equal(r["emb"][nt], ranks[0]["emb"][nt])
        emb = ranks[0]["emb"][nt].numpy()
        np.testing.assert_allclose(emb, j[f"{tag}/emb{nt}"], atol=EMB_ABS)
        # flat cluster ids -> (N, L) layer codes
        layers = [np.stack(np.unravel_index(c, RQ_SIZES), axis=1)
                  for c in (ranks[0]["codes"][nt].numpy(),
                            j[f"{tag}/codes{nt}"])]
        near_tie_mismatches(j[f"{tag}/emb{nt}"], books, *layers)
