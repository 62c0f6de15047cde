"""The rankgraph2 trainer's three batch layouts and the L' double draw,
the port against the JAX package on the same inputs (the tiny world of
``tests/conftest.py``, 16 edges a type, f32):

  * ``sample_batch`` in ``legacy`` and ``dedup``: bitwise equal to JAX's
    (ids, maps, masks, features, weights), at two steps;
  * ``expand_batch`` of a ``dedup`` and of a ``dedup_ids`` batch: bitwise
    equal to JAX's;
  * ``Prefetcher`` over ``iter_batches``: the same batches in order, and
    its thread ends after ``close``;
  * one train step in each layout from the same mid-training JAX state
    with the JAX negative draws, held as ``tests/test_torch_train.py``
    holds a step: losses and ``grad_norm`` within 1e-4 relative, the RQ
    histograms equal, usage within 1e-6, the pool within 1e-5;
    parameters within 1e-5 for ``dedup_ids`` and ``dedup``, and for
    ``legacy`` by the distribution of their gaps
    (``tests/test_torch_dp_train.py``'s: a median within 1e-6, at most 1%
    of entries more than 1e-4 apart) and none more than one AdamW step of
    the dense learning rate, 0.004; in the port ``dedup`` bitwise equal
    to ``dedup_ids``, ``legacy`` on ``expand_batch`` of the same batch
    held as above against it;
  * ``reuse_lprime_negatives=False``: one step against JAX's with the
    reference's sampled indices for both banks (``draw_keys``: the L
    banks, then one L' bank a edge type), held as above; with each L'
    bank equal to the bank it reuses, every loss bitwise the reusing
    step's; with distinct banks, every loss but ``rq_contrastive``
    bitwise unchanged;
  * the data-parallel step on four gloo ranks on the CPU with ``dedup``
    packs (and with ``reuse_lprime_negatives=False``) and with ``legacy``
    batches, at 30 uu, 32 ui and 29 ii edges (shard-local and whole-batch
    negatives in one step), against the one-process global step on the
    same draws: losses within 1e-5 relative, gradients within 1e-5
    relative norm-wise, the ranks' RQ selections in global row order
    equal.
"""
import dataclasses as dc
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RankGraph2Config as JCfg, RQConfig as JRQCfg
from repro.core import negatives as JN
from repro.core import rq_index as JRQ
from repro.core import trainer as JT
from repro.data.edge_dataset import EdgeDataset as JDataset
from repro_torch.configs.base import RankGraph2Config, RQConfig
from repro_torch.convert import (params_from_jax, pool_from_jax,
                                 rq_state_from_jax)
from repro_torch.core import graph_builder as GB
from repro_torch.core import negatives as N
from repro_torch.core import trainer as T
from repro_torch.data.edge_dataset import (EdgeDataset, NeighborTables,
                                           Prefetcher)
from repro_torch.optim import optimizers as O

from test_torch_dp_train import _global_rows, _norm_rel, _run_ranks
from test_torch_train import _jax_leaf, _port_param_name, jax_draws

torch.set_num_threads(2)

TINY = dict(d_user_feat=64, d_item_feat=64, d_embed=32, n_heads=2,
            d_hidden=64, k_imp=10, k_train=4, n_negatives=12, n_pool_neg=4,
            dtype="float32")
PER_TYPE = {"uu": 16, "ui": 16, "ii": 16}
POOL = 64
LOSS_REL, LOSS_ABS = 1e-4, 1e-7
PARAM_ATOL = 1e-5
# the gap distribution where the first update's size takes its sign from
# the summation order; GAP_MAX is one AdamW step of the dense learning
# rate (a gradient whose sign flips moves twice that)
GAP_MEDIAN, GAP_FAR, GAP_FAR_SHARE, GAP_MAX = 1e-6, 1e-4, 0.01, 0.004
DP_PER = {"uu": 30, "ui": 32, "ii": 29}
DP, DP_REL = 4, 1e-5
FILL_OF = {"uu": "user", "ui": "item", "iu": "user", "ii": "item"}


def _cfgs(reuse=True):
    rq = dict(codebook_sizes=(16, 4), hist_len=20)
    return (JCfg(**TINY, reuse_lprime_negatives=reuse, rq=JRQCfg(**rq)),
            RankGraph2Config(**TINY, reuse_lprime_negatives=reuse,
                             rq=RQConfig(**rq)))


@pytest.fixture(scope="module")
def setup(tiny_world, tiny_graph, tiny_tables):
    jcfg, _ = _cfgs()
    jds = JDataset(tiny_graph, tiny_tables, tiny_world.user_feat,
                   tiny_world.item_feat, k_train=4)
    pg = GB.build_graph(tiny_world.day0, k_cap=16, hub_cap=12)
    pds = EdgeDataset(NeighborTables(tiny_tables.user_nbrs,
                                     tiny_tables.item_nbrs,
                                     tiny_tables.n_users,
                                     tiny_tables.n_items),
                      tiny_world.user_feat, tiny_world.item_feat, k_train=4,
                      device="cpu", g=pg)
    state, _, jopt = JT.init_state(jax.random.key(3), jcfg, pool_size=POOL)
    rng = np.random.default_rng(11)
    d = jcfg.d_embed
    # a partly filled pool, histograms with history, non-zero
    # log-variances: a state mid-training
    pool = JN.NegPoolState(jnp.asarray(rng.normal(size=(POOL, d)) * 0.2,
                                       jnp.float32),
                           jnp.asarray(rng.normal(size=(POOL, d)) * 0.2,
                                       jnp.float32),
                           jnp.int32(40), jnp.int32(0), jnp.int32(40),
                           jnp.int32(0))
    hists = tuple(jnp.asarray(rng.integers(0, 5, (20, n)), jnp.float32)
                  for n in (16, 4))
    rq_state = JRQ.RQState(hists, state.rq_state.usage, jnp.int32(9),
                           jnp.int32(9))
    params = dict(state.params)
    params["uncertainty"] = {k: jnp.float32(rng.normal() * 0.1)
                             for k in params["uncertainty"]}
    state = JT.TrainState(params, jopt.init(params), rq_state, pool,
                          state.step)
    return dict(jds=jds, pds=pds, state=state, jopt=jopt,
                world=tiny_world)


def _assert_tree_equal(got, want, path=""):
    """A port batch (tensors) bitwise equal to a JAX one (numpy), keys
    in the same order, dtypes equal."""
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}.{k}")
        return
    g = got.numpy()
    assert g.dtype == np.asarray(want).dtype, path
    np.testing.assert_array_equal(g, want, err_msg=path)


def _numpy(tree):
    return {k: _numpy(v) if isinstance(v, dict) else v.numpy()
            for k, v in tree.items()}


@pytest.mark.parametrize("fmt", ["legacy", "dedup"])
def test_sample_batch_matches_jax_bitwise(setup, fmt):
    for step in (0, 3):
        want = setup["jds"].sample_batch(step, 7, PER_TYPE, format=fmt)
        got = setup["pds"].sample_batch(step, 7, PER_TYPE, format=fmt)
        _assert_tree_equal(got, want, f"{fmt}/{step}")


@pytest.mark.parametrize("fmt", ["dedup", "dedup_ids"])
def test_expand_batch_matches_jax_bitwise(setup, fmt):
    want = setup["jds"].expand_batch(
        setup["jds"].sample_batch(2, 7, PER_TYPE, format=fmt))
    got = setup["pds"].expand_batch(
        setup["pds"].sample_batch(2, 7, PER_TYPE, format=fmt))
    _assert_tree_equal(got, want, fmt)
    # the expansion is the legacy layout
    legacy = setup["pds"].sample_batch(2, 7, PER_TYPE, format="legacy")
    assert list(got) == list(legacy)
    assert all(set(got[et]) == set(legacy[et]) for et in got)


def test_prefetcher_yields_iter_batches_in_order_and_stops(setup):
    pds = setup["pds"]
    pre = Prefetcher(pds.iter_batches(5, PER_TYPE, start_step=2), depth=2)
    for step in (2, 3, 4):
        _assert_tree_equal(next(pre), _numpy(pds.sample_batch(step, 5,
                                                              PER_TYPE)),
                           str(step))
    pre.close()
    pre.t.join(timeout=30)
    assert not pre.t.is_alive()
    assert pre.q.qsize() <= 1


def _port_state(state):
    jp = jax.tree.map(np.asarray, state.params)
    st = T.TrainState(params_from_jax(jp, device="cpu", trainable=True),
                      None, rq_state_from_jax(state.rq_state, device="cpu"),
                      pool_from_jax(state.pool, device="cpu"))
    st.opt_state = O.rankgraph2_optimizer().init(T.named_params(st.params))
    return st


def _jax_bank_draws(cfg, pcfg, pbatch, key, pool):
    """The reference's draws from ``key`` for every bank of
    ``draw_keys`` (``keys[i]`` for the i-th)."""
    keys = jax.random.split(key, 8)
    rows = T.edge_rows(pbatch)
    out = {}
    for i, name in enumerate(T.draw_keys(pcfg, pbatch)):
        et = name.replace("lprime_", "")
        fill = getattr(pool, f"{FILL_OF[et]}_fill")
        out[name] = jax_draws(keys[i], rows["ui" if et == "iu" else et],
                              cfg.n_heads, cfg.n_negatives, cfg.n_pool_neg,
                              fill)
    return out


def _jax_step(setup, cfg, fmt, t=0):
    w = setup["world"]
    jstep = JT.make_train_step(cfg, setup["jopt"],
                               features=JT.make_feature_store(
                                   w.user_feat, w.item_feat), donate=False)
    jbatch = setup["jds"].sample_batch(t, 7, PER_TYPE, format=fmt)
    return jstep(setup["state"], jax.tree.map(jnp.asarray, jbatch),
                 jax.random.key(1000 + t))


def _port_step(setup, pcfg, fmt, draws=None, t=0, batch=None):
    pds = setup["pds"]
    st = _port_state(setup["state"])
    feats = T.FeatureStore(pds.user_feat, pds.item_feat) \
        if fmt == "dedup_ids" else None
    step = T.make_train_step(pcfg, O.rankgraph2_optimizer(), features=feats)
    if batch is None:
        batch = pds.sample_batch(t, 7, PER_TYPE, format=fmt)
    if draws is None:
        draws = _jax_bank_draws(pcfg, pcfg, batch, jax.random.key(1000 + t),
                                setup["state"].pool)
    st, m = step(st, batch, draws=draws)
    return st, m, draws


def _gaps_held(got, want, tag):
    """Parameters after a step by the distribution of their gaps, as
    ``tests/test_torch_dp_train.py`` holds them (ROADMAP's "Optimizer
    sign" hazard: the first update of a near-zero gradient sum takes its
    size from the summation order)."""
    d = np.abs(got - want).ravel()
    far = float(np.mean(d > GAP_FAR))
    assert np.median(d) <= GAP_MEDIAN and far <= GAP_FAR_SHARE \
        and d.max() <= GAP_MAX, (tag, np.median(d), far, d.max())


def _held(pst, pm, jst, jm, tag, elementwise):
    """A port step against JAX's: losses and ``grad_norm`` within
    ``LOSS_REL``; parameters elementwise within ``PARAM_ATOL`` where
    ``elementwise``, else by ``_gaps_held``; the RQ histograms and
    pointer equal, usage within 1e-6, the pool within 1e-5 and its
    pointers and fills equal (``tests/test_torch_train.py``'s)."""
    assert set(pm) == set(jm), tag
    for k, v in jm.items():
        np.testing.assert_allclose(float(pm[k]), float(v), rtol=LOSS_REL,
                                   atol=LOSS_ABS, err_msg=f"{tag} {k}")
    jparams = jax.tree.map(np.asarray, jst.params)
    names = T.named_params(pst.params)
    assert len(names) == len(jax.tree.leaves(jparams)), tag
    for name, p in names.items():
        path, tr = _port_param_name(name)
        got = p.detach().numpy()
        got, want = got.T if tr else got, _jax_leaf(jparams, path)
        if elementwise:
            np.testing.assert_allclose(got, want, atol=PARAM_ATOL,
                                       err_msg=f"{tag} {name}")
        else:
            _gaps_held(got, want, f"{tag} {name}")
    for a, b in zip(pst.rq_state.hists, jst.rq_state.hists):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=tag)
    for a, b in zip(pst.rq_state.usage, jst.rq_state.usage):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   err_msg=tag)
    assert pst.rq_state.ptr == int(jst.rq_state.ptr), tag
    for f in ("user", "item"):
        np.testing.assert_allclose(getattr(pst.pool, f).numpy(),
                                   np.asarray(getattr(jst.pool, f)),
                                   atol=1e-5, err_msg=f"{tag} pool {f}")
        for g in ("ptr", "fill"):
            assert getattr(pst.pool, f"{f}_{g}") == int(
                getattr(jst.pool, f"{f}_{g}")), (tag, f, g)


@pytest.fixture(scope="module")
def layout_steps(setup):
    """One step of each layout in the port on the JAX draws, and one of
    the legacy layout on ``expand_batch`` of the ``dedup_ids`` batch (the
    same neighbour draws)."""
    _, pcfg = _cfgs()
    out = {fmt: _port_step(setup, pcfg, fmt)
           for fmt in ("dedup_ids", "dedup", "legacy")}
    pds = setup["pds"]
    out["expanded"] = _port_step(
        setup, pcfg, "legacy", draws=out["dedup_ids"][2],
        batch=pds.expand_batch(pds.sample_batch(0, 7, PER_TYPE)))
    return out


@pytest.mark.parametrize("fmt", ["dedup_ids", "dedup", "legacy"])
def test_train_step_in_each_layout_matches_jax(setup, layout_steps, fmt):
    jcfg, _ = _cfgs()
    jst, jm = _jax_step(setup, jcfg, fmt)
    pst, pm, _ = layout_steps[fmt]
    _held(pst, pm, jst, jm, fmt, elementwise=fmt != "legacy")


def test_layouts_against_each_other(layout_steps):
    """``dedup`` is ``dedup_ids``'s arithmetic: bitwise; ``legacy`` on the
    expansion of the same batch encodes every endpoint again and sums in
    another order: within the f32 tolerances."""
    a, ma, _ = layout_steps["dedup_ids"]
    b, mb, _ = layout_steps["dedup"]
    c, mc, _ = layout_steps["expanded"]
    assert set(ma) == set(mb) == set(mc)
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
        np.testing.assert_allclose(float(mc[k]), float(ma[k]), rtol=LOSS_REL,
                                   atol=LOSS_ABS, err_msg=k)
    pa, pb, pc = (T.named_params(s.params) for s in (a, b, c))
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
        _gaps_held(pc[k].detach().numpy(), pa[k].detach().numpy(), k)
    assert torch.equal(a.pool.user, b.pool.user)
    for x, y in zip(a.rq_state.hists, b.rq_state.hists):
        assert torch.equal(x, y)


def test_no_feature_store_for_id_only_packs_raises(setup):
    _, pcfg = _cfgs()
    st = _port_state(setup["state"])
    step = T.make_train_step(pcfg, O.rankgraph2_optimizer())
    with pytest.raises(ValueError, match="FeatureStore"):
        step(st, setup["pds"].sample_batch(0, 7, PER_TYPE),
             generator=torch.Generator().manual_seed(0))


def test_double_draw_matches_jax(setup):
    jcfg, pcfg = _cfgs(reuse=False)
    jst, jm = _jax_step(setup, jcfg, "dedup_ids")
    pst, pm, draws = _port_step(setup, pcfg, "dedup_ids")
    assert list(draws) == ["ii", "ui", "iu", "uu", "lprime_ii", "lprime_ui",
                           "lprime_uu"]
    _held(pst, pm, jst, jm, "double draw", elementwise=False)


def test_double_draw_against_the_reusing_step(setup, layout_steps):
    """L' banks equal to the banks they reuse: every task loss and the
    total bitwise the reusing step's (the gradients reach the banks' rows
    through two gathers, not one, so their sums may round apart: the
    parameters within the gap distribution); distinct banks: only
    ``rq_contrastive`` moves."""
    _, pcfg = _cfgs(reuse=False)
    _, m_reuse, draws = layout_steps["dedup_ids"]
    same = dict(draws, **{f"lprime_{et}": draws[et]
                          for et in ("ii", "ui", "uu")})
    st, m = _port_step(setup, pcfg, "dedup_ids", draws=same)[:2]
    assert set(m) == set(m_reuse)
    for k in m:
        if k != "grad_norm":
            assert torch.equal(m[k], m_reuse[k]), k
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(m_reuse["grad_norm"]), rtol=1e-6)
    a = T.named_params(st.params)
    b = T.named_params(layout_steps["dedup_ids"][0].params)
    for k in a:
        _gaps_held(a[k].detach().numpy(), b[k].detach().numpy(), k)
    g = torch.Generator().manual_seed(9)
    pool = setup["state"].pool
    other = dict(draws, **{
        f"lprime_{et}": N.negative_draws(
            PER_TYPE[et], pcfg.n_heads, pcfg.n_negatives, pcfg.n_pool_neg,
            int(getattr(pool, f"{FILL_OF[et]}_fill")), generator=g)
        for et in ("ii", "ui", "uu")})
    _, m2 = _port_step(setup, pcfg, "dedup_ids", draws=other)[:2]
    for k in m2:
        if k in ("rq_contrastive", "total", "grad_norm"):
            continue
        assert torch.equal(m2[k], m_reuse[k]), k
    assert not torch.equal(m2["rq_contrastive"], m_reuse["rq_contrastive"])


RANK = textwrap.dedent("""
    import sys, torch
    torch.set_num_threads(1)
    from repro_torch.core import negatives as N
    from repro_torch.core import trainer as T
    from repro_torch.distributed.sharding import ShardingCtx, make_rules
    from repro_torch.launch.mesh import init_distributed, make_mesh
    rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    init_distributed(rank, world, f"{tmp}/rdv", device="cpu")
    mesh = make_mesh((world,), ("data",))
    ctx = ShardingCtx(make_rules(mesh), mesh)
    inp = torch.load(f"{tmp}/inputs.pt", weights_only=False)
    out = {}
    for name, (cfg, batch, draws) in inp["cases"].items():
        st = torch.load(f"{tmp}/inputs.pt", weights_only=False)["state"]
        sg = T.make_grad_step(cfg, ctx)(st, batch, draws=draws)
        res = dict(tasks={k: float(v) for k, v in sg.tasks.items()},
                   grads={k: g.detach().clone() for k, g in sg.grads.items()},
                   codes=sg.aux["codes"].clone())
        if rank == 0:
            gst = torch.load(f"{tmp}/inputs.pt", weights_only=False)["state"]
            blk = N.shard_block_for(batch["edges"]["ui"]["src_map"].shape[0]
                                    if "nodes" in batch else
                                    batch["ui"]["weight"].shape[0], world)
            g = T.make_grad_step(cfg, shard_block=blk)(gst, batch,
                                                        draws=draws)
            res["global"] = dict(
                tasks={k: float(v) for k, v in g.tasks.items()},
                grads={k: v.detach().clone() for k, v in g.grads.items()},
                codes=g.aux["codes"].clone())
        out[name] = res
    torch.save(out, f"{tmp}/rank{rank}.pt")
    torch.distributed.destroy_process_group()
""")


def test_data_parallel_step_in_dedup_and_legacy_layouts(setup, tmp_path):
    """Four gloo ranks against the one-process global step on the same
    draws: ``dedup`` packs (``rank_batch`` cuts their features), the same
    with the L' double draw (``_rank_draws`` cuts its banks), and
    ``legacy`` batches."""
    pds = setup["pds"]
    _, pcfg = _cfgs()
    _, pcfg2 = _cfgs(reuse=False)
    g = torch.Generator().manual_seed(4)
    pool = setup["state"].pool

    def draws(cfg, batch):
        rows = T.edge_rows(batch)
        out = {}
        for name in T.draw_keys(cfg, batch):
            et = name.replace("lprime_", "")
            B = rows["ui" if et == "iu" else et]
            out[name] = N.negative_draws(
                B, cfg.n_heads, cfg.n_negatives, cfg.n_pool_neg,
                int(getattr(pool, f"{FILL_OF[et]}_fill")), generator=g,
                shard_block=N.shard_block_for(B, DP))
        return out
    cases = {}
    for name, cfg, fmt in (("dedup", pcfg, "dedup"),
                           ("dedup-double", pcfg2, "dedup"),
                           ("legacy", pcfg, "legacy")):
        batch = pds.sample_batch(1, 7, DP_PER, format=fmt)
        cases[name] = (cfg, batch, draws(cfg, batch))
    torch.save(dict(state=_port_state(setup["state"]), cases=cases),
               tmp_path / "inputs.pt")
    _run_ranks(RANK, DP, tmp_path)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(DP)]
    for name in cases:
        want = ranks[0][name]["global"]
        for r in range(DP):
            got = ranks[r][name]
            assert set(got["tasks"]) == set(want["tasks"]), name
            for k, v in want["tasks"].items():
                assert abs(got["tasks"][k] - v) <= DP_REL * max(abs(v),
                                                                1e-6), \
                    (name, r, k, got["tasks"][k], v)
            for k, v in want["grads"].items():
                assert _norm_rel(got["grads"][k].numpy(), v.numpy()) \
                    <= DP_REL, (name, r, k)
        got = _global_rows([ranks[r][name]["codes"] for r in range(DP)],
                           DP_PER)
        assert torch.equal(got, want["codes"]), name
