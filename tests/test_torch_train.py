"""Training of the PyTorch port against the JAX package, in float32 on the
same inputs:

  * ``sample_negatives`` with the JAX draws injected (reproduced with
    ``jax.random`` from the same keys): bitwise;
  * ``update_pool``, with and without wrapping past the ring: bitwise;
  * ``rq_forward``: codes and histograms equal, losses within 1e-5,
    usage within 1e-6, gradients with respect to the codebooks and h
    within 1e-5;
  * two ``rankgraph2_optimizer`` steps on a small tree: within 1e-6;
  * one and four whole train steps on a tiny config from the JAX state,
    on the port's ``sample_batch`` (bitwise equal to the JAX batch) with
    the JAX negative draws: per-task losses and the total within 1e-4
    relative at every step, ``grad_norm`` within 1e-4, parameters after
    the steps within 1e-5, RQ state and pool equal (floats within
    1e-5).
"""
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
from repro.optim import optimizers as JO
from repro_torch.configs.base import RankGraph2Config, RQConfig
from repro_torch.convert import (params_from_jax, pool_from_jax,
                                 rq_state_from_jax)
from repro_torch.core import graph_builder as GB
from repro_torch.core import negatives as N
from repro_torch.core import rq_index as RQ
from repro_torch.core import trainer as T
from repro_torch.data.edge_dataset import EdgeDataset, NeighborTables
from repro_torch.optim import optimizers as O

torch.set_num_threads(2)


def jax_draws(key, B, H, n_neg, n_pool, pool_fill):
    """The index draws JAX ``sample_negatives`` makes from ``key``, as
    ``negatives.negative_draws`` lays them out."""
    n_inb, n_pool, n_aug = N.split_counts(n_neg, n_pool, H)
    hi = jnp.maximum(B, 2)
    k1, k2, k3 = jax.random.split(key, 3)
    fill = jnp.maximum(pool_fill, 1)
    d = dict(inb=jax.random.randint(k1, (B, n_inb), 1, hi),
             pool=jax.random.randint(k2, (B, n_pool), 0, fill),
             fallback=jax.random.randint(k3, (B, n_pool), 1, hi),
             aug_off=jax.random.randint(jax.random.fold_in(key, 7),
                                        (B, n_aug), 1, hi),
             aug_head=jax.random.randint(jax.random.fold_in(key, 8),
                                         (B, n_aug), 0, H))
    return {k: torch.from_numpy(np.asarray(v).astype(np.int64))
            for k, v in d.items()}


@pytest.mark.parametrize("pool_fill", [0, 13])
@pytest.mark.parametrize("H", [1, 3])
def test_sample_negatives_with_jax_draws_is_bitwise(pool_fill, H):
    rng = np.random.default_rng(H + pool_fill)
    B, d, n_neg, n_pool = 16, 8, 12, 4
    prim = rng.normal(size=(B, d)).astype(np.float32)
    heads = rng.normal(size=(B, H, d)).astype(np.float32)
    pool = rng.normal(size=(20, d)).astype(np.float32)
    key = jax.random.key(5)
    fill = jnp.int32(pool_fill)
    want = JN.sample_negatives(key, jnp.asarray(prim), jnp.asarray(heads),
                               jnp.asarray(pool), fill, n_neg, n_pool)
    got = N.sample_negatives(
        torch.from_numpy(prim), torch.from_numpy(heads),
        torch.from_numpy(pool), pool_fill, n_neg, n_pool,
        draws=jax_draws(key, B, H, n_neg, n_pool, fill))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # drawn from a generator: the right shape, never the row itself
    g = torch.Generator().manual_seed(0)
    own = N.sample_negatives(torch.from_numpy(prim), torch.from_numpy(heads),
                             torch.from_numpy(pool), pool_fill, n_neg,
                             n_pool, generator=g)
    assert own.shape == (B, n_neg, d)
    n_inb = N.split_counts(n_neg, n_pool, H)[0]
    assert not (own[:, :n_inb] == torch.from_numpy(prim)[:, None]
                ).all(-1).any()


@pytest.mark.parametrize("B,ptr,fill", [(7, 3, 3), (30, 15, 20)])
def test_update_pool_matches_jax(B, ptr, fill):
    rng = np.random.default_rng(B)
    P, d = 20, 4
    user = rng.normal(size=(P, d)).astype(np.float32)
    item = rng.normal(size=(P, d)).astype(np.float32)
    emb = rng.normal(size=(B, d)).astype(np.float32)
    js = JN.NegPoolState(jnp.asarray(user), jnp.asarray(item),
                         jnp.int32(ptr), jnp.int32(5), jnp.int32(fill),
                         jnp.int32(20))
    jn = JN.update_pool(js, jnp.asarray(emb), None)
    ps = N.NegPoolState(torch.from_numpy(user.copy()),
                        torch.from_numpy(item.copy()), ptr, 5, fill, 20)
    pn = N.update_pool(ps, torch.from_numpy(emb), None)
    np.testing.assert_array_equal(pn.user.numpy(), np.asarray(jn.user))
    np.testing.assert_array_equal(pn.item.numpy(), np.asarray(jn.item))
    assert (pn.user_ptr, pn.user_fill, pn.item_ptr, pn.item_fill) == (
        int(jn.user_ptr), int(jn.user_fill), int(jn.item_ptr),
        int(jn.item_fill))


RQ_SIZES = (16, 4)


def _rq_inputs(seed=0, B=40, d=8):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(B, d)).astype(np.float32)
    h /= np.linalg.norm(h, axis=1, keepdims=True)
    books = {f"layer{l}": (rng.normal(size=(n, d)) * 0.3 / (l + 1)
                           ).astype(np.float32)
             for l, n in enumerate(RQ_SIZES)}
    hists = tuple(rng.integers(0, 4, (5, n)).astype(np.float32)
                  for n in RQ_SIZES)
    usage = tuple((rng.random(n) / n).astype(np.float32) for n in RQ_SIZES)
    return h, books, hists, usage


@pytest.mark.parametrize("biased", [True, False])
def test_rq_forward_matches_jax(biased):
    h, books, hists, usage = _rq_inputs()
    w = np.random.default_rng(1).normal(size=h.shape).astype(np.float32)
    jcfg = JRQCfg(codebook_sizes=RQ_SIZES, hist_len=5,
                  biased_selection=biased)
    pcfg = RQConfig(codebook_sizes=RQ_SIZES, hist_len=5,
                    biased_selection=biased)
    jstate = JRQ.RQState(tuple(map(jnp.asarray, hists)),
                         tuple(map(jnp.asarray, usage)), jnp.int32(7),
                         jnp.int32(5))

    def jloss(params, hh):
        out = JRQ.rq_forward(params, jstate, hh, jcfg)
        return (out["l_recon"] + out["l_reg"] + out["l_util"]
                + jnp.sum(out["recon_st"] * w)), out

    (jl, jout), (jg_p, jg_h) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
            {"codebooks": {k: jnp.asarray(v) for k, v in books.items()}},
            jnp.asarray(h))

    rq = RQ.codebooks_module([torch.from_numpy(books[f"layer{l}"])
                              for l in range(len(RQ_SIZES))])
    rq.requires_grad_(True)
    ht = torch.from_numpy(h).requires_grad_(True)
    pstate = rq_state_from_jax(jstate, device="cpu")
    out = RQ.rq_forward(rq, pstate, ht, pcfg)
    loss = (out["l_recon"] + out["l_reg"] + out["l_util"]
            + (out["recon_st"] * torch.from_numpy(w)).sum())
    loss.backward()

    np.testing.assert_array_equal(out["codes"].numpy(),
                                  np.asarray(jout["codes"]))
    for k in ("l_recon", "l_reg", "l_util"):
        np.testing.assert_allclose(float(out[k].detach()), float(jout[k]),
                                   atol=1e-5,
                                   rtol=1e-5, err_msg=k)
    assert float(out["l_util"].detach()) >= 0.0
    assert float(out["l_reg"].detach()) > 0.0
    np.testing.assert_allclose(out["recon"].detach().numpy(),
                               np.asarray(jout["recon"]), atol=1e-6)
    ns, js = out["state"], jout["state"]
    assert (ns.ptr, ns.filled) == (int(js.ptr), int(js.filled))
    for a, b in zip(ns.hists, js.hists):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(ns.usage, js.usage):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(jg_h), atol=1e-5)
    for l in range(len(RQ_SIZES)):
        np.testing.assert_allclose(
            rq["codebooks"][f"layer{l}"].grad.numpy(),
            np.asarray(jg_p["codebooks"][f"layer{l}"]), atol=1e-5)
    assert RQ.codebook_utilization(ns) == JRQ.codebook_utilization(js)


@pytest.mark.parametrize("biased", [True, False])
def test_rq_forward_on_its_own_codes_is_unchanged(biased):
    """``codes=`` set to the selections ``rq_forward`` makes itself gives
    the same outputs, bit for bit."""
    h, books, hists, usage = _rq_inputs(seed=2)
    cfg = RQConfig(codebook_sizes=RQ_SIZES, hist_len=5,
                   biased_selection=biased)
    rq = RQ.codebooks_module([torch.from_numpy(books[f"layer{l}"])
                              for l in range(len(RQ_SIZES))])
    state = RQ.RQState(tuple(map(torch.from_numpy, hists)),
                       tuple(map(torch.from_numpy, usage)), 7, 5)
    ht = torch.from_numpy(h)
    a = RQ.rq_forward(rq, state, ht, cfg)
    b = RQ.rq_forward(rq, state, ht, cfg, codes=a["codes"].to(torch.int32))
    for k in ("codes", "recon", "recon_st", "l_recon", "l_reg", "l_util"):
        assert torch.equal(a[k], b[k]), k
    for x, y in zip(a["state"].hists + a["state"].usage,
                    b["state"].hists + b["state"].usage):
        assert torch.equal(x, y)


@pytest.mark.parametrize("train", [True, False])
def test_rq_forward_takes_given_codes(train):
    """Given codes are the selections: the reconstruction is the sum of
    their codewords, and the histogram row counts them."""
    h, books, hists, usage = _rq_inputs(seed=3)
    cfg = RQConfig(codebook_sizes=RQ_SIZES, hist_len=5)
    rq = RQ.codebooks_module([torch.from_numpy(books[f"layer{l}"])
                              for l in range(len(RQ_SIZES))])
    state = RQ.RQState(tuple(map(torch.from_numpy, hists)),
                       tuple(map(torch.from_numpy, usage)), 7, 5)
    ht = torch.from_numpy(h)
    rng = np.random.default_rng(4)
    codes = torch.from_numpy(np.stack(
        [rng.integers(0, n, len(h)) for n in RQ_SIZES], axis=1))
    out = RQ.rq_forward(rq, state, ht, cfg, train=train, codes=codes)
    assert torch.equal(out["codes"], codes)
    want = sum(torch.from_numpy(books[f"layer{l}"])[codes[:, l]]
               for l in range(len(RQ_SIZES)))
    np.testing.assert_allclose(out["recon"].numpy(), want.numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(
        float(out["l_recon"]),
        float(((ht - want) ** 2).sum(1).mean() * (1 + cfg.commit_coef)),
        rtol=1e-5)
    if train:
        for l, n in enumerate(RQ_SIZES):
            row = out["state"].hists[l][state.ptr % cfg.hist_len]
            assert torch.equal(row, torch.bincount(codes[:, l], minlength=n)
                               .to(torch.float32))
    else:
        assert out["state"] is state


def test_rankgraph2_optimizer_two_steps_match_jax():
    rng = np.random.default_rng(0)
    shapes = {"codebooks/layer0": (6, 3), "emb/table": (5, 2),
              "dense/w": (3, 4), "dense/b": (4,), "uncertainty/x": ()}

    def nest(flat):
        out = {}
        for k, v in flat.items():
            a, b = k.split("/")
            out.setdefault(a, {})[b] = v
        return out

    params = {k: np.asarray(rng.normal(size=s), np.float32)
              for k, s in shapes.items()}
    grads = [{k: np.asarray(rng.normal(size=s) * 10 ** rng.uniform(-4, 1),
                            np.float32) for k, s in shapes.items()}
             for _ in range(2)]
    jopt = JO.rankgraph2_optimizer()
    jp = nest({k: jnp.asarray(v) for k, v in params.items()})
    js = jopt.init(jp)
    popt = O.rankgraph2_optimizer()
    pp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ps = popt.init(pp)
    for g in grads:
        jg, jn = JO.clip_by_global_norm(
            nest({k: jnp.asarray(v) for k, v in g.items()}), 1.0)
        ju, js = jopt.update(jg, js, jp)
        jp = JO.apply_updates(jp, ju)
        pg, pn = O.clip_by_global_norm(
            {k: torch.from_numpy(v) for k, v in g.items()}, 1.0)
        np.testing.assert_allclose(float(pn), float(jn), rtol=1e-6)
        pu, ps = popt.update(pg, ps, pp)
        O.apply_updates(pp, pu)
        for k in shapes:
            a, b = k.split("/")
            np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[a][b]),
                                       atol=1e-6, err_msg=k)
    assert set(ps["true"]) == {"codebooks/layer0", "emb/table"}


# ---------------------------------------------------------------------------
# one whole train step
# ---------------------------------------------------------------------------

TINY = dict(d_user_feat=64, d_item_feat=64, d_embed=32, n_heads=2,
            d_hidden=64, k_imp=10, k_train=4, n_negatives=12, n_pool_neg=4,
            dtype="float32")
PER_TYPE = {"uu": 16, "ui": 16, "ii": 16}
POOL = 64


def _port_param_name(name):
    """Port parameter name -> (JAX tree path, transpose?)."""
    parts = name.split(".")
    if parts[-1] == "weight":
        return parts[:-1] + ["w"], True
    if parts[-1] == "bias":
        return parts[:-1] + ["b"], False
    return parts, False


def _jax_leaf(tree, path):
    for p in path:
        tree = tree[p]
    return np.asarray(tree)


@pytest.fixture(scope="module")
def step_setup(tiny_world, tiny_graph, tiny_tables):
    jcfg = JCfg(**TINY, rq=JRQCfg(codebook_sizes=(16, 4), hist_len=20))
    pcfg = RankGraph2Config(**TINY, rq=RQConfig(codebook_sizes=(16, 4),
                                                hist_len=20))
    jds = JDataset(tiny_graph, tiny_tables, tiny_world.user_feat,
                   tiny_world.item_feat, k_train=4, batch_format="dedup_ids")
    pg = GB.build_graph(tiny_world.day0, k_cap=16, hub_cap=12)
    pds = EdgeDataset(NeighborTables(tiny_tables.user_nbrs,
                                     tiny_tables.item_nbrs,
                                     tiny_tables.n_users,
                                     tiny_tables.n_items),
                      tiny_world.user_feat, tiny_world.item_feat, k_train=4,
                      device="cpu", g=pg)
    state, _, jopt = JT.init_state(jax.random.key(3), jcfg, pool_size=POOL)
    rng = np.random.default_rng(11)
    # a pool part filled from earlier steps, histograms with history,
    # non-zero log-variances: the step starts from a state mid-training
    d = jcfg.d_embed
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
    return dict(jcfg=jcfg, pcfg=pcfg, jds=jds, pds=pds, state=state,
                jopt=jopt, world=tiny_world)


def test_sample_batch_matches_jax_bitwise(step_setup):
    s = step_setup
    for step in (0, 3):
        jb = s["jds"].sample_batch(step, 7, PER_TYPE, format="dedup_ids")
        pb = s["pds"].sample_batch(step, 7, PER_TYPE)
        for grp in ("nodes", "edges"):
            assert list(pb[grp]) == list(jb[grp])
            for k, sub in jb[grp].items():
                assert list(pb[grp][k]) == list(sub), (grp, k)
                for f, v in sub.items():
                    got = pb[grp][k][f].numpy()
                    assert got.dtype == np.asarray(v).dtype, (grp, k, f)
                    np.testing.assert_array_equal(got, v,
                                                  err_msg=f"{grp}.{k}.{f}")


@pytest.mark.parametrize("n_steps", [1, 4])
def test_train_steps_match_jax(step_setup, n_steps):
    """``n_steps`` steps from the same state; with 4, the optimizer
    moments, the pool ring and the histogram ring carry across steps."""
    s = step_setup
    jcfg, pcfg, state, w = s["jcfg"], s["pcfg"], s["state"], s["world"]
    jstep = JT.make_train_step(
        jcfg, s["jopt"], features=JT.make_feature_store(w.user_feat,
                                                        w.item_feat),
        donate=False)
    jp = jax.tree.map(np.asarray, state.params)
    pstate = T.TrainState(params_from_jax(jp, device="cpu", trainable=True),
                          None, rq_state_from_jax(state.rq_state,
                                                  device="cpu"),
                          pool_from_jax(state.pool, device="cpu"))
    popt = O.rankgraph2_optimizer()
    pstate.opt_state = popt.init(T.named_params(pstate.params))
    pds = s["pds"]
    step = T.make_train_step(pcfg, popt, features=T.FeatureStore(
        pds.user_feat, pds.item_feat))
    jnew, pnew = state, pstate
    for t in range(n_steps):
        key = jax.random.key(1000 + t)
        # the JAX step's per-direction negative draws
        keys = jax.random.split(key, 8)
        pool = jnew.pool
        fills = {"uu": pool.user_fill, "ui": pool.item_fill,
                 "iu": pool.user_fill, "ii": pool.item_fill}
        pbatch = pds.sample_batch(t, 7, PER_TYPE)
        dirs = T.loss_directions(pbatch)
        assert dirs == ("ii", "ui", "iu", "uu")   # sorted, as JAX sees it
        draws = {dn: jax_draws(keys[i], PER_TYPE["uu"], jcfg.n_heads,
                               jcfg.n_negatives, jcfg.n_pool_neg, fills[dn])
                 for i, dn in enumerate(dirs)}
        jbatch = s["jds"].sample_batch(t, 7, PER_TYPE, format="dedup_ids")
        jnew, jm = jstep(jnew, jax.tree.map(jnp.asarray, jbatch), key)
        pnew, pm = step(pnew, pbatch, draws=draws)
        assert set(pm) == set(jm)
        for k, v in jm.items():
            np.testing.assert_allclose(float(pm[k]), float(v), rtol=1e-4,
                                       atol=1e-7, err_msg=f"step {t} {k}")

    jparams = jax.tree.map(np.asarray, jnew.params)
    names = list(T.named_params(pnew.params))
    assert len(names) == len(jax.tree.leaves(jparams))
    for name, p in T.named_params(pnew.params).items():
        path, tr = _port_param_name(name)
        want = _jax_leaf(jparams, path)
        got = p.detach().numpy()
        np.testing.assert_allclose(got.T if tr else got, want, atol=1e-5,
                                   err_msg=name)
    # the step moved the parameters
    moved = np.abs(_jax_leaf(jparams, ["agg_user", "w"])
                   - _jax_leaf(jp, ["agg_user", "w"])).max()
    assert moved > 1e-4
    for a, b in zip(pnew.rq_state.hists, jnew.rq_state.hists):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(pnew.rq_state.usage, jnew.rq_state.usage):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    assert pnew.rq_state.ptr == int(jnew.rq_state.ptr)
    for f in ("user", "item"):
        np.testing.assert_allclose(getattr(pnew.pool, f).numpy(),
                                   np.asarray(getattr(jnew.pool, f)),
                                   atol=1e-5)
        for g in ("ptr", "fill"):
            assert getattr(pnew.pool, f"{f}_{g}") == int(
                getattr(jnew.pool, f"{f}_{g}"))
    assert pnew.step == n_steps
