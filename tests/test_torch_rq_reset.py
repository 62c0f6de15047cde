"""RQ self-healing and eval of the PyTorch port against the JAX package:

  * ``per_code_counts``: bitwise, on 2-D, 1-D and empty codes;
  * ``dead_code_reset``: codebooks, usage and report bitwise, over seeds,
    steps and floors, on the EMA usage and on ``usage=`` overrides, with
    no dead code and with all but one dead;
  * ``reconstruct``: within 1e-6 (f32 sums of the same rows);
  * ``reset_dead_codes`` on a state after a train step: the codebooks
    equal the JAX reset's, the ``Parameter`` objects are the same, and
    the optimizer's state, the histograms, ``ptr``, ``filled``, the pool
    and every other parameter are bit-unchanged;
  * ``make_eval_step`` against the JAX ``make_eval_step`` from the same
    initial parameters (``convert.py``), batch and negative draws, at
    ``tests/test_torch_train.py``'s tolerance for one forward (1e-4
    relative, 1e-7 absolute).
"""
import copy

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
from repro_torch.core import rq_index as RQ
from repro_torch.core import trainer as T
from repro_torch.data.edge_dataset import EdgeDataset, NeighborTables
from repro_torch.optim import optimizers as O
from test_torch_train import jax_draws

torch.set_num_threads(2)

SIZES = (16, 4)
D = 8
RECON_ATOL = 1e-6          # reconstruct: f32 sums of the same rows


@pytest.mark.parametrize("shape", ["2d", "1d", "empty", "size0"])
def test_per_code_counts_matches_jax(shape):
    rng = np.random.default_rng(1)
    sizes = SIZES
    if shape == "2d":
        codes = np.stack([rng.integers(0, n, 50) for n in sizes], axis=1)
    elif shape == "1d":
        codes, sizes = rng.integers(0, 16, 30), (16,)
    elif shape == "empty":
        codes = np.zeros((0, 2), np.int32)
    else:
        codes, sizes = rng.integers(0, 4, (10, 2)), (4, 0)
    got = RQ.per_code_counts(codes, sizes)
    want = JRQ.per_code_counts(codes, sizes)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    if shape == "2d":       # a tensor gives the same counts
        for a, b in zip(RQ.per_code_counts(torch.from_numpy(codes), sizes),
                        want):
            np.testing.assert_array_equal(a, b)


def _books(rng):
    return [(rng.normal(size=(n, D)) * 0.3 / (l + 1)).astype(np.float32)
            for l, n in enumerate(SIZES)]


def _usage(kind, rng, books, h):
    """Per-layer usage of one kind, as numpy f32 arrays."""
    if kind == "ema":            # skewed EMA: some codes far below floor
        u = [rng.random(n).astype(np.float32) ** 4 for n in SIZES]
        return [x / x.sum() for x in u]
    if kind == "occupancy":      # published codes of the probe
        codes = np.asarray(JRQ.assign_codes(
            {"codebooks": {f"layer{l}": jnp.asarray(b)
                           for l, b in enumerate(books)}},
            jnp.asarray(h), JRQCfg(codebook_sizes=SIZES)))
        per = np.stack([codes // SIZES[1], codes % SIZES[1]], axis=1)
        return JRQ.per_code_counts(per, SIZES)
    if kind == "none_dead":
        return [np.full(n, 1.0 / n, np.float32) for n in SIZES]
    assert kind == "one_live"
    return [np.eye(n, dtype=np.float32)[n // 2] for n in SIZES]


@pytest.mark.parametrize("floor", [0.25, 0.9])
@pytest.mark.parametrize("seed,step", [(0, 0), (3, 117)])
@pytest.mark.parametrize("kind,override", [
    ("ema", False), ("occupancy", True), ("none_dead", False),
    ("one_live", True),
])
def test_dead_code_reset_matches_jax_bitwise(kind, override, seed, step,
                                             floor):
    rng = np.random.default_rng(seed * 7 + int(floor * 100))
    books = _books(rng)
    h = rng.normal(size=(60, D)).astype(np.float32)
    h /= np.linalg.norm(h, axis=1, keepdims=True)
    usage = _usage(kind, rng, books, h)
    hists = tuple(rng.integers(0, 4, (5, n)).astype(np.float32)
                  for n in SIZES)
    jcfg = JRQCfg(codebook_sizes=SIZES, hist_len=5, dead_floor=floor)
    pcfg = RQConfig(codebook_sizes=SIZES, hist_len=5, dead_floor=floor)
    ema = usage if not override else [np.full(n, 1.0 / n, np.float32)
                                      for n in SIZES]
    jstate = JRQ.RQState(tuple(map(jnp.asarray, hists)),
                         tuple(map(jnp.asarray, ema)), jnp.int32(3),
                         jnp.int32(5))
    jp, js, jrep = JRQ.dead_code_reset(
        {"codebooks": {f"layer{l}": jnp.asarray(b)
                       for l, b in enumerate(books)}},
        jstate, h, jcfg, seed=seed, step=step,
        usage=usage if override else None)

    rq = RQ.codebooks_module([torch.from_numpy(b.copy()) for b in books])
    pstate = RQ.RQState(tuple(torch.from_numpy(x) for x in hists),
                        tuple(torch.from_numpy(x.copy()) for x in ema), 3, 5)
    pp, ps, prep = RQ.dead_code_reset(
        rq, pstate, torch.from_numpy(h), pcfg, seed=seed, step=step,
        usage=[torch.from_numpy(u) for u in usage] if override else None)

    assert prep == jrep
    for l in range(len(SIZES)):
        got = pp["codebooks"][f"layer{l}"]
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jp["codebooks"][f"layer{l}"]))
        np.testing.assert_array_equal(ps.usage[l].numpy(),
                                      np.asarray(js.usage[l]))
        # the input codebooks are not written: the reset is functional
        np.testing.assert_array_equal(
            rq["codebooks"][f"layer{l}"].detach().numpy(), books[l])
        reset = int(prep[f"reset_layer{l}"])
        changed = (got.numpy() != books[l]).any(axis=1)
        assert int(changed.sum()) == reset
    assert ps.hists is pstate.hists
    assert (ps.ptr, ps.filled) == (3, 5)
    if kind == "none_dead":
        assert sum(prep.values()) == 0
    if kind == "one_live":
        assert prep == {"reset_layer0": SIZES[0] - 1,
                        "reset_layer1": SIZES[1] - 1}


def test_reconstruct_matches_jax():
    rng = np.random.default_rng(5)
    books = _books(rng)
    codes = np.stack([rng.integers(0, n, 33) for n in SIZES], axis=1)
    want = JRQ.reconstruct({"codebooks": {f"layer{l}": jnp.asarray(b)
                                          for l, b in enumerate(books)}},
                           jnp.asarray(codes), JRQCfg(codebook_sizes=SIZES))
    rq = RQ.codebooks_module([torch.from_numpy(b) for b in books])
    got = RQ.reconstruct(rq, torch.from_numpy(codes),
                         RQConfig(codebook_sizes=SIZES))
    assert got.shape == (33, D)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=RECON_ATOL)


# ---------------------------------------------------------------------------
# on a whole train state
# ---------------------------------------------------------------------------

TINY = dict(d_user_feat=64, d_item_feat=64, d_embed=32, n_heads=2,
            d_hidden=64, k_imp=10, k_train=4, n_negatives=12, n_pool_neg=4,
            dtype="float32")
PER_TYPE = {"uu": 16, "ui": 16, "ii": 16}
POOL = 64


@pytest.fixture(scope="module")
def setup(tiny_world, tiny_graph, tiny_tables):
    rq = dict(codebook_sizes=(16, 4), hist_len=20, dead_floor=0.5)
    jcfg = JCfg(**TINY, rq=JRQCfg(**rq))
    pcfg = RankGraph2Config(**TINY, rq=RQConfig(**rq))
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
    d = jcfg.d_embed
    # a pool part filled from earlier steps: the draws reach into it
    pool = JN.NegPoolState(jnp.asarray(rng.normal(size=(POOL, d)) * 0.2,
                                       jnp.float32),
                           jnp.asarray(rng.normal(size=(POOL, d)) * 0.2,
                                       jnp.float32),
                           jnp.int32(40), jnp.int32(0), jnp.int32(40),
                           jnp.int32(0))
    state = JT.TrainState(state.params, state.opt_state, state.rq_state,
                          pool, state.step)
    return dict(jcfg=jcfg, pcfg=pcfg, jds=jds, pds=pds, state=state,
                jopt=jopt, world=tiny_world)


def _port_state(s):
    st = s["state"]
    params = params_from_jax(jax.tree.map(np.asarray, st.params),
                             device="cpu", trainable=True)
    opt = O.rankgraph2_optimizer()
    return T.TrainState(params, opt.init(T.named_params(params)),
                        rq_state_from_jax(st.rq_state, device="cpu"),
                        pool_from_jax(st.pool, device="cpu")), opt


def _draws(s, batch, key):
    """The JAX step's per-direction draws from ``key``."""
    keys = jax.random.split(key, 8)
    pool, cfg = s["state"].pool, s["jcfg"]
    fills = {"uu": pool.user_fill, "ui": pool.item_fill,
             "iu": pool.user_fill, "ii": pool.item_fill}
    return {dn: jax_draws(keys[i], PER_TYPE["uu"], cfg.n_heads,
                          cfg.n_negatives, cfg.n_pool_neg, fills[dn])
            for i, dn in enumerate(T.loss_directions(batch))}


def test_make_eval_step_matches_jax(setup):
    s = setup
    w = s["world"]
    jeval = JT.make_eval_step(s["jcfg"], features=JT.make_feature_store(
        w.user_feat, w.item_feat))
    pstate, _ = _port_state(s)
    pds = s["pds"]
    feats = T.FeatureStore(pds.user_feat, pds.item_feat)
    peval = T.make_eval_step(s["pcfg"], features=feats)
    for t in (0, 5):
        key = jax.random.key(2000 + t)
        pbatch = pds.sample_batch(t, 7, PER_TYPE)
        draws = _draws(s, pbatch, key)
        jbatch = s["jds"].sample_batch(t, 7, PER_TYPE, format="dedup_ids")
        want = jeval(s["state"], jax.tree.map(jnp.asarray, jbatch), key)
        got = peval(pstate, pbatch, draws=draws)
        assert set(got) == set(want)
        for k, v in want.items():
            assert not got[k].requires_grad
            np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-4,
                                       atol=1e-7, err_msg=f"{t} {k}")
        # the eval step is forward_losses(train=False), and changes nothing
        tasks, aux = T.forward_losses(pstate.params, s["pcfg"], pbatch,
                                      pstate.pool, pstate.rq_state,
                                      features=feats, train=False,
                                      draws=draws)
        for k in tasks:
            assert torch.equal(got[k], tasks[k].detach()), k
        assert aux["rq_state"] is pstate.rq_state


def test_reset_dead_codes_in_place_matches_jax(setup):
    s = setup
    pstate, opt = _port_state(s)
    pds = s["pds"]
    feats = T.FeatureStore(pds.user_feat, pds.item_feat)
    step = T.make_train_step(s["pcfg"], opt, features=feats)
    for t in range(2):
        batch = pds.sample_batch(t, 7, PER_TYPE)
        pstate, _ = step(pstate, batch,
                         generator=torch.Generator().manual_seed(t))
    books = pstate.params["rq"]["codebooks"]
    objs = {k: books[k] for k in books}
    before = {k: v.detach().clone()
              for k, v in T.named_params(pstate.params).items()}
    opt_before = copy.deepcopy(pstate.opt_state)
    rq_before = pstate.rq_state
    pool_before = copy.deepcopy(pstate.pool)
    probe = np.random.default_rng(4).normal(size=(48, 32)).astype(np.float32)
    probe /= np.linalg.norm(probe, axis=1, keepdims=True)

    # the repair path's usage: the probe's own code occupancy
    flat = RQ.assign_codes(pstate.params["rq"], torch.from_numpy(probe),
                           s["pcfg"].rq)
    usage = RQ.per_code_counts(torch.stack([flat // 4, flat % 4], dim=1),
                               (16, 4))

    # the JAX reset on the same codebooks, usage and probe
    jcfg = s["jcfg"]
    jstate = JRQ.RQState(
        tuple(jnp.asarray(h.numpy()) for h in rq_before.hists),
        tuple(jnp.asarray(u.numpy()) for u in rq_before.usage),
        jnp.int32(rq_before.ptr), jnp.int32(rq_before.filled))
    jp, js, jrep = JRQ.dead_code_reset(
        {"codebooks": {k.split(".")[-1]: jnp.asarray(v.numpy())
                       for k, v in before.items()
                       if k.startswith("rq.codebooks.")}},
        jstate, probe, jcfg.rq, seed=9, step=2, usage=usage)

    out, rep = T.reset_dead_codes(pstate, probe, s["pcfg"], seed=9, step=2,
                                  usage=usage)
    assert out is pstate and rep == jrep
    assert sum(rep.values()) > 0            # codes were really re-seeded
    for k in books:
        assert books[k] is objs[k]
        np.testing.assert_array_equal(books[k].detach().numpy(),
                                      np.asarray(jp["codebooks"][k]))
    for l, u in enumerate(pstate.rq_state.usage):
        np.testing.assert_array_equal(u.numpy(), np.asarray(js.usage[l]))
    for name, p in T.named_params(pstate.params).items():
        if not name.startswith("rq.codebooks."):
            assert torch.equal(p.detach(), before[name]), name
        else:                               # live rows are bit-unchanged
            live = (p.detach() == before[name]).all(dim=1)
            assert int((~live).sum()) == rep[
                "reset_layer" + name[-1]], name
    assert pstate.rq_state.hists is rq_before.hists
    assert (pstate.rq_state.ptr, pstate.rq_state.filled) == (
        rq_before.ptr, rq_before.filled)

    def same(a, b):
        if isinstance(a, torch.Tensor):
            return torch.equal(a, b)
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(map(same, a, b))
        return a == b
    assert same(pstate.opt_state, opt_before)
    for f in ("user", "item"):
        assert torch.equal(getattr(pstate.pool, f), getattr(pool_before, f))
    assert pstate.step == 2
    # the optimizer's state still fits: one more step and an eval run
    batch = pds.sample_batch(2, 7, PER_TYPE)
    pstate, m = step(pstate, batch, generator=torch.Generator().manual_seed(2))
    assert all(np.isfinite(float(v)) for v in m.values())
    ev = T.make_eval_step(s["pcfg"], features=feats)(
        pstate, batch, generator=torch.Generator().manual_seed(3))
    assert all(np.isfinite(float(v)) for v in ev.values())
