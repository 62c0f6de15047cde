"""The port's evaluation protocols and recall gate against the JAX
package's, on the shared tiny world (``tests/conftest.py``).

``core/evaluation.py`` and the gate (``lifecycle/publish.py``:
``cluster_neighbor_users``, ``cluster_user_recall``, ``i2i_item_recall``,
``evaluate_snapshot``) are the same host numpy in both packages, so the
same inputs must give bitwise the same results: every function on f32
embeddings, the gate on a snapshot the JAX package built, and the bf16
case.  There the JAX package hands numpy ``ml_dtypes.bfloat16`` arrays
(``embed_all`` in ``cfg.dtype``) and the port a bf16 tensor, whose host
copy (``host_embeddings``) is float64: numpy computes the reference's
bf16 arrays in float64 in every gate expression.
"""
import dataclasses

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import evaluation as JE
from repro.lifecycle import publish as JP
from repro.lifecycle.snapshot import IndexSnapshot as JSnap
from repro_torch.core import evaluation as PE
from repro_torch.data.synthetic import make_world
from repro_torch.lifecycle import publish as PP
from repro_torch.lifecycle.snapshot import IndexSnapshot as PSnap

torch.set_num_threads(2)

D, SIZES = 16, (8, 4)


@pytest.fixture(scope="module")
def worlds(tiny_world):
    pw = make_world(n_users=300, n_items=400, events_per_user=25.0, seed=0)
    for f in ("user_id", "item_id", "event_type", "timestamp"):
        np.testing.assert_array_equal(getattr(tiny_world.day1, f),
                                      getattr(pw.day1, f))
    rng = np.random.default_rng(0)
    nu, ni = tiny_world.n_users, tiny_world.n_items
    user_emb = np.ascontiguousarray(
        tiny_world.user_latent @ rng.normal(size=(
            tiny_world.user_latent.shape[1], D))).astype(np.float32)
    item_emb = rng.normal(size=(ni, D)).astype(np.float32)
    params = {"codebooks": {
        "layer0": user_emb[rng.choice(nu, SIZES[0], replace=False)],
        "layer1": rng.normal(size=(SIZES[1], D)).astype(np.float32) * .1}}
    from repro.configs.base import RankGraph2Config, RQConfig
    jcfg = RankGraph2Config(rq=RQConfig(codebook_sizes=SIZES), d_embed=D,
                            dtype="float32")
    jsnap, recon = JP.build_snapshot(1, user_emb, item_emb, params, jcfg,
                                     i2i_k=6, want_user_recon=True)
    psnap = PSnap(**{f.name: getattr(jsnap, f.name)
                     for f in dataclasses.fields(JSnap)})
    pairs = np.stack([rng.integers(0, nu, 200), rng.integers(0, nu, 200)],
                     axis=1)
    return dict(jw=tiny_world, pw=pw, user_emb=user_emb, item_emb=item_emb,
                recon=np.asarray(recon), jsnap=jsnap, psnap=psnap,
                pairs=pairs)


def _same(a, b):
    """Bitwise equality of nested results (dicts, tuples, lists of sets,
    arrays, floats)."""
    assert type(a) is type(b) or (isinstance(a, float)
                                  and isinstance(b, float)), (a, b)
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b, (a, b)


@pytest.mark.parametrize("k", [1, 7, 299, 400])
def test_topk_neighbors_bitwise(worlds, k):
    e = worlds["user_emb"]
    q = np.random.default_rng(k).choice(len(e), 50, replace=False)
    kk = min(k, len(e) - 1)
    a = JE._topk_neighbors(e, q, k, chunk=16)[:, :kk]
    _same(PE._topk_neighbors(e, q, k, chunk=16)[:, :kk], a)


def test_user_day1_items_bitwise(worlds):
    for n in (None, 250, 310):
        _same(PE._user_day1_items(worlds["pw"].day1, n),
              JE._user_day1_items(worlds["jw"].day1, n))


@pytest.mark.parametrize("seed", [0, 5])
def test_user_and_item_recall_bitwise(worlds, seed):
    w = worlds
    _same(PE.user_recall(w["user_emb"], w["pw"], ks=(5, 20, 100),
                         n_queries=80, seed=seed),
          JE.user_recall(w["user_emb"], w["jw"], ks=(5, 20, 100),
                         n_queries=80, seed=seed))
    _same(PE.day1_co_pairs(w["pw"].day1, n_edges=300, seed=seed),
          JE.day1_co_pairs(w["jw"].day1, n_edges=300, seed=seed))
    _same(PE.item_recall(w["item_emb"], w["pw"], ks=(5, 50), n_edges=300,
                         seed=seed),
          JE.item_recall(w["item_emb"], w["jw"], ks=(5, 50), n_edges=300,
                         seed=seed))


@pytest.mark.parametrize("neg_range", [None, (0, 150)])
def test_index_hitrate_bitwise(worlds, neg_range):
    w = worlds
    _same(PE.index_hitrate(w["user_emb"], w["recon"], w["pairs"],
                           ks=(1, 5, 10), seed=3, neg_range=neg_range),
          JE.index_hitrate(w["user_emb"], w["recon"], w["pairs"],
                           ks=(1, 5, 10), seed=3, neg_range=neg_range))


def test_gate_functions_bitwise_on_a_jax_snapshot(worlds):
    w = worlds
    q = np.arange(0, 300, 7)
    for k, f in ((10, 4), (40, 1), (25, 8)):
        _same(PP.cluster_neighbor_users(w["psnap"], w["user_emb"], q, k,
                                        n_probe_factor=f),
              JP.cluster_neighbor_users(w["jsnap"], w["user_emb"], q, k,
                                        n_probe_factor=f))
    _same(PP.cluster_user_recall(w["psnap"], w["user_emb"], w["pw"],
                                 ks=(10, 100), n_queries=60, seed=2),
          JP.cluster_user_recall(w["jsnap"], w["user_emb"], w["jw"],
                                 ks=(10, 100), n_queries=60, seed=2))
    _same(PP.i2i_item_recall(w["psnap"], w["pw"], n_edges=200, seed=1),
          JP.i2i_item_recall(w["jsnap"], w["jw"], n_edges=200, seed=1))


@pytest.mark.parametrize("extras", [False, True])
def test_evaluate_snapshot_bitwise(worlds, extras):
    w = worlds
    kw = dict(hitrate_pairs=w["pairs"]) if extras else {}
    a = JP.evaluate_snapshot(w["jsnap"], w["user_emb"], w["recon"], w["jw"],
                             recall_k=20, n_queries=50, seed=4,
                             item_emb=w["item_emb"] if extras else None,
                             **kw)
    b = PP.evaluate_snapshot(
        w["psnap"], torch.from_numpy(w["user_emb"]),
        torch.from_numpy(w["recon"]), w["pw"], recall_k=20, n_queries=50,
        seed=4, item_emb=torch.from_numpy(w["item_emb"]) if extras
        else None, **kw)
    _same(b, a)
    assert ("hitrate10_recon" in b) == extras
    assert ("item_recall_ratio" in b) == extras
    _same(PP.snapshot_health(w["psnap"]), JP.snapshot_health(w["jsnap"]))


def test_bf16_embeddings_gate_bitwise(worlds):
    """bf16 embeddings: the reference's ``ml_dtypes.bfloat16`` arrays and
    the port's bf16 tensors with the same bits give the same gate
    numbers, because the port's host copy is the exact float64 value."""
    w = worlds
    ub = torch.from_numpy(w["user_emb"]).to(torch.bfloat16)
    ib = torch.from_numpy(w["item_emb"]).to(torch.bfloat16)
    host = PP.host_embeddings(ub)
    assert host.dtype == np.float64
    assert PP.host_embeddings(torch.from_numpy(w["recon"])).dtype \
        == np.float32
    j_ub = ub.float().numpy().astype(ml_dtypes.bfloat16)
    j_ib = ib.float().numpy().astype(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(j_ub.astype(np.float64), host)
    a = JP.evaluate_snapshot(w["jsnap"], j_ub, w["recon"], w["jw"],
                             recall_k=20, n_queries=50, seed=4,
                             hitrate_pairs=w["pairs"], item_emb=j_ib)
    b = PP.evaluate_snapshot(w["psnap"], ub, torch.from_numpy(w["recon"]),
                             w["pw"], recall_k=20, n_queries=50, seed=4,
                             hitrate_pairs=w["pairs"], item_emb=ib)
    _same(b, a)
    np.testing.assert_array_equal(
        PE._topk_neighbors(host, np.arange(40), 10),
        JE._topk_neighbors(j_ub, np.arange(40), 10))
