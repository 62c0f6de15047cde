"""The publish-and-serve slice end to end, port against the JAX package,
on the shared tiny world (``tests/conftest.py``):

  * ``embed_all`` with the same params and batch: float32 to 1e-5;
  * ``build_snapshot`` fed the JAX embeddings: codes (near-tie rule),
    clusters, member CSR, I2I table and health metrics equal;
  * the next day's events ingested into both stores, then
    ``serve_batch`` for every user: bitwise equal.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import model as JM
from repro.core import rq_index as JRQ
from repro.core import trainer as JT
from repro.core.serving import ClusterQueueStore as JaxStore
from repro.lifecycle import publish as JP
from repro_torch.configs.base import RQConfig, RankGraph2Config
from repro_torch.convert import params_from_jax
from repro_torch.core import model as M
from repro_torch.core.rq_index import assign_codes
from repro_torch.core.serving import ClusterQueueStore
from repro_torch.core.trainer import embed_all
from repro_torch.data.edge_dataset import EdgeDataset, NeighborTables
from repro_torch.lifecycle import publish as P
from test_torch_rq_assign import near_tie_mismatches

torch.set_num_threads(2)

BATCH = 128


def _port_cfg(jcfg) -> RankGraph2Config:
    d = dataclasses.asdict(jcfg)
    d["rq"] = RQConfig(**d["rq"])
    return RankGraph2Config(**d)


@pytest.fixture(scope="module")
def world(tiny_world, tiny_tables, tiny_cfg, tiny_dataset):
    k1, k2 = jax.random.split(jax.random.key(0))
    jp, _ = JM.init_params(k1, tiny_cfg)
    jp["rq"], _, _ = JRQ.init_rq(k2, tiny_cfg.rq, tiny_cfg.d_embed)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    ds = EdgeDataset(NeighborTables(tiny_tables.user_nbrs,
                                    tiny_tables.item_nbrs,
                                    tiny_tables.n_users,
                                    tiny_tables.n_items),
                     tiny_world.user_feat, tiny_world.item_feat,
                     k_train=tiny_cfg.k_train, device="cpu")
    nu, ni = tiny_tables.n_users, tiny_tables.n_items
    ids = {JM.USER: np.arange(nu), JM.ITEM: nu + np.arange(ni)}
    jemb = {t: np.asarray(JT.embed_all(jp, tiny_cfg, tiny_dataset,
                                       node_type=t, ids=i, batch=BATCH),
                          np.float32) for t, i in ids.items()}
    return dict(jp=jp, tp=tp, ds=ds, ids=ids, jemb=jemb,
                pcfg=_port_cfg(tiny_cfg), jcfg=tiny_cfg)


@pytest.mark.parametrize("node_type", [JM.USER, JM.ITEM])
def test_embed_all_matches_jax(world, node_type):
    emb = embed_all(world["tp"], world["pcfg"], world["ds"],
                    node_type=node_type, ids=world["ids"][node_type],
                    batch=BATCH)
    assert emb.dtype == torch.float32 and emb.shape[1] == 24
    np.testing.assert_allclose(emb.numpy(), world["jemb"][node_type],
                               rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def snapshots(world):
    ju, ji = world["jemb"][JM.USER], world["jemb"][JM.ITEM]
    jsnap = JP.build_snapshot(1, ju, ji, world["jp"]["rq"], world["jcfg"],
                              i2i_k=8)
    psnap = P.build_snapshot(1, torch.from_numpy(ju), torch.from_numpy(ji),
                             world["tp"]["rq"], world["pcfg"], i2i_k=8)
    return jsnap, psnap


def test_build_snapshot_matches_jax(world, snapshots):
    jsnap, psnap = snapshots
    books = [np.asarray(world["jp"]["rq"]["codebooks"][f"layer{l}"])
             for l in range(2)]
    for emb, pc, jc in ((world["jemb"][JM.USER], psnap.user_codes,
                         jsnap.user_codes),
                        (world["jemb"][JM.ITEM], psnap.item_codes,
                         jsnap.item_codes)):
        assert pc.dtype == np.int32 and pc.shape == jc.shape
        near_tie_mismatches(emb, books, pc, jc)
    # the tiny world has no near-tie: every derived array is equal
    for f in ("user_codes", "item_codes", "user_clusters", "member_ptr",
              "member_ids", "coarse_codebook", "i2i"):
        np.testing.assert_array_equal(getattr(psnap, f), getattr(jsnap, f),
                                      err_msg=f)
    for f in ("version", "n_users", "n_items", "codebook_sizes",
              "gate_metrics"):
        assert getattr(psnap, f) == getattr(jsnap, f), f
    assert P.snapshot_health(psnap) == JP.snapshot_health(jsnap)
    np.testing.assert_array_equal(
        assign_codes(world["tp"]["rq"], torch.from_numpy(
            world["jemb"][JM.USER]), world["pcfg"].rq).numpy(),
        jsnap.user_clusters)


def test_ingest_day1_and_serve_match_jax(tiny_world, snapshots):
    jsnap, psnap = snapshots
    kw = dict(queue_len=16, recency_s=6 * 3600.0, n_clusters=jsnap.n_clusters)
    port = ClusterQueueStore(psnap.user_clusters, device="cpu", **kw)
    ref = JaxStore(jsnap.user_clusters, **kw)
    d1 = tiny_world.day1
    for lo in range(0, len(d1.user_id), 1000):
        sl = slice(lo, lo + 1000)
        port.ingest(d1.user_id[sl], d1.item_id[sl], d1.timestamp[sl])
        ref.ingest(d1.user_id[sl], d1.item_id[sl], d1.timestamp[sl])
    np.testing.assert_array_equal(port.items, ref.items)
    np.testing.assert_array_equal(port.cursor, ref.cursor)
    users = np.arange(-2, tiny_world.n_users + 3)
    for now in (float(d1.timestamp.max()), float(np.median(d1.timestamp))):
        sp, up = port.serve_batch(users, now, n_recent=8, k=32,
                                  i2i=psnap.i2i)
        sr, ur = ref.serve_batch(users, now, n_recent=8, k=32, i2i=jsnap.i2i)
        np.testing.assert_array_equal(sp, sr)
        np.testing.assert_array_equal(up, ur)
        assert (sp[:, 0] >= 0).any() and (up[:, 0] >= 0).any()
    assert M.USER == JM.USER and M.ITEM == JM.ITEM
