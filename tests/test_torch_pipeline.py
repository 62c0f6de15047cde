"""The construct-and-train slice end to end on the CPU:
``run_pipeline(device="cpu", steps=3)`` of the port on the shared tiny
world against JAX ``run_pipeline`` on the same world.  Graph and PPR
tables are bitwise equal (they do not depend on the training steps, so
the JAX run takes none); the port's losses are finite at every step, its
parameters moved, its embeddings have unit norm and its codes are in
range."""
import numpy as np
import pytest
import torch

from repro.configs.base import RankGraph2Config as JCfg, RQConfig as JRQCfg
from repro.core import pipeline as JPL
from repro.core.pipeline import run_pipeline as jax_run_pipeline
from repro_torch.configs.base import RankGraph2Config, RQConfig
from repro_torch.core import pipeline as PL
from repro_torch.core import trainer as T
from repro_torch.core.pipeline import run_pipeline

torch.set_num_threads(2)

TINY = dict(d_user_feat=64, d_item_feat=64, d_embed=32, n_heads=2,
            d_hidden=64, k_imp=10, k_train=4, n_negatives=12, n_pool_neg=4,
            dtype="float32")
RUN = dict(steps=3, batch_per_type=16, pool_size=64, seed=2)


@pytest.fixture(scope="module")
def runs(tiny_world):
    pcfg = RankGraph2Config(**TINY, rq=RQConfig(codebook_sizes=(16, 4),
                                                hist_len=20))
    jcfg = JCfg(**TINY, rq=JRQCfg(codebook_sizes=(16, 4), hist_len=20))
    port = run_pipeline(tiny_world, pcfg, device="cpu", **RUN)
    ref = jax_run_pipeline(tiny_world, jcfg, **dict(RUN, steps=0))
    return port, ref, pcfg


def test_graph_and_tables_match_jax_bitwise(runs):
    port, ref, _ = runs
    for et in ("ui", "uu", "ii"):
        for f in ("src", "dst", "weight"):
            np.testing.assert_array_equal(getattr(getattr(port.graph, et), f),
                                          getattr(getattr(ref.graph, et), f),
                                          err_msg=f"{et}.{f}")
    np.testing.assert_array_equal(port.tables.user_nbrs, ref.tables.user_nbrs)
    np.testing.assert_array_equal(port.tables.item_nbrs, ref.tables.item_nbrs)
    assert (port.tables.user_nbrs >= 0).any()


def test_training_ran_and_outputs_are_sane(runs, tiny_world):
    port, _, cfg = runs
    assert len(port.history) == RUN["steps"]
    for m in port.history:
        assert all(np.isfinite(v) for v in m.values()), m
        assert m["grad_norm"] > 0.0
    assert port.metrics == port.history[-1]
    assert port.state.step == RUN["steps"]
    fresh, _ = T.init_state(cfg, generator=torch.Generator().manual_seed(
        RUN["seed"]), pool_size=RUN["pool_size"], device="cpu")
    moved = (port.state.params["agg_user"].w
             - fresh.params["agg_user"].w).detach().abs().max()
    assert float(moved) > 1e-4
    for emb, n in ((port.user_emb, tiny_world.n_users),
                   (port.item_emb, tiny_world.n_items)):
        assert emb.shape == (n, cfg.d_embed) and emb.dtype == torch.float32
        np.testing.assert_allclose(emb.norm(dim=1).numpy(), 1.0, atol=1e-5)
    codes = port.user_codes.numpy()
    assert codes.shape == (tiny_world.n_users,)
    assert codes.min() >= 0 and codes.max() < 16 * 4
    assert set(port.seconds) == {"construct", "ppr", "train", "embed"}
    assert port.state.pool.user_fill > 0 and port.state.pool.item_fill > 0
    assert port.state.rq_state.ptr == RUN["steps"]


@pytest.mark.parametrize("strategy", ["topweight", "random"])
def test_fallback_tables_and_edge_stripping_match_jax(runs, strategy):
    """Table 6's single-hop neighbour strategies and Table 5's edge-type
    subsets, on the same graph: bitwise."""
    port, ref, _ = runs
    pg = PL._strip_edge_types(port.graph, ("ui", "ii"))
    jg = JPL._strip_edge_types(ref.graph, ("ui", "ii"))
    assert len(pg.uu) == 0 and len(pg.ii) == len(jg.ii) > 0
    for g_p, g_j in ((port.graph, ref.graph), (pg, jg)):
        pt = PL._fallback_tables(g_p, 10, strategy, seed=4)
        jt = JPL._fallback_tables(g_j, 10, strategy, seed=4)
        np.testing.assert_array_equal(pt.user_nbrs, jt.user_nbrs)
        np.testing.assert_array_equal(pt.item_nbrs, jt.item_nbrs)
        assert (pt.user_nbrs >= 0).any() and (pt.item_nbrs >= 0).any()
