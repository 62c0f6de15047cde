"""Graph construction of the PyTorch port against the JAX package, bitwise:
the synthetic world, ``build_graph`` (U-I / U-U / I-I src, dst and weight,
in order, with and without the Eq. 3 correction, with hub subsampling
triggered) and ``padded_adjacency``."""
import numpy as np
import pytest
import torch

from repro.core import graph_builder as JGB
from repro.data import synthetic as JS
from repro_torch.core import graph_builder as GB
from repro_torch.data import synthetic as S

torch.set_num_threads(2)

N_USERS, N_ITEMS = 500, 800


@pytest.fixture(scope="module")
def worlds():
    kw = dict(n_users=N_USERS, n_items=N_ITEMS, events_per_user=12.0,
              noise_frac=0.1, seed=3)
    return S.make_world(**kw), JS.make_world(**kw)


def _same_edges(a, b, what):
    for f in ("src", "dst", "weight"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, (what, f, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=f"{what}.{f}")


def test_make_world_matches_jax_bitwise(worlds):
    pw, jw = worlds
    for f in ("user_latent", "item_latent", "user_feat", "item_feat",
              "item_pop"):
        np.testing.assert_array_equal(getattr(pw, f), getattr(jw, f),
                                      err_msg=f)
    for day in ("day0", "day1"):
        a, b = getattr(pw, day), getattr(jw, day)
        for f in ("user_id", "item_id", "event_type", "timestamp"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f"{day}.{f}")
    gp = S.next_day_ground_truth(pw)
    gj = JS.next_day_ground_truth(jw)
    for a, b in zip(gp, gj):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("alpha_pop,hub_cap", [(0.3, 32), (0.0, 32),
                                               (0.3, 6)])
def test_build_graph_matches_jax_bitwise(worlds, alpha_pop, hub_cap):
    pw, jw = worlds
    pg = GB.build_graph(pw.day0, alpha_pop=alpha_pop, k_cap=16,
                        hub_cap=hub_cap, seed=5, keep_state=True)
    jg = JGB.build_graph(jw.day0, alpha_pop=alpha_pop, k_cap=16,
                         hub_cap=hub_cap, seed=5, keep_state=True)
    for et in ("ui", "uu", "ii"):
        assert len(getattr(pg, et)) > 0, et
        _same_edges(getattr(pg, et), getattr(jg, et), et)
    np.testing.assert_array_equal(pg.group1_users, jg.group1_users)
    np.testing.assert_array_equal(pg.group1_items, jg.group1_items)
    for f in ("uu_raw", "ii_raw", "ui_full"):
        _same_edges(getattr(pg.refresh, f), getattr(jg.refresh, f), f)
    for tag in ("uu", "ii"):
        a, b = pg.refresh.hub_draws[tag], jg.refresh.hub_draws[tag]
        for f in ("anchor_ids", "offsets", "lens"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    if hub_cap == 6:      # the subsample must really have triggered
        assert len(pg.refresh.hub_draws["ii"].anchor_ids) > 0
        assert len(pg.refresh.hub_draws["uu"].anchor_ids) > 0
    assert pg.build_seconds >= 0.0


def test_hub_uniforms_and_offsets_match_jax():
    ids = np.array([0, 5, 4095, 4096, 9000, 123456], np.int64)
    lens = np.array([40, 33, 100, 50, 64, 35], np.int64)
    for tag in ("uu", "ii"):
        np.testing.assert_array_equal(GB.hub_uniforms(7, tag, ids, 16),
                                      JGB.hub_uniforms(7, tag, ids, 16))
        np.testing.assert_array_equal(
            GB._hub_offsets(7, tag, ids, lens, 16, None),
            JGB._hub_offsets(7, tag, ids, lens, 16, None))


@pytest.mark.parametrize("max_deg", [4, 32])
def test_padded_adjacency_matches_jax(worlds, max_deg):
    pw, jw = worlds
    pg = GB.build_graph(pw.day0, k_cap=16, hub_cap=12)
    jg = JGB.build_graph(jw.day0, k_cap=16, hub_cap=12)
    for et, n in (("ui", N_USERS), ("uu", N_USERS), ("ii", N_ITEMS)):
        pn, pwt = GB.padded_adjacency(getattr(pg, et), n, max_deg)
        jn, jwt = JGB.padded_adjacency(getattr(jg, et), n, max_deg)
        np.testing.assert_array_equal(pn, jn)
        np.testing.assert_array_equal(pwt, jwt)
    empty = GB.EdgeSet(np.zeros(0, np.int64), np.zeros(0, np.int64),
                       np.zeros(0, np.float32))
    pn, pwt = GB.padded_adjacency(empty, 3, max_deg)
    assert (pn == -1).all() and (pwt == 0).all()
