"""PPR construction of the PyTorch port against the JAX package, bitwise:
the keyed uniform stream, the ``ppr_walk`` plain version (against the
JAX oracle and the JAX Pallas kernel in interpret mode, with dangling
rows, -1 pads and rows whose f32 cum tops out below 1), and
``precompute_ppr_neighbors`` with the ``numpy`` and ``device`` (here:
CPU) backends against the JAX ``numpy`` backend."""
import numpy as np
import pytest
import torch

from repro.core import graph_builder as JGB
from repro.core import ppr as JP
from repro.kernels.ppr_walk.ppr_walk import ppr_walk as jax_pallas_walk
from repro.kernels.ppr_walk.ref import ppr_walk_ref as jax_walk_ref
from repro_torch.core import graph_builder as GB
from repro_torch.core import ppr as P
from repro_torch.data.edge_dataset import build_neighbor_tables
from repro_torch.data.synthetic import make_world
from repro_torch.kernels.ppr_walk.ops import ppr_walk
from repro_torch.kernels.ppr_walk.ref import last_valid_cols

torch.set_num_threads(2)


def _adj(N, D2, seed):
    """Random padded adjacency: some dangling rows, -1 tails, and a third
    of the rows scaled so their f32 cum tops out below 1."""
    rng = np.random.default_rng(seed)
    nbrs = rng.integers(0, N, (N, D2)).astype(np.int64)
    deg = rng.integers(0, D2 + 1, N)
    deg[: max(1, N // 10)] = 0                     # dangling
    mask = np.arange(D2)[None, :] < deg[:, None]
    nbrs = np.where(mask, nbrs, -1)
    probs = np.where(mask, rng.random((N, D2)), 0.0)
    tot = probs.sum(1, keepdims=True)
    probs = np.where(tot > 0, probs / np.maximum(tot, 1e-12), 0.0)
    short = rng.random(N) < 1 / 3
    probs[short] *= 0.97
    return nbrs, np.cumsum(probs, 1).astype(np.float32)


@pytest.mark.parametrize("n_users", [0, 5000])
def test_walk_uniforms_bitwise(n_users):
    ids = np.array([0, 1, 4095, 4096, 4097, 8191, 12000, n_users,
                    n_users + 4095, n_users + 4096, n_users + 9999],
                   np.int64)
    np.testing.assert_array_equal(P.walk_uniforms(3, ids, 4, 3, n_users),
                                  JP.walk_uniforms(3, ids, 4, 3, n_users))
    assert P.U_BLOCK == JP.U_BLOCK


def test_last_valid_cols_match():
    _, cum = _adj(300, 16, 1)
    want = JP.last_valid_cols(cum)
    np.testing.assert_array_equal(P.last_valid_cols(cum), want)
    np.testing.assert_array_equal(
        last_valid_cols(torch.from_numpy(cum)).numpy(), want)


@pytest.mark.parametrize("N,D2,n,W,L", [
    (64, 8, 16, 4, 3), (128, 16, 8, 8, 2), (200, 4, 12, 2, 5),
])
def test_ppr_walk_plain_matches_jax_oracle_and_pallas(N, D2, n, W, L):
    nbrs, cum = _adj(N, D2, N + D2)
    starts = np.random.default_rng(n).integers(0, N, n).astype(np.int64)
    u = JP.walk_uniforms(0, starts, W, L)
    vp, cp = ppr_walk(torch.from_numpy(nbrs), torch.from_numpy(cum),
                      torch.from_numpy(starts), torch.from_numpy(u),
                      restart=0.15)
    assert vp.dtype == torch.int32 and cp.dtype == torch.int32
    vr, cr = jax_walk_ref(nbrs, cum, starts, u, restart=0.15)
    np.testing.assert_array_equal(vp.numpy(), vr)
    np.testing.assert_array_equal(cp.numpy(), cr)
    vk, ck = jax_pallas_walk(nbrs, cum, starts, u, restart=0.15,
                             interpret=True)
    np.testing.assert_array_equal(vp.numpy(), np.asarray(vk))
    np.testing.assert_array_equal(cp.numpy(), np.asarray(ck))
    assert (cp.numpy().sum(axis=1) == W * L).all()


def test_ppr_walk_plain_matches_numpy_walker_at_width_64():
    """The main path's width (D2 64, 64 walkers, 5 steps) against the
    JAX numpy walker on the same uniforms, dangling starts included."""
    nbrs, cum = _adj(600, 64, 9)
    starts = np.arange(0, 600, 7, dtype=np.int64)
    adj = JP.PaddedHeteroAdj(nbrs, cum, 600, 0)
    want = JP._walk_numpy(adj, starts, n_walks=64, walk_len=5,
                          restart=0.15, seed=2, chunk=1 << 10)
    u = JP.walk_uniforms(2, starts, 64, 5, 600)
    vp, cp = ppr_walk(torch.from_numpy(nbrs), torch.from_numpy(cum),
                      torch.from_numpy(starts), torch.from_numpy(u),
                      restart=0.15)
    np.testing.assert_array_equal(vp.numpy(), want)
    srt = np.sort(want, axis=1)
    np.testing.assert_array_equal(
        np.sort(cp.numpy(), axis=1),
        np.sort(JP._run_length_counts(srt), axis=1))


@pytest.fixture(scope="module")
def graphs():
    w = make_world(n_users=260, n_items=340, events_per_user=14.0,
                   noise_frac=0.1, seed=4)
    return (GB.build_graph(w.day0, k_cap=16, hub_cap=12),
            JGB.build_graph(w.day0, k_cap=16, hub_cap=12))


@pytest.mark.parametrize("hub_alpha", [0.5, 0.0])
@pytest.mark.parametrize("backend", ["numpy", "device"])
def test_precompute_ppr_neighbors_matches_jax(graphs, backend, hub_alpha):
    pg, jg = graphs
    kw = dict(k_imp=10, n_walks=12, walk_len=3, seed=1,
              max_deg_per_type=8, hub_alpha=hub_alpha)
    pu, pi, st = P.precompute_ppr_neighbors(pg, backend=backend,
                                            device="cpu",
                                            return_state=True, **kw)
    ju, ji, jst = JP.precompute_ppr_neighbors(jg, backend="numpy",
                                              return_state=True, **kw)
    assert pu.dtype == ju.dtype and pi.dtype == ji.dtype
    np.testing.assert_array_equal(pu, ju)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(st.visited, jst.visited)
    np.testing.assert_array_equal(st.nbrs, jst.nbrs)
    np.testing.assert_array_equal(st.cum, jst.cum)
    assert (pu >= 0).any() and (pi >= 0).any()


def test_build_neighbor_tables_device_backend_on_cpu(graphs):
    pg, jg = graphs
    from repro.data.edge_dataset import build_neighbor_tables as jbuild
    t = build_neighbor_tables(pg, k_imp=10, n_walks=12, walk_len=3, seed=2,
                              backend="device", device="cpu")
    j = jbuild(jg, k_imp=10, n_walks=12, walk_len=3, seed=2)
    np.testing.assert_array_equal(t.user_nbrs, j.user_nbrs)
    np.testing.assert_array_equal(t.item_nbrs, j.item_nbrs)
    assert (t.n_users, t.n_items) == (j.n_users, j.n_items)


def test_device_topk_matches_host_topk_on_ties():
    """Visit-order counts (device top-k) against sorted run-length counts
    (host top-k) on rows full of equal scores."""
    rng = np.random.default_rng(0)
    vis = rng.integers(0, 40, (50, 30)).astype(np.int64)
    starts = np.arange(50, dtype=np.int64) % 40
    glob = JP.global_visit_mass(vis, 40)
    want = JP.topk_by_count(vis, starts, 7, 25, 25, hub_alpha=0.5,
                            glob=glob)
    v = torch.from_numpy(vis)
    from repro_torch.kernels.ppr_walk.ref import first_occurrence_counts
    got = P._topk_from_counts_device(
        v, first_occurrence_counts(v), torch.from_numpy(starts), 7, 25,
        0.5, glob)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)
