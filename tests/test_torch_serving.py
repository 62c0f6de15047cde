"""Port ``ClusterQueueStore`` (direct mode) against the JAX package's,
bitwise: the same event stream goes into both, and after every batch
the rings, the cursors, ``retrieve_batch`` and ``serve_batch`` must be
equal — across ring wraps, dup-heavy streams, unknown, post-snapshot and
negative user ids, recency-cutoff edges and empty batches.  Plus the
offline I2I table and the U2I2I union on the same inputs."""
import numpy as np
import pytest
import torch

from repro.core.serving import (ClusterQueueStore as JaxStore,
                                build_i2i_knn as jax_i2i,
                                u2i2i_retrieve_batch as jax_u2i2i)
from repro_torch.core.serving import (ClusterQueueStore, build_i2i_knn,
                                      u2i2i_retrieve_batch)

torch.set_num_threads(2)

N_USERS, N_CLUSTERS, N_ITEMS = 32, 6, 10      # tiny item space: dup-heavy
# probe users: known, repeated, post-snapshot ids and a negative id
PROBES = np.array([0, 1, 1, 5, 17, 31, N_USERS, N_USERS + 9, -1])


def _batches(rng, n_batches, t0=0.0, span=10.0, id_hi=N_USERS + 4):
    """Batched stream with non-decreasing timestamps; ``id_hi`` past the
    table mixes in unknown ids; empty batches occur."""
    out, t = [], t0
    for _ in range(n_batches):
        n = int(rng.integers(0, 40))
        u = rng.integers(0, id_hi, n)
        it = rng.integers(0, N_ITEMS, n)
        ts = t + np.sort(rng.random(n)) * span
        t += span
        out.append((u, it, ts))
    return out


def _assert_same_state(port, ref):
    np.testing.assert_array_equal(port.items, ref.items)
    np.testing.assert_array_equal(port.times, ref.times)
    np.testing.assert_array_equal(port.cursor, ref.cursor)
    np.testing.assert_array_equal(port._state["total"].numpy(),
                                  np.asarray(ref._state["total"]))
    assert port.epoch == ref.epoch
    assert port.stats() == ref.stats()


def _assert_same_reads(port, ref, now, i2i):
    for k in (4, 8):
        np.testing.assert_array_equal(port.retrieve_batch(PROBES, now, k),
                                      ref.retrieve_batch(PROBES, now, k))
    for n_recent, k in ((3, 5), (8, 16)):
        sp, up = port.serve_batch(PROBES, now, n_recent=n_recent, k=k,
                                  i2i=i2i)
        sr, ur = ref.serve_batch(PROBES, now, n_recent=n_recent, k=k,
                                 i2i=i2i)
        np.testing.assert_array_equal(sp, sr)
        np.testing.assert_array_equal(up, ur)
    assert port.retrieve(1, now, 8) == ref.retrieve(1, now, 8)


@pytest.mark.parametrize("seed", range(4))
def test_direct_mode_matches_jax_store_bitwise(seed):
    rng = np.random.default_rng(seed)
    flat = rng.integers(0, N_CLUSTERS, N_USERS).astype(np.int64)
    flat[3] = -1                           # a user another shard owns
    # queue_len 8 << events per cluster: every cluster wraps repeatedly
    port = ClusterQueueStore(flat, queue_len=8, recency_s=50.0,
                             device="cpu")
    ref = JaxStore(flat, queue_len=8, recency_s=50.0)
    i2i = rng.integers(-1, N_ITEMS + 2, (N_ITEMS - 2, 5))  # some seeds >= N
    _assert_same_reads(port, ref, 0.0, i2i)                # empty store
    for u, it, ts in _batches(rng, 7):
        port.ingest(u, it, ts)
        ref.ingest(u, it, ts)
        _assert_same_state(port, ref)
        t_end = float(ts[-1]) if ts.size else 70.0
        for now in (t_end, t_end + 25.0, t_end + 49.9, t_end + 200.0):
            _assert_same_reads(port, ref, now, i2i)


def test_serve_without_i2i_gives_empty_union():
    port = ClusterQueueStore(np.array([0, 1]), queue_len=4, device="cpu")
    port.ingest(np.array([0, 0, 1]), np.array([5, 6, 7]),
                np.array([1.0, 2.0, 3.0]))
    s, u = port.serve_batch(np.array([0, 1, 2]), 3.0, n_recent=2, k=3)
    assert s.tolist() == [[6, 5], [7, -1], [-1, -1]]
    assert (u == -1).all() and u.shape == (3, 3)


def test_ingest_builds_new_ring_tensors():
    """MVCC: a reader's snapshot is never written by a later ingest."""
    port = ClusterQueueStore(np.array([0, 1]), queue_len=4, device="cpu")
    port.ingest(np.array([0]), np.array([5]), np.array([1.0]))
    snap = port._state
    before = {k: v.clone() for k, v in snap.items()}
    port.ingest(np.array([0, 1, 0]), np.array([5, 6, 7]),
                np.array([2.0, 3.0, 4.0]))
    assert port._state is not snap
    for k, v in snap.items():
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("n,k,chunk", [(100, 8, 7), (100, 8, 2048),
                                       (2, 4, 2048), (9, 8, 3)])
def test_i2i_knn_matches_jax(n, k, chunk):
    """Distinct random embeddings: no two candidates of a row score the
    same, so top-k tie order cannot differ between the frameworks."""
    emb = np.random.default_rng(n + k).normal(size=(n, 16)).astype(np.float32)
    port = build_i2i_knn(torch.from_numpy(emb), k=k, chunk=chunk)
    assert port.dtype == torch.int64 and port.shape == (n, k)
    np.testing.assert_array_equal(port.numpy(), jax_i2i(emb, k=k))
    assert build_i2i_knn(torch.zeros((0, 16)), k=k).shape == (0, k)


def test_u2i2i_matches_jax():
    rng = np.random.default_rng(5)
    i2i = rng.integers(-1, 30, (25, 6))
    recent = rng.integers(-1, 32, (40, 5))     # -1 pads and seeds >= N
    for k in (1, 7, 40):
        np.testing.assert_array_equal(
            u2i2i_retrieve_batch(torch.from_numpy(i2i),
                                 torch.from_numpy(recent), k).numpy(),
            jax_u2i2i(i2i, recent, k))
