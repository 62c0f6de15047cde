"""Port ``queue_gather`` (plain version, the CPU path of ``ops``) against
the JAX package's oracle and its Pallas kernel in interpret mode,
bitwise, on the same rings."""
import numpy as np
import pytest
import torch

from repro.core.serving import ClusterQueueStore as JaxStore
from repro.kernels.queue_gather.ops import queue_gather as jax_queue_gather
from repro.kernels.queue_gather.ref import queue_gather_ref as jax_ref
from repro_torch.kernels.queue_gather import queue_gather as port_kernel
from repro_torch.kernels.queue_gather.ops import queue_gather

torch.set_num_threads(2)


def _port(items, times, cursor, cl, i2i, **kw):
    s, u = queue_gather(torch.tensor(np.asarray(items, np.int32)),
                        torch.tensor(np.asarray(times, np.float32)),
                        torch.tensor(np.asarray(cursor, np.int64)),
                        torch.tensor(np.asarray(cl, np.int64)),
                        torch.tensor(np.asarray(i2i, np.int64)), **kw)
    assert s.dtype == torch.int32 and u.dtype == torch.int32
    return s.numpy().astype(np.int64), u.numpy().astype(np.int64)


@pytest.mark.parametrize("seed,Q,R,k", [(0, 16, 4, 8), (1, 32, 8, 24),
                                        (2, 8, 3, 40), (3, 64, 1, 4)])
def test_plain_matches_jax_oracle_and_pallas_on_store_rings(seed, Q, R, k):
    rng = np.random.default_rng(seed)
    C, n_users, n_items = 12, 150, 250
    store = JaxStore(rng.integers(0, C, n_users), queue_len=Q,
                     recency_s=float(rng.integers(100, 1500)))
    for _ in range(2):
        n_ev = int(rng.integers(50, 3000))
        store.ingest(rng.integers(0, n_users, n_ev),
                     rng.integers(0, n_items, n_ev),
                     rng.integers(0, 1000, n_ev).astype(float))
    i2i = rng.integers(-1, n_items, (n_items, int(rng.integers(2, 10))))
    cl = store.user_clusters[rng.integers(0, n_users, 48)]
    # the kernels compare in f32: give the f64 oracle the same cutoff
    cutoff = float(np.float32(store.rel_cutoff(1000.0)))
    kw = dict(cutoff=cutoff, n_recent=R, k=k)
    args = (store.items, store.times, store.cursor, cl, i2i)
    s_r, u_r = jax_ref(*args, **kw)
    s_k, u_k = jax_queue_gather(*args, **kw)
    s_p, u_p = _port(*args, **kw)
    np.testing.assert_array_equal(s_p, s_r)
    np.testing.assert_array_equal(u_p, u_r)
    np.testing.assert_array_equal(s_p, np.asarray(s_k))
    np.testing.assert_array_equal(u_p, np.asarray(u_k))


@pytest.mark.parametrize("seed", range(4))
def test_plain_matches_jax_oracle_on_raw_rings(seed):
    """Rings a store never writes: duplicate items at several ages,
    tombstones, part-filled and wrapped cursors, seeds past the I2I
    table end, and I2I ids above 2^24 (no id cap off the TPU)."""
    rng = np.random.default_rng(100 + seed)
    C, Q, n_items, K = 9, 24, 40, 6
    base = 1 << 24 if seed % 2 else 0
    items = rng.integers(0, n_items + 5, (C, Q))          # dup-heavy
    items[rng.random((C, Q)) < 0.1] = -1
    times = rng.integers(0, 100, (C, Q)).astype(np.float32)
    cursor = rng.integers(0, 3 * Q, C)
    cursor[0] = 0                                         # never written
    i2i = base + rng.integers(0, n_items, (n_items, K))
    i2i[rng.random(i2i.shape) < 0.1] = -1
    cl = rng.integers(0, C, 64)
    kw = dict(cutoff=float(rng.integers(0, 60)), n_recent=int(
        rng.integers(1, 9)), k=int(rng.integers(1, 30)))
    s_r, u_r = jax_ref(items, times, cursor, cl, i2i, **kw)
    s_p, u_p = _port(items, times, cursor, cl, i2i, **kw)
    np.testing.assert_array_equal(s_p, s_r)
    np.testing.assert_array_equal(u_p, u_r)


def test_out_of_range_cluster_gives_empty_rows():
    items = np.arange(8, dtype=np.int32).reshape(2, 4)
    times = np.zeros((2, 4), np.float32)
    cursor = np.array([4, 4])
    i2i = np.zeros((8, 2), np.int64)
    s, u = _port(items, times, cursor, np.array([-1, 2, 1]), i2i,
                 cutoff=0.0, n_recent=3, k=2)
    assert (s[:2] == -1).all() and (u[:2] == -1).all()
    assert s[2].tolist() == [7, 6, 5] and u[2].tolist() == [0, -1]


def test_kernel_wrapper_takes_only_cuda_tensors():
    z = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        port_kernel.queue_gather(z, z.float(), z[0, :2], z[0, :1], z,
                                 cutoff=0.0, n_recent=2, k=2)
