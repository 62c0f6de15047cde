"""Port ``queue_gather`` (plain version, the CPU path of ``ops``) against
the JAX package's oracle and its Pallas kernel in interpret mode,
bitwise, on the same rings.  Then the CUDA kernel's per-request
algorithm, written out in torch (``kernel_walk``: 32-age seed steps,
columns of 32 round-robin priorities, the request's hash and how lanes
place keys in it), against the plain version at the edge shapes
``chip_smoke.py`` holds the kernel at on the card, and the sizes and
multiplier the wrapper computes for the kernel."""
import numpy as np
import pytest
import torch

from repro.core.serving import ClusterQueueStore as JaxStore
from repro.kernels.queue_gather.ops import queue_gather as jax_queue_gather
from repro.kernels.queue_gather.ref import queue_gather_ref as jax_ref
from repro_torch.kernels.queue_gather import queue_gather as port_kernel
from repro_torch.kernels.queue_gather import queue_gather as QG
from repro_torch.kernels.queue_gather.ops import queue_gather
from repro_torch.kernels.queue_gather.ref import ring_window

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


# ---------------------------------------------------------------------------
# the CUDA kernel's per-request algorithm, written out in torch
# ---------------------------------------------------------------------------

LANES = 32
EMPTY = -1


def _slot(key, hbits):
    return ((key * 0x9E3779B1) & 0xFFFFFFFF) >> (32 - hbits)


class _Hash:
    """A warp's table of keys as the kernel keeps it: open addressing,
    linear probing from a multiplicative hash, keys placed at the free
    slot their lookup ended on, a tombstone (-2) where a key was taken
    back."""

    def __init__(self, hbits):
        self.hbits, self.H = hbits, 1 << hbits
        self.keys = [EMPTY] * self.H

    def lookup(self, key):
        """(held, the slot the probe ended on)."""
        h = _slot(key, self.hbits)
        for _ in range(self.H):
            if self.keys[h] == key:
                return True, h
            if self.keys[h] == EMPTY:
                return False, h
            h = (h + 1) % self.H
        raise AssertionError("hash full: a probe would not end")

    def place(self, puts):
        """``puts``: (key, slot) of a column's lanes with new keys, placed
        as the lanes do it: all write, a lane that does not read its key
        back probes on to the next free slot.  Returns each lane's final
        slot."""
        slots = [h for _, h in puts]
        todo = list(range(len(puts)))
        while todo:
            for m in todo:                         # the last writer wins
                self.keys[slots[m]] = puts[m][0]
            lost = [m for m in todo if self.keys[slots[m]] != puts[m][0]]
            for m in lost:
                while self.keys[slots[m]] != EMPTY:
                    slots[m] = (slots[m] + 1) % self.H
            todo = lost
        return slots


def _take(table, vals, held, n, cap, out, trim):
    """One column of lanes in priority order, as ``take_column``: the
    valid lanes (>= 0) that the table does not hold (looked up only if
    ``held``) place their keys; the lowest lane on each slot is kept
    (atomicMin of the lane); kept lanes take ballot prefix positions from
    ``n``, those below ``cap`` are written to ``out``, and with ``trim``
    the others are taken back out of the table.  Returns how many were
    kept."""
    lanes = [m for m in range(vals.shape[0]) if vals[m] >= 0]
    found = {m: table.lookup(int(vals[m])) if held
             else (False, _slot(int(vals[m]), table.hbits)) for m in lanes}
    lanes = [m for m in lanes if not found[m][0]]
    slots = table.place([(int(vals[m]), found[m][1]) for m in lanes])
    own = {}
    for m, h in zip(lanes, slots):
        own[h] = min(own.get(h, LANES), m)
    kept = [(m, h) for m, h in zip(lanes, slots) if own[h] == m]
    for i, (m, h) in enumerate(kept):
        if n + i < cap:
            out[n + i] = int(vals[m])
        elif trim:
            table.keys[h] = -2
    return len(kept)


def _ring_steps(items, times, c, fill, head, cut, G):
    """The ring newest-first, G ages a step, as the kernels load it."""
    Q = items.shape[1]
    for a0 in range(0, max(fill, 0), G):
        a = a0 + torch.arange(G)
        slot = head - a
        slot = torch.where(slot < 0, slot + Q, slot).clamp(0, Q - 1)
        it = torch.where(a < fill, items[c, slot], -1).long()
        yield torch.where(times[c, slot] >= cut, it, -1)


def kernel_walk(items, times, cursor, clusters, i2i, *, cutoff, n_recent,
                k):
    """``queue_gather.cu``, one request (warp) at a time: the ring head
    by the host's modulo multiplier, seeds 32 ages a step, the union 32
    consecutive round-robin priorities (r * ns + s) a column, two
    columns loaded a trip; a lane is kept if the request's hash does not
    hold its value and it is the lowest lane of its value in its step or
    column (the lanes of one value meet on one slot of the hash); kept
    lanes take ballot prefix positions, and a seed past the R-th is taken
    back out of the hash.  Lanes are torch vectors."""
    C, Q = items.shape
    N, K = i2i.shape
    B, R = clusters.shape[0], n_recent
    cut = torch.tensor(cutoff, dtype=torch.float32)
    seeds = torch.full((B, R), -7, dtype=torch.int64)
    union = torch.full((B, k), -7, dtype=torch.int64)
    hbits = QG.hash_bits(R, k)
    lane = torch.arange(LANES)
    mul, shift = QG.mod_magic(Q)
    for b in range(B):
        c = int(clusters[b])
        total = int(cursor[c]) if 0 <= c < C else 0
        fill = min(total, Q)
        head = 0
        if fill > 0 and Q > 1:
            head = total - 1 - Q * (((total - 1) * mul >> 32) >> shift)
        assert head == ((total - 1) % Q if fill > 0 else 0)
        table = _Hash(hbits)
        stage, ns = [-1] * R, 0
        for it in _ring_steps(items, times, c, fill, head, cut, LANES):
            ns = min(R, ns + _take(table, it, ns > 0, ns, R, stage, True))
            if ns >= R:
                break
        seeds[b] = torch.tensor([stage[m] if m < ns else -1
                                 for m in range(R)])
        out, nu = [-1] * k, 0
        sd = torch.tensor(stage[:ns] + [-1] * (LANES - ns))
        for p0 in range(0, ns * K, QG.COLS * LANES):
            cols = []
            for i in range(QG.COLS):               # every load, then use
                p = p0 + i * LANES + lane
                r, s = p // ns, p % ns
                seed = sd[s]
                ok = (r < K) & (seed < N)
                cols.append(torch.where(
                    ok, i2i[seed.clamp(0, N - 1), r.clamp(0, K - 1)],
                    -1).long())
            for vals in cols:
                if nu < k:
                    nu = min(k, nu + _take(table, vals, True, nu, k, out,
                                           False))
            if nu >= k:
                break
        union[b] = torch.tensor(out)
        assert all(x >= 0 for x in out[:nu])
        assert all(x == -1 for x in out[nu:])
        assert sum(key != EMPTY for key in table.keys) * 2 <= table.H
    return seeds, union


def _rings(seed, *, C=24, Q=64, N=300, K=16, B=64, dup=True, tomb=0.05,
           span=100.0, big=0):
    """Random rings (a third of them from a 12-item window, so copies
    abound), cursors part-filled and wrapped, some never written, an I2I
    table with -1 gaps, clusters with a few unknown ids; ``big`` is added
    to every id (ring items and I2I entries alike)."""
    rng = np.random.default_rng(seed)
    items = rng.integers(0, N + N // 20, (C, Q))
    if dup:
        narrow = rng.integers(0, N, (C, 1)) + rng.integers(0, 12, (C, Q))
        items = np.where(rng.random((C, 1)) < 1 / 3, narrow % N, items)
    items[rng.random((C, Q)) < tomb] = -1
    times = (rng.random((C, Q)) * span).astype(np.float32)
    cursor = rng.integers(0, 3 * Q, C)
    cursor[:2] = 0
    i2i = rng.integers(0, N, (N, K))
    i2i[rng.random(i2i.shape) < 0.1] = -1
    cl = rng.integers(0, C, B)
    cl[::17] = -1
    cl[5::23] = C + 3
    if big:
        items = np.where(items >= 0, items + big, -1)
        i2i = np.where(i2i >= 0, i2i + big, -1)
    return items, times, cursor, cl, i2i


# (name, _rings overrides, cutoff, R, k): the edge shapes chip_smoke.py
# holds the kernel at, cut to size
EDGE_CASES = [
    ("main R 8 k 32 K 16", {}, 50.0, 8, 32),
    ("every ring empty", {"empty": True}, 0.0, 8, 32),
    ("cutoff above every time", {}, 101.0, 8, 32),
    ("3% recency window", {"Q": 256}, 97.0, 8, 32),
    ("one repeated item", {"same": True}, 0.0, 8, 32),
    ("R 32 k 256 K 64", {"N": 4000, "K": 64, "Q": 128}, 20.0, 32, 256),
    ("K 15", {"K": 15}, 30.0, 8, 32),
    ("K 1", {"K": 1}, 30.0, 8, 32),
    ("R 1 k 1", {}, 50.0, 1, 1),
    ("unknown clusters", {"unknown": True}, 0.0, 8, 32),
    ("ids above 2^24", {"big": 1 << 24}, 50.0, 8, 32),
]


def _edge_inputs(name, over):
    over = dict(over)
    empty, same = over.pop("empty", False), over.pop("same", False)
    unknown = over.pop("unknown", False)
    items, times, cursor, cl, i2i = _rings(len(name), **over)
    if empty:
        cursor[:] = 0
    if same:
        items[:] = 7
    if unknown:
        cl = np.where(np.arange(cl.size) % 2, -1 - cl, cl + items.shape[0])
    return items, times, cursor, cl, i2i


@pytest.mark.parametrize("name,over,cutoff,R,k", EDGE_CASES,
                         ids=[e[0] for e in EDGE_CASES])
def test_kernel_walk_matches_the_plain_version_at_edges(name, over, cutoff,
                                                        R, k):
    items, times, cursor, cl, i2i = _edge_inputs(name, over)
    t = [torch.from_numpy(np.asarray(x)) for x in (items, times, cursor, cl,
                                                    i2i)]
    kw = dict(cutoff=cutoff, n_recent=R, k=k)
    s_p, u_p = _port(items, times, cursor, cl, i2i, **kw)
    known = (cl >= 0) & (cl < items.shape[0])      # the oracle takes these
    s_r, u_r = jax_ref(items, times, cursor, cl[known], i2i, **kw)
    np.testing.assert_array_equal(s_p[known], s_r)
    np.testing.assert_array_equal(u_p[known], u_r)
    assert (s_p[~known] == -1).all() and (u_p[~known] == -1).all()
    s_w, u_w = kernel_walk(*t, **kw)
    np.testing.assert_array_equal(s_w.numpy(), s_p)
    np.testing.assert_array_equal(u_w.numpy(), u_p)
    if name == "3% recency window":
        # some request took more than one 32-age step to find its seeds
        it, valid = ring_window(*t[:4], cutoff)
        first = valid.long().cumsum(dim=1) == 1
        assert bool((first.long().argmax(dim=1) >= 32).any())
    if name == "R 32 k 256 K 64":
        assert (u_p[:, -1] >= 0).any() and (s_p[:, -1] >= 0).any()


@pytest.mark.parametrize("Q", [2, 3, 8, 24, 255, 256, 257, 1000, 65_537,
                               (1 << 30) + 3, (1 << 31) - 1])
def test_mod_magic_divides_every_31_bit_count(Q):
    """The kernel takes the ring head (total - 1) mod Q as x - Q * (x *
    multiplier >> 32 >> shift); that quotient is x // Q for every cursor
    a ring can hold (0 <= x < 2^31), and the multiplier fits 32 bits."""
    mul, shift = QG.mod_magic(Q)
    assert 0 < mul < 1 << 32 and 0 <= shift < 31
    rng = np.random.default_rng(Q % 1000)
    xs = np.r_[0, 1, Q - 1, Q, Q + 1, 2 * Q - 1, (1 << 31) - 1,
               rng.integers(0, 1 << 31, 2000)]
    xs = [int(x) for x in xs if 0 <= x < 1 << 31]
    assert [((x * mul) >> 32) >> shift for x in xs] == [x // Q for x in xs]


def test_mod_magic_leaves_q_1_to_the_kernel():
    assert QG.mod_magic(1) == (0, 0)


@pytest.mark.parametrize("R,k,H", [(1, 1, 256), (8, 32, 256),
                                   (8, 56, 256), (8, 57, 512),
                                   (32, 256, 1024)])
def test_hash_stays_half_empty_and_blocks_fit(R, k, H):
    """The seed steps' R - 1 keys before the last step and 32 in it, and
    the union's k - 1 before its last column and 32 in it, fill at most
    half of a request's hash; a block stays under the 48 KB a launch gets
    without asking, and at the main path's R and k the 16 blocks an SM
    can hold fit its 227 KB."""
    assert 1 << QG.hash_bits(R, k) == H
    assert 2 * ((R - 1 + 32) + (k - 1 + 32)) <= H
    words = 2 * H + -(-R // 4) * 4
    assert QG.smem_bytes(R, k) == QG.WARPS * words * 4
    assert QG.smem_bytes(R, k) <= 48 * 1024
    assert 16 * QG.smem_bytes(8, 32) <= 232_448
    assert 16 * QG.WARPS == QG.SM_WARPS


@pytest.mark.parametrize("B,sms,rpw", [
    (1, 132, 1), (512, 132, 1), (4096, 132, 1), (33_791, 132, 1),
    (33_792, 132, 2), (65_536, 132, 2), (135_167, 132, 2),
    (135_168, 132, 4), (262_144, 132, 4), (262_144, 114, 4),
    (1 << 20, 1, 4), (65_535, 256, 1)])
def test_launch_plan_takes_more_requests_a_warp_at_large_batches(B, sms,
                                                                 rpw):
    """A warp serves 1 request below 4 waves of the card's warps (SM
    count x 64), 2 below 16 waves, else 4; the blocks cover the batch
    and no block is empty."""
    got, blocks = QG.launch_plan(B, sms)
    assert got == rpw
    per_block = QG.WARPS * rpw
    assert (blocks - 1) * per_block < B <= blocks * per_block
