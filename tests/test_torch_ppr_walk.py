"""``ppr_walk`` at its edge shapes, and the layout the CUDA kernel walks.

The plain version (the CPU path of ``ops``) against the JAX oracle and
the JAX Pallas kernel in interpret mode, bitwise, on a dangling start,
``restart`` 1.0, one walker of one step and widths that are not a
multiple of the kernel's 8-column block.  Then ``walk_layout`` against
the rows and ``last_valid_cols`` it is built from, and the kernel's
two-level lookup over it (written out here in torch, as the kernel does
it) against the plain walk, on rows with flat stretches, rows that top
out below 1 and draws equal to cum values.  The kernel itself runs only
on the card, where ``chip_smoke.py`` holds it against the plain version
at these shapes."""
import numpy as np
import pytest
import torch

from repro.core import ppr as JP
from repro.kernels.ppr_walk.ppr_walk import ppr_walk as jax_pallas_walk
from repro.kernels.ppr_walk.ref import ppr_walk_ref as jax_walk_ref
from repro_torch.kernels.ppr_walk import ppr_walk as PW
from repro_torch.kernels.ppr_walk.ops import ppr_walk
from repro_torch.kernels.ppr_walk.ref import last_valid_cols, ppr_walk_ref

torch.set_num_threads(2)


def _adj(N, D2, seed, *, steps=0):
    """Random padded adjacency: a tenth of the rows dangling (the first
    ones), -1 tails, zero-mass columns inside rows, a third of the rows
    scaled so their f32 cum tops out below 1.  ``steps`` > 0 puts every
    cum value on the grid k / steps instead (long flat stretches, rows
    topping out anywhere), so draws on that grid land exactly on them."""
    rng = np.random.default_rng(seed)
    nbrs = rng.integers(0, N, (N, D2)).astype(np.int64)
    deg = rng.integers(1, D2 + 1, N)
    deg[: max(1, N // 10)] = 0                     # dangling
    mask = np.arange(D2)[None, :] < deg[:, None]
    nbrs = np.where(mask, nbrs, -1)
    if steps:
        q = np.where(mask, np.sort(rng.integers(0, steps + 1, (N, D2)), 1), 0)
        return nbrs, (np.maximum.accumulate(q, 1) / steps).astype(np.float32)
    keep = mask & (rng.random((N, D2)) < 0.8)
    probs = np.where(keep, rng.random((N, D2)), 0.0)
    tot = probs.sum(1, keepdims=True)
    probs = np.where(tot > 0, probs / np.maximum(tot, 1e-12), 0.0)
    short = rng.random(N) < 1 / 3
    probs[short] *= 0.97
    return nbrs, np.cumsum(probs, 1).astype(np.float32)


# (name, N, D2, starts, W, L, restart, dangling starts)
EDGES = [
    ("dangling start", 40, 16, 6, 8, 4, 0.15, True),
    ("restart 1.0", 40, 16, 6, 8, 4, 1.0, False),
    ("W 1 L 1", 40, 16, 9, 1, 1, 0.15, False),
    ("D2 13", 60, 13, 8, 6, 5, 0.15, False),
    ("D2 3", 30, 3, 8, 4, 3, 0.0, False),
]


@pytest.mark.parametrize("name,N,D2,n,W,L,restart,dangling", EDGES,
                         ids=[e[0] for e in EDGES])
def test_plain_matches_jax_oracle_and_pallas_at_edges(name, N, D2, n, W, L,
                                                      restart, dangling):
    nbrs, cum = _adj(N, D2, N + D2)
    rng = np.random.default_rng(n)
    hi = max(1, N // 10) if dangling else N        # rows [0, N/10) dangle
    starts = rng.integers(0, hi, n).astype(np.int64)
    u = JP.walk_uniforms(5, starts, W, L)
    vp, cp = ppr_walk(torch.from_numpy(nbrs), torch.from_numpy(cum),
                      torch.from_numpy(starts), torch.from_numpy(u),
                      restart=restart)
    vr, cr = jax_walk_ref(nbrs, cum, starts, u, restart=restart)
    np.testing.assert_array_equal(vp.numpy(), vr)
    np.testing.assert_array_equal(cp.numpy(), cr)
    vk, ck = jax_pallas_walk(nbrs, cum, starts, u, restart=restart,
                             interpret=True)
    np.testing.assert_array_equal(vp.numpy(), np.asarray(vk))
    np.testing.assert_array_equal(cp.numpy(), np.asarray(ck))
    assert (cp.numpy().sum(axis=1) == W * L).all()
    if dangling or restart >= 1.0:
        # every step stays home: one id carries the whole count
        assert (vp.numpy() == starts[:, None]).all()
        assert (cp.numpy()[:, 0] == W * L).all()


@pytest.mark.parametrize("D2", [1, 5, 8, 13, 64, 100])
def test_walk_layout_holds_the_rows(D2):
    nbrs, cum = _adj(50, D2, D2)
    nb, cm = torch.from_numpy(nbrs), torch.from_numpy(cum)
    last = last_valid_cols(cm)
    summ, pack = PW.walk_layout(nb, cm, last, rows=16)
    G = -(-D2 // 8)
    assert summ.shape == (50, 8 * -(-G // 8)) and summ.dtype == torch.float32
    assert pack.shape == (50, G + 1, 16) and pack.dtype == torch.int32
    tops = np.minimum(np.arange(G) * 8 + 7, D2 - 1)
    np.testing.assert_array_equal(summ[:, :G].numpy(), cum[:, tops])
    assert torch.isinf(summ[:, G:]).all()
    cums = pack[:, :G, :8].contiguous().view(torch.float32).reshape(50, -1)
    ids = pack[:, :G, 8:].reshape(50, -1)
    np.testing.assert_array_equal(cums[:, :D2].numpy(), cum)
    assert torch.isinf(cums[:, D2:]).all() and (ids[:, D2:] == -1).all()
    dang = cum[:, -1] <= 0
    assert dang.any() and (~dang).any()
    np.testing.assert_array_equal(ids[:, :D2].numpy(),
                                  np.where(dang[:, None], -1, nbrs))
    over = pack[:, G]
    assert torch.isinf(over[:, :8].contiguous().view(torch.float32)).all()
    rows = np.arange(50)
    want = np.where(dang, -1, nbrs[rows, JP.last_valid_cols(cum)])
    np.testing.assert_array_equal(over[:, 8].numpy(), want)
    assert (over[:, 9:] == -1).all()


def layout_walk(layout, starts, uniforms, restart):
    """The kernel's step over ``walk_layout`` in torch: count the summary
    entries below the draw (nb), then the entries of block nb below it
    (k), take id k of block nb, keep the walker on a -1 id, go home on a
    restart draw.  Returns the walker-major trace."""
    summ, pack = layout
    n, W, two_l = uniforms.shape
    home = starts.to(torch.int64).repeat_interleave(W)
    u = uniforms.reshape(n * W, two_l)
    cums = pack[..., :8].contiguous().view(torch.float32)
    ids = pack[..., 8:]
    r32 = torch.tensor(restart, dtype=torch.float32)
    pos, trace = home, []
    for t in range(two_l // 2):
        us = u[:, 2 * t, None]
        nb = (summ[pos] < us).sum(dim=1)
        k = (cums[pos, nb] < us).sum(dim=1)
        assert int(k.max()) < 8
        nxt = ids[pos, nb, k].to(torch.int64)
        nxt = torch.where(nxt >= 0, nxt, pos)
        pos = torch.where(u[:, 2 * t + 1] < r32, home, nxt)
        trace.append(pos)
    return torch.stack(trace, dim=1).reshape(n, -1).to(torch.int32)


@pytest.mark.parametrize("D2,steps,restart", [
    (64, 0, 0.15), (64, 16, 0.15), (13, 8, 0.15), (100, 0, 0.15),
    (8, 4, 0.0), (1, 0, 0.15), (64, 0, 1.0),
])
def test_kernel_lookup_over_the_layout_equals_the_plain_walk(D2, steps,
                                                            restart):
    N, n, W, L = 300, 64, 16, 5
    nbrs, cum = _adj(N, D2, 7 * D2 + steps, steps=steps)
    rng = np.random.default_rng(D2)
    starts = torch.from_numpy(rng.integers(0, N, n))
    u = rng.random((n, W, 2 * L), dtype=np.float32)
    if steps:
        # step draws on the cum grid: ties, and draws past the row's top
        grid = rng.integers(0, steps, (n, W, L)) / steps
        u[:, :, 0::2] = grid.astype(np.float32)
    u = torch.from_numpy(u)
    nb, cm = torch.from_numpy(nbrs), torch.from_numpy(cum)
    want, _ = ppr_walk_ref(nb, cm, starts, u, restart=restart)
    got = layout_walk(PW.walk_layout(nb, cm), starts, u, restart)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("S", [1, 2, 320, 4096, PW.MAX_TRACE])
def test_hash_fits_the_trace_and_the_card(S):
    """The shared-memory hash has more slots than the trace has ids (so
    an insert always finds a free slot), and the largest trace's block
    fits the 227 KB a Hopper block may opt into."""
    H = 1 << max(1, S.bit_length())
    assert H > S and H <= 2 * S + 1
    assert PW.smem_bytes(S) == 8 * H + 4 * -(-S // 2)
    assert PW.smem_bytes(S) <= 232_448


def test_kernel_wrapper_refuses_cpu_tensors():
    nbrs, cum = _adj(20, 8, 0)
    layout = PW.walk_layout(torch.from_numpy(nbrs), torch.from_numpy(cum))
    with pytest.raises(ValueError, match="CUDA"):
        PW.ppr_walk(layout, torch.zeros(2, dtype=torch.int32),
                    torch.zeros((2, 4, 6)), restart=0.15)
