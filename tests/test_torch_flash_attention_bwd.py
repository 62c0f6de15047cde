"""The flash-attention backward's plain versions and its kernels'
arithmetic, on the CPU (the kernels themselves, ``csrc/flash_attention_bwd.cu``,
run only on the card: ``chip_smoke.py`` Phase 1 holds them there).

  * ``attention_bwd_ref`` (the closed form) and the plain lse
    (``chunked_attention_ref(..., return_lse=True)``) against autograd of
    ``chunked_attention_ref`` and against ``jax.vjp`` of the JAX package's
    ``_chunked_attention`` on the same numpy inputs, f32 and bf16, head
    dims 32, 128 and 256, GQA and MQA, S not a multiple of any tile,
    ``block_q`` 32 and 1024.
  * A write-out in torch of the kernels' tiling and summation order (the
    dq pass over 64-row tiles and 64-key tiles, with Di from the output in
    its own type; the dkdv pass over 64-key tiles and 64-row tiles of the
    flattened (position, head-in-group) rows, position-major, from the
    first row tile that sees the key tile, cut into ``bwd_plan``'s
    ranges, each range's f32 partial added in split order from 0; P and
    dS rounded once to bf16 as wgmma operands; f32 sums tile by tile; the
    f32 kernels' 16 x 16 tiles with no rounding) held against the closed
    form, at the planned splits and at forced ones.
  * ``bwd_plan``: gemma-2b's MQA fills 132 SMs, and every plan's ranges
    cover each key tile's row tiles once, in order, none empty; its
    table (``bwd_table``) lists the longest ranges first.
  * ``common.library_path`` follows the headers a source includes
    (``csrc/hopper.cuh``, shared by the forward and the backward).
  * The F1 guard through ``check_train_case``, which decides it, the
    training route's plan, and the forward's lse units.

Tolerances, against M = ``attention_bwd_ref(..., absolute=True)``, the
sum of the magnitudes of each result's terms (|P| |dO| |V| and the like):
an error of relative size e in any factor moves a result by at most e M.
  * bf16: 2^-6 M.  A rounding to bf16 moves a value by at most 2^-8 of
    it.  The kernels round P and dS once each as mma operands, take Di
    from the bf16 output (within 2^-8 of |dO|.|O|, a term of M), and
    round each gradient to bf16; the reference rounds its own once: four
    roundings, 4 x 2^-8 = 2^-6 only if every one hits its largest error
    with one sign on every term.  f32 accumulation adds about 2^-24 a
    term.
  * f32: 1e-5 M.  The same sums in another order (the JAX and torch
    references, or tiles), about sqrt(n) 2^-24 of M for n terms: 4e-6 at
    n = 4,096 with random signs; exp as expf (a few ulp).
M grows with a row's length while an entry grows with its square root,
so a tile lost from a long row can hide under the bound above; the
norm-wise gap over each block of 64 positions of a head
(``ref.py::block_gap``) sees it.  Its limits: bf16 2^-6 (the sound
write-out reads about 2^-8.7, P, dS and the result rounded once each
with random signs; a lost tile of S / 64 reads about sqrt(64 / S), 2^-5
at gemma's 512 row tiles of 64), f32 2^-13 (sound about sqrt(n)
2^-24).
The Di source alone (the bf16 output against the f32 one) is held to
its own bound, 2^-8 M, on the write-out's dQ (seen here: at most 1.2e-3
M, and the whole bf16 write-out at most 5.9e-3 M, dV's), so the kernels
keep Di = rowsum(dO * O) and need no extra pass for sum(P * dP).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.sharding import NULL_CTX
from repro.models.lm.model import _chunked_attention as jax_chunked
from repro_torch.kernels.flash_attention import flash_attention as K
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     block_gap,
                                                     chunked_attention_ref)

torch.set_num_threads(2)

BF16_TOL = 2.0 ** -6         # of M (module docstring)
F32_TOL = 1e-5
DI_SOURCE_TOL = 2.0 ** -8    # what Di from the bf16 output may move
# block_gap's limits (module docstring), as chip_smoke.py's BWD_GAP_TOL
GAP_TOL = {torch.bfloat16: 2.0 ** -6, torch.float32: 2.0 ** -13}
LOG2E = 1.4426950408889634

CASES = [
    # (B, S, Hq, Hkv, D): S a multiple of no tile
    (2, 77, 4, 4, 32),       # run_lm's reduced head dim, no grouping
    (1, 150, 6, 2, 128),     # GQA 3:1, llama's head dim
    (1, 130, 8, 1, 256),     # MQA 8:1, gemma's head dim
]


def _inputs(B, S, Hq, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    do = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    return q, k, v, do


def within(got, want, mag, tol) -> float:
    """The largest |got - want| / M (1e-30 where M is 0); asserts it is
    at most ``tol``."""
    err = ((got.float() - want.float()).abs()
           / torch.clamp_min(mag, 1e-30)).max().item()
    assert err <= tol, err
    return err


def _torch(a, dtype):
    return torch.from_numpy(a).to(dtype)


def _jax_vjp(q, k, v, do, *, dtype, block_q, scale):
    jt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    args = [jnp.asarray(a, jt) for a in (q, k, v)]
    fwd = lambda q_, k_, v_: jax_chunked(  # noqa: E731
        q_, k_, v_, causal=True, q_offset=0, kv_len=None, block_q=block_q,
        scale=scale, ctx=NULL_CTX)
    out, vjp = jax.vjp(fwd, *args)
    return [torch.from_numpy(np.array(g.astype(jnp.float32)))
            for g in vjp(jnp.asarray(do, jt))]


def _jax_lse(q, k, scale):
    """logsumexp of the causal scaled scores, (B, Hq, S), in JAX."""
    rep = q.shape[2] // k.shape[2]
    s = jnp.einsum("bqhd,bthd->bhqt", q, jnp.repeat(k, rep, axis=2)) * scale
    S = q.shape[1]
    s = jnp.where(jnp.tril(jnp.ones((S, S), bool)), s, -1e30)
    return torch.from_numpy(np.array(jax.nn.logsumexp(s, axis=-1)))


@pytest.mark.parametrize("block_q", [32, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Hq,Hkv,D", CASES)
def test_closed_form_matches_autograd_and_jax(B, S, Hq, Hkv, D, dtype,
                                             block_q):
    q, k, v, do = _inputs(B, S, Hq, Hkv, D, seed=S + D)
    scale = D ** -0.5
    tq, tk, tv = (_torch(a, dtype).requires_grad_() for a in (q, k, v))
    tdo = _torch(do, dtype)
    out, lse = chunked_attention_ref(tq, tk, tv, causal=True, scale=scale,
                                     block_q=block_q, return_lse=True)
    out.backward(tdo)
    assert lse.shape == (B, Hq, S) and lse.dtype == torch.float32
    want_lse = _jax_lse(q.astype(np.float32) if dtype == torch.float32 else
                        tq.detach().float().numpy(),
                        tk.detach().float().numpy(), scale)
    np.testing.assert_allclose(lse.detach().numpy(), want_lse.numpy(),
                               rtol=1e-6, atol=1e-5)
    args = (tq.detach(), tk.detach(), tv.detach(), out.detach(), tdo,
            lse.detach())
    got = attention_bwd_ref(*args, scale=scale)
    mag = attention_bwd_ref(*args, scale=scale, absolute=True)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    jax_grads = _jax_vjp(q, k, v, do, dtype=dtype, block_q=block_q,
                         scale=scale)
    for g, t, j, m in zip(got, (tq, tk, tv), jax_grads, mag):
        assert g.dtype == torch.float32 and g.shape == t.shape
        within(g, t.grad, m, tol)
        within(g, j, m, tol)


def _rows(t, rep):
    """(B, S, Hq, X) -> (B, Hkv, S * rep, X), rows position-major."""
    B, S, Hq = t.shape[:3]
    return t.reshape(B, S, Hq // rep, rep, -1).permute(0, 2, 1, 3, 4).reshape(
        B, Hq // rep, S * rep, -1)


def _unrows(t, S, rep):
    B, Hkv, rows, D = t.shape
    return t.view(B, Hkv, S, rep, D).permute(0, 2, 1, 3, 4).reshape(
        B, S, Hkv * rep, D)


def kernel_writeout(q, k, v, o, do, lse, *, scale, bf16, drop=None,
                    plan=None):
    """dQ, dK, dV (f32 before the output's rounding) by the kernels'
    tiling and order (module docstring); q, k, v, o, do in their own
    type, lse (B, Hq, S) f32.  ``plan``: the bf16 dkdv pass's
    (``K.bwd_plan`` at 132 SMs when None).  ``drop`` plants a lost tile:
    "dq" skips key tile 0 in the dq pass's last row tile, "dkdv" skips the
    dkdv pass's last row tile in key tile 0, "split" loses key tile 0's
    last split (its whole partial) from the fold."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    rep = Hq // Hkv
    rows = S * rep
    rnd = (lambda t: t.to(torch.bfloat16).float()) if bf16 else (lambda t: t)
    Q, O, dO = (_rows(t.float(), rep) for t in (q, o, do))
    Kt, Vt = (t.float().permute(0, 2, 1, 3) for t in (k, v))
    L = _rows(lse.permute(0, 2, 1)[..., None], rep)[..., 0]   # (B, Hkv, rows)
    pos = torch.arange(rows) // rep
    if bf16:
        bm_q = bn_q = bn_k = bm_k = 64
        plan = plan or K.bwd_plan(B, S, Hq, Hkv, D, 132)
        ranges = plan.ranges
        p_of = lambda s, lse_: torch.exp2(  # noqa: E731
            s * (scale * LOG2E) - lse_ * LOG2E)
    else:
        bm_q = bn_q = bn_k = bm_k = 16
        ranges = [[(j0 * rep // bm_k, -(-rows // bm_k))]
                  for j0 in range(0, S, bn_k)]
        p_of = lambda s, lse_: torch.exp(s * scale - lse_)  # noqa: E731
    di = (dO * O).sum(-1)                                    # (B, Hkv, rows)
    dq = torch.zeros_like(Q)
    for r0 in range(0, rows, bm_q):
        r = torch.arange(r0, min(r0 + bm_q, rows))
        for j0 in range(0, int(pos[r[-1]]) + 1, bn_q):
            if drop == "dq" and j0 == 0 and r0 + bm_q >= rows:
                continue
            j = torch.arange(j0, min(j0 + bn_q, S))
            keep = j[None, :] <= pos[r][:, None]
            s = Q[:, :, r] @ Kt[:, :, j].transpose(-1, -2)
            p = torch.where(keep, p_of(s, L[:, :, r, None]), 0.0)
            dp = dO[:, :, r] @ Vt[:, :, j].transpose(-1, -2)
            dq[:, :, r] += rnd(p * (dp - di[:, :, r, None])) @ Kt[:, :, j]
    dk, dv = torch.zeros_like(Kt), torch.zeros_like(Vt)
    for t, j0 in enumerate(range(0, S, bn_k)):
        j = torch.arange(j0, min(j0 + bn_k, S))
        assert ranges[t][0][0] == j0 * rep // bm_k
        for i, (lo, hi) in enumerate(ranges[t]):
            if drop == "split" and t == 0 and i == len(ranges[t]) - 1:
                continue
            pk = torch.zeros_like(dk[:, :, j])
            pv = torch.zeros_like(dv[:, :, j])
            for r0 in range(lo * bm_k, hi * bm_k, bm_k):
                if drop == "dkdv" and t == 0 and r0 + bm_k >= rows:
                    continue
                r = torch.arange(r0, min(r0 + bm_k, rows))
                keep = j[:, None] <= pos[r][None, :]
                sT = Kt[:, :, j] @ Q[:, :, r].transpose(-1, -2)
                pT = torch.where(keep, p_of(sT, L[:, :, None, r]), 0.0)
                pv += rnd(pT) @ dO[:, :, r]
                dpT = Vt[:, :, j] @ dO[:, :, r].transpose(-1, -2)
                pk += rnd(pT * (dpT - di[:, :, None, r])) @ Q[:, :, r]
            dk[:, :, j] += pk          # the fold: split order, from 0
            dv[:, :, j] += pv
    return (_unrows(dq, S, rep) * scale, dk.permute(0, 2, 1, 3) * scale,
            dv.permute(0, 2, 1, 3))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Hq,Hkv,D", CASES)
def test_kernel_writeout_within_bound(B, S, Hq, Hkv, D, dtype):
    q, k, v, do = _inputs(B, S, Hq, Hkv, D, seed=7 * S + D)
    scale = D ** -0.5
    tq, tk, tv, tdo = (_torch(a, dtype) for a in (q, k, v, do))
    # the reference's VJP runs on its f32 output; the kernels get it in
    # the working type, as the forward wrote it
    o32, lse = chunked_attention_ref(tq.float(), tk.float(), tv.float(),
                                     causal=True, scale=scale,
                                     return_lse=True)
    o = o32.to(dtype)
    want = attention_bwd_ref(tq, tk, tv, o32, tdo, lse, scale=scale)
    mag = attention_bwd_ref(tq, tk, tv, o32, tdo, lse, scale=scale,
                            absolute=True)
    bf16 = dtype == torch.bfloat16
    got = kernel_writeout(tq, tk, tv, o, tdo, lse, scale=scale, bf16=bf16)
    tol = BF16_TOL if bf16 else F32_TOL
    for g, w, m in zip(got, want, mag):
        within(g.to(dtype), w, m, tol)
    if bf16:   # the Di source alone: the bf16 output against the f32 one
        via_f32 = kernel_writeout(tq, tk, tv, o32, tdo, lse, scale=scale,
                                  bf16=True)
        within(got[0], via_f32[0], mag[0], DI_SOURCE_TOL)


@pytest.mark.parametrize("drop", [None, "dq", "dkdv"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_gap_sees_a_lost_tile_of_a_long_row(dtype, drop):
    """``block_gap`` (chip_smoke.py's norm-wise check, limits
    ``GAP_TOL``) holds the sound write-out and sees a lost tile that M
    dilutes: on dO weighted by position (every row's share of a key's
    sums about 1/S, as chip_smoke.py weights it), a key tile missing from
    the dq pass's last row tile or the last 64-row tile missing from key
    tile 0's dkdv sums reads above the limit."""
    B, S, Hq, Hkv, D = 1, 1024, 2, 1, 128
    q, k, v, do = (_torch(a, dtype) for a in
                   _inputs(B, S, Hq, Hkv, D, seed=11))
    do = (do.float() * (torch.arange(1, S + 1) / S)[None, :, None, None]
          ).to(dtype)
    scale = D ** -0.5
    o, lse = chunked_attention_ref(q, k, v, causal=True, scale=scale,
                                   return_lse=True)
    want = attention_bwd_ref(q, k, v, o, do, lse, scale=scale)
    got = kernel_writeout(q, k, v, o, do, lse, scale=scale,
                          bf16=dtype == torch.bfloat16, drop=drop)
    gaps = [block_gap(g.to(dtype), w) for g, w in zip(got, want)]
    lost = {None: (), "dq": (0,), "dkdv": (1, 2)}[drop]
    for i, gap in enumerate(gaps):
        assert (gap > GAP_TOL[dtype]) == (i in lost), gaps


def test_block_gap_sees_a_lost_split_partial():
    """The dkdv fold: a split's whole partial lost from key tile 0 (its
    last range of row tiles; ``bwd_plan`` cuts key tile 0 of this shape
    into 8) reads above the limit in dK and dV, and nowhere else."""
    B, S, Hq, Hkv, D = 1, 1024, 2, 1, 128
    dtype = torch.bfloat16
    plan = K.bwd_plan(B, S, Hq, Hkv, D, 132)
    assert len(plan.ranges[0]) > 1
    q, k, v, do = (_torch(a, dtype) for a in
                   _inputs(B, S, Hq, Hkv, D, seed=11))
    do = (do.float() * (torch.arange(1, S + 1) / S)[None, :, None, None]
          ).to(dtype)
    scale = D ** -0.5
    o, lse = chunked_attention_ref(q, k, v, causal=True, scale=scale,
                                   return_lse=True)
    want = attention_bwd_ref(q, k, v, o, do, lse, scale=scale)
    got = kernel_writeout(q, k, v, o, do, lse, scale=scale, bf16=True,
                          drop="split", plan=plan)
    gaps = [block_gap(g.to(dtype), w) for g, w in zip(got, want)]
    assert gaps[0] <= GAP_TOL[dtype] < min(gaps[1:]), gaps


# (B, S, Hq, Hkv, D): the main path's three shapes, the ragged ones of
# chip_smoke.py, and small cuts of each grouping
PLAN_SHAPES = [(1, 4096, 16, 16, 128), (1, 4096, 24, 8, 128),
               (1, 4096, 8, 1, 256), (2, 77, 6, 2, 64), (3, 100, 4, 1, 32),
               (1, 70, 8, 1, 256), (1, 128, 8, 1, 256), (4, 64, 4, 4, 32),
               (1, 1, 2, 1, 64), (2, 1000, 12, 4, 128)]


def test_bwd_plan_fills_the_card_at_gemma():
    """gemma-2b's MQA (one KV head: 64 key tiles at S 4,096) gets at
    least two blocks an SM of 132, none longer than half an SM's share of
    the row tiles; olmo-1b and llama3.2-3b already have 1,024 and 512
    blocks, none longer than an SM's share, and keep one split."""
    n_sm = 132
    for (B, S, Hq, Hkv, D), want_split in (
            ((1, 4096, 8, 1, 256), True), ((1, 4096, 16, 16, 128), False),
            ((1, 4096, 24, 8, 128), False)):
        plan = K.bwd_plan(B, S, Hq, Hkv, D, n_sm)
        lengths = [hi - lo for r in plan.ranges for lo, hi in r]
        share = B * Hkv * sum(lengths) / n_sm
        assert plan.blocks * B * Hkv >= (2 * n_sm if want_split else n_sm)
        assert (plan.splits > 1) == want_split
        assert max(lengths) <= (share / 2 if want_split else share)
    gemma = K.bwd_plan(1, 4096, 8, 1, 256, n_sm)
    assert [len(r) for r in gemma.ranges][:2] == [9, 8]
    assert len(gemma.ranges[-1]) == 1


@pytest.mark.parametrize("splits", [None, 1, 4, 100])
@pytest.mark.parametrize("n_sm", [1, 132])
@pytest.mark.parametrize("B,S,Hq,Hkv,D", PLAN_SHAPES)
def test_bwd_plan_ranges_cover_each_key_tile_once(B, S, Hq, Hkv, D, n_sm,
                                                 splits):
    """Each key tile's ranges start at the first row tile that sees it,
    follow each other with no gap, end at the last row tile, and none is
    empty; the table lists every range once, the longest first, and
    gives each split key tile its own run of workspace slots."""
    plan = K.bwd_plan(B, S, Hq, Hkv, D, n_sm, splits=splits)
    rep = Hq // Hkv
    n_rt = -(-S * rep // plan.row_tile)
    assert len(plan.ranges) == -(-S // plan.key_tile)
    for t, r in enumerate(plan.ranges):
        assert r[0][0] == t * plan.key_tile * rep // plan.row_tile
        assert r[-1][1] == n_rt
        assert all(lo < hi for lo, hi in r)
        assert all(a[1] == b[0] for a, b in zip(r, r[1:]))
        if splits is not None:
            assert len(r) == min(splits, n_rt - r[0][0])
        lengths = [hi - lo for lo, hi in r]
        assert max(lengths) - min(lengths) <= 1
    table, slots = K.bwd_table(plan)
    n = plan.blocks
    blocks, groups = table[:4 * n], table[4 * n:]
    entries = [tuple(blocks[i:i + 4]) for i in range(0, 4 * n, 4)]
    assert sorted((t, i) for t, _, _, i in entries) == sorted(
        (t, i) for t, r in enumerate(plan.ranges) for i in range(len(r)))
    assert all(plan.ranges[t][i] == (lo, hi) for t, lo, hi, i in entries)
    lengths = [hi - lo for _, lo, hi, _ in entries]
    assert lengths == sorted(lengths, reverse=True)
    starts = [g for g, c in zip(groups[::2], groups[1::2]) if c > 1]
    counts = [c for c in groups[1::2] if c > 1]
    assert [c for c in groups[1::2]] == [len(r) for r in plan.ranges]
    assert starts == [sum(counts[:i]) for i in range(len(counts))]
    assert slots == sum(counts)
    assert all(g == -1 for g, c in zip(groups[::2], groups[1::2]) if c == 1)


@pytest.mark.parametrize("splits", [2, 3])
@pytest.mark.parametrize("B,S,Hq,Hkv,D", CASES)
def test_writeout_with_splits_within_bound_and_of_one_split(B, S, Hq, Hkv,
                                                            D, splits):
    """The bf16 write-out over split ranges (2 or 3 forced a key tile)
    stays within the bound, and within f32 rounding (``F32_TOL`` of M)
    of the same write-out at one split: only the order of the f32 sums
    moves."""
    q, k, v, do = _inputs(B, S, Hq, Hkv, D, seed=5 * S + D)
    scale = D ** -0.5
    dtype = torch.bfloat16
    tq, tk, tv, tdo = (_torch(a, dtype) for a in (q, k, v, do))
    o32, lse = chunked_attention_ref(tq.float(), tk.float(), tv.float(),
                                     causal=True, scale=scale,
                                     return_lse=True)
    want = attention_bwd_ref(tq, tk, tv, o32, tdo, lse, scale=scale)
    mag = attention_bwd_ref(tq, tk, tv, o32, tdo, lse, scale=scale,
                            absolute=True)
    plan = K.bwd_plan(B, S, Hq, Hkv, D, 132, splits=splits)
    assert plan.splits > 1
    o = o32.to(dtype)
    got = kernel_writeout(tq, tk, tv, o, tdo, lse, scale=scale, bf16=True,
                          plan=plan)
    one = kernel_writeout(tq, tk, tv, o, tdo, lse, scale=scale, bf16=True,
                          plan=K.bwd_plan(B, S, Hq, Hkv, D, 132, splits=1))
    for g, w, m in zip(got, want, mag):
        within(g.to(dtype), w, m, BF16_TOL)
    torch.testing.assert_close(got[0], one[0], rtol=0, atol=0)
    for g, w, m in zip(got[1:], one[1:], mag[1:]):
        within(g, w, m, F32_TOL)


def test_library_path_follows_included_headers(tmp_path, monkeypatch):
    """A kernel library is named by its source, every ``csrc/`` header it
    includes (through other headers too) and the flags: editing
    ``hopper.cuh`` renames (so rebuilds) both flash-attention libraries,
    and a header no source includes renames none."""
    from repro_torch.kernels import common
    assert [p.name for p in common.sources("flash_attention_bwd")] == [
        "flash_attention_bwd.cu", "hopper.cuh"]
    assert [p.name for p in common.sources("flash_attention")] == [
        "flash_attention.cu", "hopper.cuh"]
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text('#include "x.cuh"\n#include <stdint.h>\n')
    (csrc / "b.cu").write_text("int b;\n")
    (csrc / "x.cuh").write_text('#pragma once\n#include "y.cuh"\n')
    (csrc / "y.cuh").write_text("int y;\n")
    (csrc / "z.cuh").write_text("int z;\n")
    monkeypatch.setattr(common, "CSRC", csrc)
    before = {n: common.library_path(n) for n in ("a", "b")}
    (csrc / "z.cuh").write_text("int z2;\n")
    assert {n: common.library_path(n) for n in ("a", "b")} == before
    (csrc / "y.cuh").write_text("int y2;\n")
    after = {n: common.library_path(n) for n in ("a", "b")}
    assert after["a"] != before["a"] and after["b"] == before["b"]


def test_writeout_sums_a_group_in_head_order():
    """GQA: dK and dV of a KV head are the sums over its query heads; the
    write-out's flattened rows cover every (position, head) once."""
    B, S, Hq, Hkv, D = 1, 40, 6, 2, 32
    q, k, v, do = (torch.from_numpy(a) for a in
                   _inputs(B, S, Hq, Hkv, D, seed=1))
    o, lse = chunked_attention_ref(q, k, v, causal=True, scale=D ** -0.5,
                                   return_lse=True)
    got = kernel_writeout(q, k, v, o, do, lse, scale=D ** -0.5, bf16=False)
    # each KV head alone, as three MHA problems summed
    parts = [attention_bwd_ref(q[:, :, 3 * g:3 * g + 3],
                               k[:, :, g:g + 1].expand(B, S, 3, D),
                               v[:, :, g:g + 1].expand(B, S, 3, D),
                               o[:, :, 3 * g:3 * g + 3],
                               do[:, :, 3 * g:3 * g + 3],
                               lse[:, 3 * g:3 * g + 3], scale=D ** -0.5)
             for g in range(Hkv)]
    for g in range(Hkv):
        torch.testing.assert_close(got[1][:, :, g], parts[g][1].sum(2),
                                   rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got[2][:, :, g], parts[g][2].sum(2),
                                   rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got[0][:, :, 3 * g:3 * g + 3],
                                   parts[g][0], rtol=1e-5, atol=1e-5)


def test_forward_lse_units():
    """The forward kernels save lse = m + log(l), m the row's running max
    of the scaled scores and l its sum of e^(s - m), folded tile by tile
    with exp2 of log2(e)-scaled scores (csrc/flash_attention.cu): natural
    units, the plain lse, and P = e^(s - lse) sums to 1 over each row."""
    B, S, Hq, Hkv, D = 1, 200, 4, 2, 64
    q, k, v, _ = (torch.from_numpy(a) for a in
                  _inputs(B, S, Hq, Hkv, D, seed=2))
    scale = D ** -0.5
    _, lse = chunked_attention_ref(q, k, v, causal=True, scale=scale,
                                   return_lse=True)
    kr = k.repeat_interleave(Hq // Hkv, dim=2)
    s = torch.einsum("bqhd,bthd->bhqt", q, kr) * scale
    keep = torch.tril(torch.ones(S, S, dtype=torch.bool))
    s = torch.where(keep, s, -1e30)
    m = torch.full((B, Hq, S), -1e30)
    l = torch.zeros((B, Hq, S))
    for j0 in range(0, S, 64):                  # the kernels' online fold
        t = s[..., j0:j0 + 64]
        m_new = torch.maximum(m, t.amax(-1))
        ms = torch.where(m_new == -1e30, 0.0, m_new * LOG2E)
        l = l * torch.exp2(m * LOG2E - ms) + torch.exp2(
            t * LOG2E - ms[..., None]).sum(-1)
        m = m_new
    kernel_lse = m + torch.log(l)
    torch.testing.assert_close(kernel_lse, lse, rtol=1e-6, atol=1e-5)
    p = torch.where(keep, torch.exp(s - lse[..., None]), 0.0)
    torch.testing.assert_close(p.sum(-1), torch.ones(B, Hq, S), rtol=1e-5,
                               atol=1e-5)
    # the kernels' (B, Hkv, rows) layout, rows position-major
    rows = _rows(lse.permute(0, 2, 1)[..., None], Hq // Hkv)[..., 0]
    torch.testing.assert_close(K.lse_by_head(rows, Hq), lse, rtol=0, atol=0)


@pytest.mark.parametrize("shape,D", [((8, 1, 24, 8, 32768), 128),
                                     ((1, 32768, 24, 8, 32768), 128),
                                     ((1, 1, 8, 1, 8208), 256),
                                     ((4, 64, 4, 4, 64), 32)])
def test_training_route_takes_the_tile_kernel_at_one_split(shape, D):
    """Where ``plan`` picks the decode kernel or splits, the training
    route still takes the tile kernel of its type at one split."""
    assert K.train_plan(torch.bfloat16) == ("flash_attention", 1)
    assert K.train_plan(torch.float32) == ("flash_attention_f32", 1)
    planned = K.plan(*shape, n_sm=132, D=D)
    assert planned[0] in K._FWD
    assert K.train_plan(torch.bfloat16)[0] == K.MMA.name


REFUSED = [
    (dict(causal=False), "causal=False"),
    (dict(q_offset=5), "q_offset 5"),
    (dict(kv_len=30), "a kv_len"),
    (dict(T=48), "32 queries over 48 keys"),
    (dict(D=48), "head dim 48"),
]


@pytest.mark.parametrize("change,named", REFUSED)
def test_f1_guard_refuses_what_the_backward_does_not_take(change, named):
    case = dict(S=32, T=32, D=128, causal=True, q_offset=0, kv_len=None)
    K.check_train_case(**case)                  # lm_loss's case passes
    with pytest.raises(NotImplementedError, match=named):
        K.check_train_case(**{**case, **change})


def test_f1_guard_on_the_wrapper():
    """Under grad, ``flash_attention`` decides with ``check_train_case``
    before anything touches the card; ``flash_attention_split`` refuses
    grad; with grad off both keep their contracts (CPU tensors raise as
    before)."""
    q = torch.randn(1, 8, 2, 32, requires_grad=True)
    k = torch.randn(1, 8, 2, 32)
    with pytest.raises(NotImplementedError, match="q_offset 3"):
        K.flash_attention(q, k, k, causal=True, scale=0.1, q_offset=3)
    with pytest.raises(NotImplementedError, match="causal=False"):
        K.flash_attention(q, k, k, causal=False, scale=0.1)
    with pytest.raises(ValueError, match="CUDA"):     # lm_loss's case
        K.flash_attention(q, k, k, causal=True, scale=0.1)
    with pytest.raises(RuntimeError, match="no backward"):
        K.flash_attention_split(q, k, k, causal=True, scale=0.1, splits=2)
    with torch.no_grad():
        with pytest.raises(ValueError, match="CUDA"):
            K.flash_attention(q, k, k, causal=False, scale=0.1, q_offset=3)


def test_backward_wrappers_require_the_card():
    """A CPU tensor never reaches a backward kernel: the wrappers raise
    (the CPU's gradient is autograd through the plain version)."""
    q = torch.randn(1, 8, 2, 32)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        K.flash_attention_bwd(q, q, q, q, q, lse, scale=0.1)
    with pytest.raises(ValueError, match="CUDA"):
        K.flash_attention_lse(q, q, q, scale=0.1)
