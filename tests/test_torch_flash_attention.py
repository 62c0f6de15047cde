"""The attention of the PyTorch port against the JAX package, on the same
numpy inputs:

  * ``attention_ref`` against the JAX Pallas ``flash_attention`` (interpret
    mode) and the JAX ``attention_ref`` over the sweep of
    ``tests/test_kernels.py`` (GQA, ragged, decode, cross, head dims 32 to
    128) at its tolerance, rtol = atol = 3e-4, and its bf16 case at 5e-2
    (bf16 scores and probabilities, as both oracles round them);
  * ``chunked_attention_ref`` against ``repro.models.lm.model.
    _chunked_attention`` for causal prefill, decode with ``kv_len < T``
    and a ``q_offset``, at block sizes 1, 8 and an odd one, within 1e-5
    (the same f32 arithmetic; sums in another order);
  * ``merge_ref`` (the split-KV merge that the kernels' fold is held
    against on the card) on partials made per split with plain torch
    equals one softmax over all keys, within 1e-5;
  * a plain-torch model of the kernels' split fold (each block writes its
    partials and counts its arrival; the one that arrives last merges
    every split in split order): the same bits for every arrival order,
    and within 1e-5 of ``chunked_attention_ref`` and the JAX
    ``_chunked_attention``, with empty splits, rows all masked in a
    split, and long_500k's 33 splits;
  * a mirror of the kernels' ``key_range`` schedule at the forced-split
    cases ``chip_smoke.py`` runs: which splits are empty, every key tile
    taken once, every (row tile, b, KV head) counting ``splits``
    arrivals, and the fold of the partials it gives against both
    references;
  * the launch plan at the main path's shapes, and the device rule: CPU
    tensors take the plain versions (bitwise), the kernel wrappers refuse
    them, and the ops refuse a device that is neither cuda nor cpu.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.sharding import NULL_CTX
from repro.kernels.flash_attention.flash_attention import (
    flash_attention as jax_flash)
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro.models.lm.model import _chunked_attention as jax_chunked
from repro_torch.kernels.flash_attention import flash_attention as K
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     chunked_attention_ref,
                                                     merge_ref)

torch.set_num_threads(2)

SWEEP = [(2, 4, 2, 256, 256, 64, True),
         (1, 2, 2, 200, 200, 32, True),       # ragged
         (2, 4, 1, 1, 300, 64, True),         # decode
         (1, 2, 2, 128, 256, 64, False),      # cross
         (1, 8, 8, 96, 96, 128, True)]
TOL = dict(rtol=3e-4, atol=3e-4)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)
CHUNK_TOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(B, Hq, Hkv, S, T, D, seed, layout="bhsd"):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, S, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, T, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, T, D)).astype(np.float32)
    if layout == "bshd":
        q, k, v = (a.transpose(0, 2, 1, 3).copy() for a in (q, k, v))
    return q, k, v


@pytest.mark.parametrize("B,Hq,Hkv,S,T,D,causal", SWEEP)
def test_attention_ref_matches_jax_kernel_and_ref(B, Hq, Hkv, S, T, D,
                                                  causal):
    q, k, v = _qkv(B, Hq, Hkv, S, T, D, S + T)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want_k = np.asarray(jax_flash(jq, jk, jv, causal=causal, interpret=True))
    want_r = np.asarray(jax_ref(jq, jk, jv, causal=causal))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = attention_ref(tq, tk, tv, causal=causal).numpy()
    np.testing.assert_allclose(got, want_k, **TOL)
    np.testing.assert_allclose(got, want_r, **TOL)
    np.testing.assert_array_equal(
        ops.attention(tq, tk, tv, causal=causal).numpy(), got)


def test_attention_ref_bf16_matches_jax():
    q, k, v = _qkv(1, 2, 2, 128, 128, 64, 9)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want_k = np.asarray(jax_flash(*jb, interpret=True).astype(jnp.float32))
    want_r = np.asarray(jax_ref(*jb).astype(jnp.float32))
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    got = attention_ref(*tb)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    np.testing.assert_allclose(got, want_k, **BF16_TOL)
    np.testing.assert_allclose(got, want_r, **BF16_TOL)
    np.testing.assert_allclose(got, np.asarray(jax_ref(*(
        jnp.asarray(a) for a in (q, k, v)))), **BF16_TOL)


CHUNKED = [
    # (B, S, H, Hkv, T, D, causal, q_offset, kv_len)
    (2, 24, 4, 2, 24, 16, True, 0, None),          # prefill, GQA
    (1, 40, 8, 1, 40, 32, True, 0, None),          # prefill, MQA
    (2, 1, 4, 2, 48, 16, False, 0, [30, 48]),      # decode, ragged kv
    (3, 1, 6, 3, 64, 32, False, 0, [1, 17, 63]),
    (1, 5, 4, 4, 40, 16, True, 20, [25]),          # chunk at an offset
]


@pytest.mark.parametrize("block_q", [1, 8, 7])
@pytest.mark.parametrize("B,S,H,Hkv,T,D,causal,q_offset,kv_len", CHUNKED)
def test_chunked_attention_ref_matches_jax(B, S, H, Hkv, T, D, causal,
                                           q_offset, kv_len, block_q):
    q, k, v = _qkv(B, H, Hkv, S, T, D, B * S + T + block_q, layout="bshd")
    jkv = None if kv_len is None else jnp.asarray(kv_len, jnp.int32)
    want = np.asarray(jax_chunked(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_offset=q_offset, kv_len=jkv, block_q=block_q, scale=D ** -0.5,
        ctx=NULL_CTX))
    tkv = None if kv_len is None else torch.tensor(kv_len)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = chunked_attention_ref(tq, tk, tv, causal=causal, q_offset=q_offset,
                                kv_len=tkv, block_q=block_q,
                                scale=D ** -0.5)
    np.testing.assert_allclose(got.numpy(), want, **CHUNK_TOL)
    via_op = ops.chunked_attention(tq, tk, tv, causal=causal,
                                   q_offset=q_offset, kv_len=tkv,
                                   block_q=block_q, scale=D ** -0.5)
    np.testing.assert_array_equal(via_op.numpy(), got.numpy())


def test_chunked_attention_ref_bf16_matches_jax():
    q, k, v = _qkv(2, 4, 2, 16, 16, 32, 3, layout="bshd")
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = np.asarray(jax_chunked(*jb, causal=True, q_offset=0, kv_len=None,
                                  block_q=8, scale=32 ** -0.5,
                                  ctx=NULL_CTX).astype(jnp.float32))
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    got = chunked_attention_ref(*tb, causal=True, block_q=8,
                                scale=32 ** -0.5)
    assert got.dtype == torch.bfloat16
    # the same f32 arithmetic on the same bf16 inputs, one rounding at the
    # end: within one bf16 step
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -7,
                               atol=1e-6)


def _key_range(*, kv_max, kv_end, causal, q_offset, last_row, rep, split,
               splits, bn):
    """``csrc/flash_attention.cu::key_range``: the block's key tiles
    [t_lo, t_hi) of ``bn`` keys, its split's share of the tiles of all
    ``kv_max`` keys, cut at ``kv_end`` (the row's kv_len) and, under
    ``causal``, at the frontier of the block's last row."""
    hi = kv_end
    if causal:
        hi = min(hi, q_offset + last_row // rep + 1)
    n_all = -(-kv_max // bn)
    per = -(-n_all // splits)
    t_lo = split * per
    return t_lo, min(-(-hi // bn), t_lo + per)


def _partials(q, k, v, *, kv_len, splits, bn, scale, causal=False,
              q_offset=0, block_rows=None):
    """Split-KV partials as the forward kernels form them, in plain torch,
    block by block: a (row tile, b, KV head, split) block takes
    ``block_rows`` (position, head-in-group) rows (default: all of them)
    and the key tiles of ``_key_range``; per row the max of its unmasked
    scores, the sum of exp(s - max) and exp(s - max) V in float64, stored
    in f32.  ``kv_len``: an int or one per batch row.  A row with
    no unmasked key in its block (an empty split, or keys all past its
    causal frontier) keeps m -1e30, l 0, acc 0, as the tensor-core
    kernels leave it.  Returns ((m, l, acc), empty, arrivals): the
    partials in ``merge_ref``'s layout, the (row tile, b, split) blocks
    with no tile, and each (row tile, b, KV head)'s count of blocks."""
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    rep, rows = H // Hkv, S * (H // Hkv)
    kv_len = [kv_len] * B if isinstance(kv_len, int) else kv_len
    block_rows = block_rows or rows
    qg = q.reshape(B, S, Hkv, rep, D).permute(0, 2, 1, 3, 4).reshape(
        B, Hkv, rows, D).double()
    pos = q_offset + torch.arange(rows) // rep
    m = torch.full((splits, B, Hkv, rows), -1e30, dtype=torch.float64)
    l = torch.zeros_like(m)
    acc = torch.zeros(m.shape + (D,), dtype=torch.float64)
    empty, arrivals = set(), {}
    for x in range(-(-rows // block_rows)):
        r0, r1 = x * block_rows, min((x + 1) * block_rows, rows)
        for b in range(B):
            kv_end = min(T, int(kv_len[b]))
            for s in range(splits):
                t_lo, t_hi = _key_range(
                    kv_max=T, kv_end=kv_end, causal=causal,
                    q_offset=q_offset, last_row=r1 - 1, rep=rep, split=s,
                    splits=splits, bn=bn)
                for g in range(Hkv):        # every block arrives
                    arrivals[x, b, g] = arrivals.get((x, b, g), 0) + 1
                if t_lo >= t_hi:
                    empty.add((x, b, s))
                    continue
                j = torch.arange(t_lo * bn, min(t_hi * bn, kv_end))
                ok = torch.ones((r1 - r0, len(j)), dtype=torch.bool)
                if causal:
                    ok = j[None, :] <= pos[r0:r1, None]
                kk = k[b, j].permute(1, 0, 2).double()      # (Hkv, keys, D)
                vv = v[b, j].permute(1, 0, 2).double()
                sc = torch.einsum("grd,gtd->grt", qg[b, :, r0:r1], kk) * scale
                sc = torch.where(ok, sc, -torch.inf)
                mx = sc.amax(dim=-1)
                seen = ok.any(dim=-1)[None].expand_as(mx)
                p = torch.exp(sc - torch.where(seen, mx, 0.0)[..., None])
                m[s, b, :, r0:r1] = torch.where(seen, mx, -1e30)
                l[s, b, :, r0:r1] = p.sum(dim=-1)
                acc[s, b, :, r0:r1] = torch.einsum("grt,gtd->grd", p, vv)
    return (m.float(), l.float(), acc.float()), empty, arrivals


@pytest.mark.parametrize("splits", [1, 3, 8])
@pytest.mark.parametrize("S,H,Hkv,kv_len", [(1, 6, 2, 300), (2, 4, 4, 130),
                                            (1, 8, 1, 64)])
def test_merge_ref_of_split_partials_is_one_softmax(S, H, Hkv, kv_len,
                                                    splits):
    B, T, D = 2, 320, 16
    q, k, v = (torch.from_numpy(a) for a in
               _qkv(B, H, Hkv, S, T, D, splits + S + H, layout="bshd"))
    (m, l, acc), _, _ = _partials(q, k, v, kv_len=kv_len, splits=splits,
                                  bn=K.BK, scale=D ** -0.5)
    got = merge_ref(m, l, acc, n_heads=H, dtype=torch.float32)
    want = chunked_attention_ref(q, k, v, causal=False, kv_len=kv_len,
                                 scale=D ** -0.5)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **CHUNK_TOL)


@pytest.mark.parametrize("shape,D,want", [
    # (B, S, Hq, Hkv, kv_max), head dim, bf16 on 132 SMs -> (kernel,
    # splits): one wave of split blocks (two decode blocks per SM at
    # D <= 128, one at D 256), at least MIN_SPLIT_TILES kv tiles each
    ((1, 32768, 24, 8, 32768), 128, ("flash_attention", 1)),   # prefill_32k
    ((8, 1, 24, 8, 32768), 128, ("flash_attention_decode", 4)),  # decode_32k
    ((1, 1, 24, 8, 524288), 128, ("flash_attention_decode", 33)),  # long_500k
    ((1, 8192, 8, 1, 8192), 256, ("flash_attention", 1)),      # gemma 8k
    ((1, 1, 8, 1, 8208), 256, ("flash_attention_decode", 32)),  # gemma decode
    ((2, 1, 4, 2, 200), 128, ("flash_attention_decode", 1)),   # short: no split
    ((1, 4096, 64, 8, 4096), 112, ("flash_attention", 1)),     # kimi prefill
    ((1, 1, 64, 8, 4097), 112, ("flash_attention_decode", 16)),  # kimi decode
])
def test_launch_plan(shape, D, want):
    assert K.plan(*shape, n_sm=132, D=D) == want


def test_cuda_is_refused_or_required():
    q, k, v = (torch.from_numpy(a) for a in
               _qkv(1, 2, 2, 8, 8, 32, 0, layout="bshd"))
    with pytest.raises(ValueError):
        K.flash_attention(q, k, v, causal=True, scale=0.1)
    for splits in (1, 2):       # one split has no partials to return
        with pytest.raises(ValueError):
            K.flash_attention_split(q, k, v, causal=True, scale=0.1,
                                    splits=splits)
    with pytest.raises(ValueError, match="at least 2 splits"):
        K.flash_attention_split(q, k, v, causal=True, scale=0.1, splits=1)
    meta = q.to("meta")
    with pytest.raises(ValueError):
        ops.chunked_attention(meta, meta, meta, causal=True, scale=0.1)


@pytest.mark.parametrize("kv_len", [0, [3, 0]])
def test_chunked_attention_refuses_a_row_with_no_key(kv_len):
    """The kernel writes 0 for a row with no key, the plain softmax the
    mean of v: the ops refuse such a row on either device."""
    q, k, v = (torch.from_numpy(a) for a in
               _qkv(2, 2, 2, 1, 8, 32, 0, layout="bshd"))
    kvl = torch.tensor(kv_len, dtype=torch.int32) \
        if isinstance(kv_len, list) else kv_len
    with pytest.raises(ValueError, match="needs a key"):
        ops.chunked_attention(q, k, v, causal=False, kv_len=kvl, scale=0.1)
    with pytest.raises(ValueError, match="needs a key"):
        K.check_kv_len(kvl)


def _fold(parts, order, n_heads):
    """The kernels' split fold in plain torch.  Blocks arrive in
    ``order``: each writes its split's partials into a workspace that
    starts as NaN and adds one to the group's counter; the block that sees
    splits - 1 merges every split from the workspace in split order (M =
    max_s m_s, then L += l_s e, A += acc_s e with e = exp(m_s - M), o = A
    / max(L, 1e-30), in f32) and resets the counter; no other block
    merges.  Returns (B, S, n_heads, D) and the counter after the
    launch."""
    m, l, acc = parts
    splits, B, Hkv, rows, D = acc.shape
    ws = [torch.full_like(t, float("nan")) for t in parts]
    count, out = 0, None
    for s in order:
        for w, t in zip(ws, parts):
            w[s] = t[s]
        count, last = count + 1, count == splits - 1
        if last:
            assert out is None, "a second block merged"
            M = torch.full(m.shape[1:], -1e30)
            for t in range(splits):
                M = torch.maximum(M, ws[0][t])
            L = torch.zeros_like(M)
            A = torch.zeros(M.shape + (D,))
            for t in range(splits):
                e = torch.exp(ws[0][t] - M)
                L = L + ws[1][t] * e
                A = A + ws[2][t] * e[..., None]
            out = A / torch.clamp_min(L, 1e-30)[..., None]
            count = 0
    rep = n_heads // Hkv
    out = out.reshape(B, Hkv, rows // rep, rep, D).permute(0, 2, 1, 3, 4)
    return out.reshape(B, rows // rep, n_heads, D), count


FOLD_CASES = [
    # (B, S, H, Hkv, T, D, causal, q_offset, kv_len, splits, block_rows,
    # bn, masked: (split, rows) all masked in a block with keys)
    # long_500k's 33 splits (decode geometry): splits 18-32 have no tile
    (1, 1, 6, 2, 2200, 16, False, 0, [2200], 33, 16, 64, None),
    # a ragged kv_len leaves splits 1-4 of batch row 0 empty
    (2, 1, 4, 2, 320, 16, False, 0, [30, 320], 5, 16, 64, None),
    # causal prefill, 128-row blocks: rows 0-63 of the first block are all
    # masked in its split 1; its splits 2 and 3 are empty
    (1, 256, 2, 2, 256, 16, True, 0, [256], 4, 128, 64, (1, 64)),
]


@pytest.mark.parametrize("B,S,H,Hkv,T,D,causal,q_offset,kv_len,splits,"
                         "block_rows,bn,masked", FOLD_CASES)
def test_fold_model_is_order_free_and_matches_jax(B, S, H, Hkv, T, D, causal,
                                                  q_offset, kv_len, splits,
                                                  block_rows, bn, masked):
    q, k, v = (torch.from_numpy(a) for a in
               _qkv(B, H, Hkv, S, T, D, splits + T, layout="bshd"))
    scale = D ** -0.5
    parts, empty, _ = _partials(
        q, k, v, kv_len=kv_len, causal=causal, q_offset=q_offset,
        scale=scale, splits=splits, block_rows=block_rows, bn=bn)
    assert empty                  # every case has an empty split
    if masked is not None:
        s, n = masked
        assert (0, 0, s) not in empty
        assert (parts[0][s, 0, :, :n] == -1e30).all()
        assert (parts[1][s, 0, :, :n] == 0).all()
        assert (parts[0][s, 0, :, n:block_rows] > -1e30).all()
    rng = np.random.default_rng(splits)
    orders = [list(range(splits)), list(range(splits))[::-1]] + [
        list(rng.permutation(splits)) for _ in range(4)]
    outs = []
    for order in orders:
        out, count = _fold(parts, order, H)
        assert count == 0
        outs.append(out)
    for out in outs[1:]:
        np.testing.assert_array_equal(out.numpy(), outs[0].numpy())
    got = outs[0].numpy()
    assert np.isfinite(got).all()
    tkv = torch.tensor(kv_len)
    want = chunked_attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                                 kv_len=tkv, scale=scale)
    np.testing.assert_allclose(got, want.numpy(), **CHUNK_TOL)
    want_j = np.asarray(jax_chunked(
        jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
        jnp.asarray(v.numpy()), causal=causal, q_offset=q_offset,
        kv_len=jnp.asarray(kv_len, jnp.int32), block_q=64, scale=scale,
        ctx=NULL_CTX))
    np.testing.assert_allclose(got, want_j, **CHUNK_TOL)
    # a group whose every split is empty folds to 0 (where a softmax over
    # keys all masked gives the mean of v): why the ops refuse kv_len 0
    m, l, acc = parts
    none = (torch.full_like(m, -1e30), torch.zeros_like(l),
            torch.zeros_like(acc))
    for order in orders[:3]:
        out, _ = _fold(none, order, H)
        assert (out == 0).all()


# query rows of one block at D 64: fa_fwd at 4 rows a thread (16 * 4),
# fa_decode's one 16-row tile, fa_wgmma's two consumer warpgroups
ROW_TILE = {"flash_attention_f32": 64, "flash_attention_decode": 16,
            "flash_attention": 128}


@pytest.mark.parametrize("splits", [2, 5, 11])
@pytest.mark.parametrize("kernel,S", [("flash_attention_f32", 5),
                                      ("flash_attention_decode", 5),
                                      ("flash_attention", 5),
                                      ("flash_attention", 50)])
def test_key_range_schedule_at_forced_splits(kernel, S, splits):
    """chip_smoke.py's forced-split cases (q (3, S, 6, 64), k/v (3, 700,
    2, 64), kv_len [1, 333, 700], q_offset 600, causal or not, scale
    0.125) on each kernel's geometry: its row tile (``ROW_TILE``, the
    f32 kernel at 4 rows a thread as there) and its key tile (128 keys for
    ``fa_wgmma`` at D 64, else 64)."""
    B, H, Hkv, T, D = 3, 6, 2, 700, 64
    kv_len = [1, 333, 700]
    q, k, v = (torch.from_numpy(a) for a in
               _qkv(B, H, Hkv, S, T, D, S + splits, layout="bshd"))
    rows = S * (H // Hkv)
    block_rows = ROW_TILE[kernel]
    bn = 128 if kernel == "flash_attention" else 64
    n_tiles = -(-rows // block_rows)
    for causal in (False, True):
        parts, empty, arrivals = _partials(
            q, k, v, kv_len=kv_len, causal=causal, q_offset=600, scale=0.125,
            splits=splits, block_rows=block_rows, bn=bn)
        # every (row tile, b, KV head) counts `splits` arrivals, empty
        # splits included: the last one folds
        assert arrivals == {(x, b, g): splits for x in range(n_tiles)
                            for b in range(B) for g in range(Hkv)}
        # batch row 0 has one key: its splits past the first are empty
        for x in range(n_tiles):
            assert {s for s in range(splits) if (x, 0, s) in empty} == \
                set(range(1, splits))
        # the non-empty splits take every tile up to the block's last key
        # once, in split order
        for x in range(n_tiles):
            last_row = min((x + 1) * block_rows, rows) - 1
            for b in range(B):
                tiles = []
                for s in range(splits):
                    lo, hi = _key_range(
                        kv_max=T, kv_end=min(T, kv_len[b]), causal=causal,
                        q_offset=600, last_row=last_row, rep=H // Hkv,
                        split=s, splits=splits, bn=bn)
                    tiles += range(lo, hi)
                hi_key = min(T, kv_len[b])
                if causal:
                    hi_key = min(hi_key, 600 + last_row // (H // Hkv) + 1)
                assert tiles == list(range(-(-hi_key // bn)))
        out, count = _fold(parts, list(np.random.default_rng(splits)
                                        .permutation(splits)), H)
        assert count == 0
        want = chunked_attention_ref(q, k, v, causal=causal, q_offset=600,
                                     kv_len=torch.tensor(kv_len),
                                     scale=0.125)
        np.testing.assert_allclose(out.numpy(), want.numpy(), **CHUNK_TOL)
