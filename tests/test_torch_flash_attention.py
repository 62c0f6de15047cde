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
  * ``merge_ref`` (the split-KV merge the CUDA merge kernel is held
    against on the card) on partials made per split with plain torch
    equals one softmax over all keys, within 1e-5;
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


def _partials(q, k, v, *, kv_len, splits, bk, scale):
    """Split-KV partials as the forward kernel forms them, in plain torch:
    the kv tiles of ``bk`` keys cut into ``splits`` ranges; per range the
    max of the row's scores, the sum of exp(s - max) and exp(s - max) V.
    Layout (splits, B, Hkv, rows[, D]), rows position-major."""
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    n_t = -(-min(T, kv_len) // bk)
    per = -(-n_t // splits)
    qg = q.reshape(B, S, Hkv, rep, D).permute(0, 2, 1, 3, 4).reshape(
        B, Hkv, S * rep, D).double()
    m = torch.full((splits, B, Hkv, S * rep), -1e30, dtype=torch.float64)
    l = torch.zeros_like(m)
    acc = torch.zeros(m.shape + (D,), dtype=torch.float64)
    for s in range(splits):
        lo, hi = s * per * bk, min((s + 1) * per * bk, kv_len)
        if lo >= hi:
            continue
        kk = k[:, lo:hi].permute(0, 2, 1, 3).double()
        vv = v[:, lo:hi].permute(0, 2, 1, 3).double()
        sc = torch.einsum("bgrd,bgtd->bgrt", qg, kk) * scale
        m[s] = sc.amax(dim=-1)
        p = torch.exp(sc - m[s][..., None])
        l[s] = p.sum(dim=-1)
        acc[s] = torch.einsum("bgrt,bgtd->bgrd", p, vv)
    return m.float(), l.float(), acc.float()


@pytest.mark.parametrize("splits", [1, 3, 8])
@pytest.mark.parametrize("S,H,Hkv,kv_len", [(1, 6, 2, 300), (2, 4, 4, 130),
                                            (1, 8, 1, 64)])
def test_merge_ref_of_split_partials_is_one_softmax(S, H, Hkv, kv_len,
                                                    splits):
    B, T, D = 2, 320, 16
    q, k, v = (torch.from_numpy(a) for a in
               _qkv(B, H, Hkv, S, T, D, splits + S + H, layout="bshd"))
    m, l, acc = _partials(q, k, v, kv_len=kv_len, splits=splits, bk=K.BK,
                          scale=D ** -0.5)
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
            K.flash_attention_partials(q, k, v, causal=True, scale=0.1,
                                       splits=splits)
    m = torch.zeros((2, 1, 2, 8))
    with pytest.raises(ValueError):
        K.flash_attention_merge(m, m, torch.zeros((2, 1, 2, 8, 32)),
                                n_heads=2, dtype=torch.float32)
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
