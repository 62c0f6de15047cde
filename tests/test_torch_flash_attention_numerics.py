"""The bf16 arithmetic of the tensor-core flash-attention kernels
(``csrc/flash_attention.cu``: ``fa_wgmma``, ``fa_mma``, ``fa_decode``),
emulated in plain torch on the CPU and held against the references at
long kv ranges, so the numerics choice is pinned where there is no card.

The emulation follows the kernels step for step: bf16 inputs; scores as
f32 sums of exact products (bf16 x bf16 is exact in f32), scaled, masked
to -1e30; the online softmax in f32 over tiles of 128 keys (keys masked
so far weigh 0); P split as P_hi = bf16(P) and P_lo = bf16(P - P_hi), both
multiplied by V into one f32 accumulator; one division by max(l, 1e-30)
and one rounding to bf16.  It must stay within one bf16 step, 2^-7
relative plus 1e-4 of the largest magnitude (``chip_smoke.py``'s
``close``, the kernels' check on the card), of ``chunked_attention_ref``
and of the JAX package's ``_chunked_attention`` on the same numpy inputs,
at 4,096 keys and more, for GQA 3:1 and MQA 8:1, causal and with a ragged
``kv_len``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.sharding import NULL_CTX
from repro.models.lm.model import _chunked_attention as jax_chunked
from repro_torch.kernels.flash_attention.ref import (NEG_INF,
                                                     chunked_attention_ref)

torch.set_num_threads(2)

BF16_STEP = 2.0 ** -7
TILE = 128                   # keys per tile of fa_wgmma at head dim 128


def close(a: torch.Tensor, b: torch.Tensor, rel: float) -> bool:
    a, b = a.float(), b.float()
    return bool(((a - b).abs() <= rel * b.abs() + 1e-4 * b.abs().max()
                 ).all())


def split_p(p: torch.Tensor):
    """P as the kernels feed it to the tensor cores: two bf16 parts."""
    hi = p.to(torch.bfloat16).float()
    return hi, (p - hi).to(torch.bfloat16).float()


def kernel_emulation(q, k, v, *, causal, q_offset, kv_len, scale,
                     tile=TILE):
    """bf16 q (B, S, H, D), k/v (B, T, Hkv, D) -> bf16 (B, S, H, D) by the
    kernels' arithmetic (module docstring)."""
    B, S, H, D = q.shape
    T, rep = k.shape[1], H // k.shape[2]
    qf = q.float().permute(0, 2, 1, 3)
    kf = k.float().repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)
    vf = v.float().repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)
    kv = torch.as_tensor(T if kv_len is None else kv_len).expand(B)
    pos = q_offset + torch.arange(S)
    m = torch.full((B, H, S), NEG_INF)
    l = torch.zeros((B, H, S))
    acc = torch.zeros((B, H, S, D))
    for j0 in range(0, T, tile):
        j = torch.arange(j0, min(j0 + tile, T))
        s = (qf @ kf[:, :, j].transpose(-1, -2)) * scale
        mask = (j[None, :] < kv[:, None])[:, None, None, :]
        if causal:
            mask = mask & (j[None, :] <= pos[:, None])[None, None]
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        ms = torch.where(m_new == NEG_INF, 0.0, m_new)
        alpha = torch.exp(m - ms)
        p = torch.exp(s - ms[..., None])
        l = l * alpha + p.sum(dim=-1)
        hi, lo = split_p(p)
        acc = acc * alpha[..., None] + hi @ vf[:, :, j] + lo @ vf[:, :, j]
        m = m_new
    o = acc / torch.clamp_min(l, 1e-30)[..., None]
    return o.permute(0, 2, 1, 3).to(torch.bfloat16)


CASES = [
    # (B, S, Hq, Hkv, T, D, causal, q_offset, kv_len)
    (1, 4096, 3, 1, 4096, 64, True, 0, None),          # GQA 3:1 prefill
    (1, 4096, 8, 1, 4096, 32, True, 0, None),          # MQA 8:1 prefill
    (2, 1, 24, 8, 8192, 128, False, 0, [8192, 4097]),  # GQA decode, ragged
    (2, 16, 8, 1, 6144, 64, True, 6128, [6144, 4500]),  # MQA chunk, ragged
]


@pytest.mark.parametrize("B,S,Hq,Hkv,T,D,causal,q_offset,kv_len", CASES)
def test_kernel_arithmetic_within_one_bf16_step(B, S, Hq, Hkv, T, D, causal,
                                                q_offset, kv_len):
    rng = np.random.default_rng(B * S + T + D)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for shape in (
        (B, S, Hq, D), (B, T, Hkv, D), (B, T, Hkv, D)))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    kw = dict(causal=causal, q_offset=q_offset, scale=D ** -0.5)
    tkv = None if kv_len is None else torch.tensor(kv_len)
    got = kernel_emulation(tq, tk, tv, kv_len=tkv, **kw)
    want = chunked_attention_ref(tq, tk, tv, kv_len=tkv, block_q=512, **kw)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    jkv = None if kv_len is None else jnp.asarray(kv_len, jnp.int32)
    want_jax = torch.from_numpy(np.array(jax_chunked(
        *jb, kv_len=jkv, block_q=512, ctx=NULL_CTX, **kw
    ).astype(jnp.float32)))
    assert got.dtype == torch.bfloat16
    assert close(got, want, BF16_STEP)
    assert close(got, want_jax, BF16_STEP)


def test_p_split_carries_sixteen_bits():
    """hi + lo stays within 2^-16 of P, where one bf16 rounding of P is off
    by up to 2^-8: the split is what keeps P.V inside the check."""
    p = torch.from_numpy(np.random.default_rng(0).uniform(
        1e-6, 1.0, 1 << 20).astype(np.float32))
    hi, lo = split_p(p)
    assert float(((hi + lo - p).abs() / p).max()) <= 2.0 ** -16
    assert float(((hi - p).abs() / p).max()) > 2.0 ** -10
