"""Plain PyTorch attention: the readable specs the CUDA flash-attention
kernel (``csrc/flash_attention.cu``) is held against.

  * ``attention_ref``: ``repro/kernels/flash_attention/ref.py``'s oracle
    in its ``(B, H, S, D)`` contract: scores in the inputs' type, then
    f32, a causal mask aligned to the end of the keys (``tril`` at
    ``T - S``) with ``-inf``, softmax, probabilities cast to ``v``'s
    type, GQA by repeating each KV head over its group;
  * ``chunked_attention_ref``: ``repro/models/lm/model.py::
    _chunked_attention`` in the model's ``(B, S, H, D)`` contract: the
    same loop over blocks of ``block_q`` query rows (so the scores never
    exceed ``(B, H, block_q, T)``), q, k and v in f32, masked scores at
    ``-1e30``, softmax in f32, the output in q's type.  This is what the
    LM model runs on the CPU;
  * ``merge_ref``: the split-KV merge, the partial softmax states that
    ``flash_attention_split`` returns combined into the output (what the
    kernels' fold computes in their last block of each split group).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Hq, S, D), k/v (B, Hkv, T, D) with Hq % Hkv == 0 ->
    (B, Hq, S, D) in v's type."""
    B, Hq, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    k = torch.repeat_interleave(k, rep, dim=1)
    v = torch.repeat_interleave(v, rep, dim=1)
    scale = scale if scale is not None else D ** -0.5
    s = torch.einsum("bhsd,bhtd->bhst", q, k).to(torch.float32) * scale
    if causal:
        mask = torch.tril(torch.ones((S, T), dtype=torch.bool,
                                     device=q.device), diagonal=T - S)
        s = torch.where(mask[None, None], s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", p.to(v.dtype), v)


def chunked_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool, q_offset: int = 0,
                          kv_len: Union[None, int, torch.Tensor] = None,
                          block_q: int = 1024,
                          scale: float) -> torch.Tensor:
    """q (B, S, H, D); k/v (B, T, Hkv, D).  ``q_offset`` is the absolute
    position of q row 0 (a causal mask lets row i see keys
    ``<= q_offset + i``); ``kv_len`` (an int, a (B,) tensor, or None for
    all T) is the number of valid keys of each batch row.  Returns
    (B, S, H, D) in q's type."""
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    kT = k.to(torch.float32)
    vT = v.to(torch.float32)
    cols = torch.arange(T, device=q.device)[None, None, None, :]
    if kv_len is not None:
        kv_len = torch.as_tensor(kv_len, device=q.device).expand(B)
        kv_mask = cols < kv_len[:, None, None, None]
    outs = []
    for q0 in range(0, S, block_q):
        qi = q[:, q0:q0 + block_q]
        s = torch.einsum("bqhd,bthd->bhqt", qi.to(torch.float32), kT) * scale
        mask = torch.ones((1, 1, 1, T), dtype=torch.bool, device=q.device)
        if causal:
            rows = (q0 + q_offset + torch.arange(qi.shape[1], device=q.device)
                    )[None, None, :, None]
            mask = mask & (cols <= rows)
        if kv_len is not None:
            mask = mask & kv_mask
        s = torch.where(mask, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bhqt,bthd->bqhd", p, vT).to(q.dtype))
    return torch.cat(outs, dim=1)


def merge_ref(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor, *,
              n_heads: int, dtype: torch.dtype) -> torch.Tensor:
    """Partials m, l (splits, B, Hkv, rows) and acc (splits, B, Hkv, rows,
    D) in f32, rows the (position, head-in-group) pairs position-major ->
    (B, S, n_heads, D) in ``dtype``: sum_s acc_s e^(m_s - M) /
    max(sum_s l_s e^(m_s - M), 1e-30) with M = max_s m_s."""
    splits, B, Hkv, rows, D = acc.shape
    rep = n_heads // Hkv
    M = m.amax(dim=0)
    e = torch.exp(m - M)
    L = (l * e).sum(dim=0)
    A = (acc * e[..., None]).sum(dim=0)
    o = A / torch.clamp_min(L, 1e-30)[..., None]          # (B, Hkv, rows, D)
    o = o.reshape(B, Hkv, rows // rep, rep, D).permute(0, 2, 1, 3, 4)
    return o.reshape(B, rows // rep, n_heads, D).to(dtype)
