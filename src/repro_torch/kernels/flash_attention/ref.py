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
  * ``attention_bwd_ref``: the backward of causal self-attention in
    closed form, in f32: dQ, dK, dV from q, k, v, the output, its
    gradient and the forward's lse (``chunked_attention_ref(...,
    return_lse=True)``), dK and dV summed over each KV group's heads in
    head order; with ``absolute`` the same products on magnitudes, the
    scale of what any rounding inside can move (the kernels' tolerance);
  * ``block_gap``: the norm-wise gap of two such results over each block
    of positions of a head, the tolerance that sees a lost tile of a
    long row;
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
                          scale: float, return_lse: bool = False):
    """q (B, S, H, D); k/v (B, T, Hkv, D).  ``q_offset`` is the absolute
    position of q row 0 (a causal mask lets row i see keys
    ``<= q_offset + i``); ``kv_len`` (an int, a (B,) tensor, or None for
    all T) is the number of valid keys of each batch row.  Returns
    (B, S, H, D) in q's type; with ``return_lse`` also each row's
    logsumexp of its masked scaled scores, (B, H, S) f32 in natural units
    (what the kernels' training route saves)."""
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
    outs, lses = [], []
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
        if return_lse:
            lses.append(torch.logsumexp(s, dim=-1))
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bhqt,bthd->bqhd", p, vT).to(q.dtype))
    out = torch.cat(outs, dim=1)
    return (out, torch.cat(lses, dim=2)) if return_lse else out


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                      *, scale: float, absolute: bool = False):
    """The gradient of causal self-attention, in f32, one query head at a
    time: with s = q.k * scale masked past each row's position,
    P = exp(s - lse), Di = rowsum(dO * o), dS = P * (dO.V^T - Di),
    returns dQ = scale dS K (B, S, Hq, D), dK = scale dS^T Q and
    dV = P^T dO (B, S, Hkv, D), dK and dV summed over each group's query
    heads in head order.  q, o, do (B, S, Hq, D), k, v (B, S, Hkv, D) in
    any float type (read as f32), lse (B, Hq, S).  With ``absolute`` P
    stays, every other factor is its magnitude and dS is P * (|dO|.|V|^T
    + |dO|.|O|): the sums of the magnitudes of the terms, which bound
    what rounding any factor by a relative e moves each result (by e
    times it)."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    rep = Hq // Hkv
    f = (lambda t: t.float().abs()) if absolute else (lambda t: t.float())
    dq = torch.zeros((B, S, Hq, D), dtype=torch.float32, device=q.device)
    dk = torch.zeros((B, S, Hkv, D), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    keep = torch.tril(torch.ones((S, S), dtype=torch.bool, device=q.device))
    for h in range(Hq):
        g = h // rep
        qh, kh = q[:, :, h].float(), k[:, :, g].float()
        s = torch.einsum("bsd,btd->bst", qh, kh) * scale
        p = torch.where(keep, torch.exp(s - lse[:, h, :, None].float()), 0.0)
        doh, vh, oh = f(do[:, :, h]), f(v[:, :, g]), f(o[:, :, h])
        dp = torch.einsum("bsd,btd->bst", doh, vh)
        di = (doh * oh).sum(dim=-1, keepdim=True)
        ds = p * (dp + di if absolute else dp - di)
        dq[:, :, h] = scale * torch.einsum("bst,btd->bsd", ds, f(k[:, :, g]))
        dk[:, :, g] += scale * torch.einsum("bst,bsd->btd", ds,
                                            f(q[:, :, h]))
        dv[:, :, g] += torch.einsum("bst,bsd->btd", p, doh)
    return dq, dk, dv


def block_gap(got: torch.Tensor, want: torch.Tensor,
              block: int = 64) -> float:
    """The largest ||got - want|| / ||want|| over blocks of ``block``
    positions of one head of (B, S, H, D) results (0 where a block of
    ``want`` and the gap are both 0).  A tile's terms land in the blocks
    they belong to, where a norm over the whole result, or M (which grows
    with a row's length while an entry grows with its square root),
    would dilute a lost or repeated tile of a long row."""
    B, S, H, D = want.shape

    def sq(t):
        t = torch.nn.functional.pad(t, (0, 0, 0, 0, 0, -S % block))
        return t.square().reshape(B, -1, block, H, D).sum(dim=(2, 4))
    num, den = sq(got.float() - want.float()), sq(want.float())
    return float(torch.where(num == 0, 0.0, (num / den).sqrt()).max())


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
