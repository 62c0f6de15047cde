"""Public attention ops.  The path follows the tensors' device: CUDA
tensors launch the flash-attention kernel (``flash_attention.py``) or
raise, and under autograd its ``FlashAttention`` carries the backward
kernel; CPU tensors take the plain versions in ``ref.py`` (autograd
differentiates them).

  * ``chunked_attention``: the LM model's contract, q (B, S, H, D), k/v
    (B, T, Hkv, D), ``causal``, ``q_offset``, ``kv_len`` (on the CPU,
    ``chunked_attention_ref``: ``repro/models/lm/model.py::
    _chunked_attention``);
  * ``decode_attention_lse``: one decode step's rows over a block of
    keys with each row's logsumexp and the output in f32, for the fold
    across the ranks of a sequence-sharded cache (on the card
    ``flash_attention_decode_lse``; on the CPU ``chunked_attention_ref(...,
    return_lse=True)`` on q in f32, so that its output is not rounded);
  * ``attention``: the Pallas wrapper's contract, (B, H, S, D), causal
    mask aligned to the end of the keys (on the CPU, ``attention_ref``,
    as ``repro/kernels/flash_attention/ops.py::attention`` without
    ``use_kernel``).
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from repro_torch.kernels.flash_attention.flash_attention import (
    check_kv_len, flash_attention, flash_attention_decode_lse)
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     chunked_attention_ref)


def _on_card(t: torch.Tensor) -> bool:
    dev = t.device.type
    if dev not in ("cuda", "cpu"):
        raise ValueError(f"attention runs on cuda or cpu, not {t.device}")
    return dev == "cuda"


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, q_offset: int = 0,
                      kv_len: Union[None, int, torch.Tensor] = None,
                      block_q: int = 1024, scale: float) -> torch.Tensor:
    """q (B, S, H, D), k/v (B, T, Hkv, D) -> (B, S, H, D) in q's type.
    ``block_q`` bounds the plain version's scores; the kernel tiles on
    its own.  Both refuse a ``kv_len`` below 1 for any row."""
    if _on_card(q):
        return flash_attention(q, k, v, causal=causal, scale=scale,
                               q_offset=q_offset, kv_len=kv_len)
    check_kv_len(kv_len)
    return chunked_attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                                 kv_len=kv_len, block_q=block_q, scale=scale)


def decode_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, kv_len: Union[int, torch.Tensor], scale: float
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B, S, H, D), k/v (B, T, Hkv, D), non-causal, keys below
    ``kv_len`` (at least 1) -> (out (B, S, H, D) f32, lse (B, S, H) f32).
    The kernel takes S 1 (a decode step); both refuse grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("decode_attention_lse has no backward: call it "
                           "with grad off (decode is serving)")
    B, S, H, _ = q.shape
    if _on_card(q):
        out, lse = flash_attention_decode_lse(q, k, v, kv_len=kv_len,
                                              scale=scale)
        return out, lse.view(B, S, H)
    check_kv_len(kv_len)
    out, lse = chunked_attention_ref(q.to(torch.float32), k, v, causal=False,
                                     kv_len=kv_len, block_q=S, scale=scale,
                                     return_lse=True)
    return out, lse.transpose(1, 2)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True,
              scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Hq, S, D), k/v (B, Hkv, T, D) -> (B, Hq, S, D); under
    ``causal`` query row i sits at position ``T - S + i``.  On the card
    the result is a (B, Hq, S, D) view of a (B, S, Hq, D) tensor."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if not _on_card(q):
        return attention_ref(q, k, v, causal=causal, scale=scale)
    S, T = q.shape[2], k.shape[2]
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=causal, scale=scale,
                          q_offset=T - S if causal else 0)
    return out.transpose(1, 2)
