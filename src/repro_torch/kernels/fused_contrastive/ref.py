"""Plain PyTorch fused margin + InfoNCE contrastive losses (Eq. 5-6): the
readable spec the CUDA kernels are held against.

  * ``contrastive_ref``: the losses by autograd through plain torch
    (``repro/kernels/fused_contrastive/ref.py::contrastive_ref``);
  * ``fwd_ref``: what the forward kernel emits (``_fwd_kernel``):
    per-row margin loss, InfoNCE loss, positive similarity and
    log-sum-exp, all float32;
  * ``bwd_ref``: what the backward kernel emits (``_bwd_kernel``): the
    closed-form gradients with respect to src, dst and negs, given the
    upstream cotangents of both losses.

All arithmetic is float32, whatever the input type.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def contrastive_ref(src: torch.Tensor, dst: torch.Tensor,
                    negs: torch.Tensor, *, margin: float = 0.1,
                    tau: float = 0.06
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """src/dst (B, d) l2-normalized, negs (B, N, d) l2-normalized.
    Returns (margin_loss (B,), infonce_loss (B,)) float32."""
    s_pos = (src * dst).sum(dim=-1).to(torch.float32)
    s_neg = torch.einsum("bd,bnd->bn", src, negs).to(torch.float32)
    marg = F.relu(s_neg - s_pos[:, None] + margin).sum(dim=-1)
    logits = torch.cat([s_pos[:, None], s_neg], dim=1) / tau
    infonce = -F.log_softmax(logits, dim=-1)[:, 0]
    return marg, infonce


def _sims(src, dst, negs):
    src, dst, negs = (t.to(torch.float32) for t in (src, dst, negs))
    s_pos = (src * dst).sum(dim=-1)
    s_neg = torch.einsum("bd,bnd->bn", src, negs)
    return src, dst, negs, s_pos, s_neg


def fwd_ref(src: torch.Tensor, dst: torch.Tensor, negs: torch.Tensor, *,
            margin: float, tau: float
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                       torch.Tensor]:
    """(marg, info, s_pos, lse), each (B,) float32, with
    ``m = max(max s_neg, s_pos) / tau`` and
    ``lse = m + log(sum exp(s_neg/tau - m) + exp(s_pos/tau - m))``."""
    _, _, _, s_pos, s_neg = _sims(src, dst, negs)
    marg = torch.clamp_min(s_neg - s_pos[:, None] + margin, 0.0).sum(-1)
    m = torch.maximum(s_neg.amax(dim=-1), s_pos) / tau
    lse = m + torch.log(torch.exp(s_neg / tau - m[:, None]).sum(-1)
                        + torch.exp(s_pos / tau - m))
    return marg, lse - s_pos / tau, s_pos, lse


def bwd_ref(src: torch.Tensor, dst: torch.Tensor, negs: torch.Tensor,
            gm: torch.Tensor, gi: torch.Tensor, s_pos: torch.Tensor,
            lse: torch.Tensor, *, margin: float, tau: float
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(d_src (B, d), d_dst (B, d), d_negs (B, N, d)) float32.

    marg = sum_n relu(s_neg - s_pos + margin):
        d/ds_neg[n] = 1{active_n},   d/ds_pos = -sum_n 1{active_n}
    info = lse - s_pos / tau with softmax p = exp(s/tau - lse):
        d/ds_neg[n] = p_n / tau,     d/ds_pos = (p_pos - 1) / tau
    """
    src, dst, negs, _, s_neg = _sims(src, dst, negs)
    gm, gi, s_pos, lse = (t.to(torch.float32)[:, None]
                          for t in (gm, gi, s_pos, lse))
    active = (s_neg - s_pos + margin > 0.0).to(torch.float32)
    a = gm * active + gi * (torch.exp(s_neg / tau - lse) / tau)
    c = (-gm * active.sum(dim=-1, keepdim=True)
         + gi * (torch.exp(s_pos / tau - lse) - 1.0) / tau)
    d_src = c * dst + torch.einsum("bn,bnd->bd", a, negs)
    return d_src, c * src, a[:, :, None] * src[:, None, :]
