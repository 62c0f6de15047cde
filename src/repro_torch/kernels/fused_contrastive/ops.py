"""Public fused-contrastive op.

The path follows the tensors' device: on CUDA tensors the losses come
from the forward kernel and their gradients from the backward kernel
(``FusedContrastive``); on CPU tensors from the plain version, by
autograd.  Both are differentiable, so callers are the same either way.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.fused_contrastive.fused_contrastive import (
    FusedContrastive)
from repro_torch.kernels.fused_contrastive.ref import contrastive_ref


def contrastive(src: torch.Tensor, dst: torch.Tensor, negs: torch.Tensor,
                *, margin: float = 0.1, tau: float = 0.06
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """src/dst (B, d), negs (B, N, d) of one type -> (margin_loss (B,),
    infonce_loss (B,)) float32."""
    dev = src.device
    if dev.type == "cuda":
        return FusedContrastive.apply(src.contiguous(), dst.contiguous(),
                                      negs.contiguous(), float(margin),
                                      float(tau))
    if dev.type == "cpu":
        return contrastive_ref(src, dst, negs, margin=margin, tau=tau)
    raise ValueError(f"contrastive runs on cuda or cpu, not {dev}")
