"""RankGraph-2 losses (paper Eq. 5-8), as ``repro/core/losses.py``.

Margin ranking (Eq. 5, margin 0.1) + InfoNCE (Eq. 6, tau 0.06) per
edge; per-task losses combined with learned uncertainty weighting
(Kendall et al. 2018): one learned log-variance per (loss kind x edge
type) task plus the RQ-index tasks.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels.fused_contrastive.ops import contrastive

EDGE_TYPES = ("uu", "ui", "iu", "ii")
TASKS = tuple(f"{k}_{et}" for k in ("margin", "infonce") for et in EDGE_TYPES
              ) + ("rq_recon", "rq_contrastive", "rq_reg", "rq_util")


def init_uncertainty(dtype: torch.dtype = torch.float32,
                     device=None) -> torch.nn.ParameterDict:
    """Learned log-variances s_k; loss = sum exp(-s_k) L_k + s_k."""
    return torch.nn.ParameterDict({
        t: torch.nn.Parameter(torch.zeros((), dtype=dtype, device=device))
        for t in TASKS})


def pair_losses(src: torch.Tensor, dst: torch.Tensor, negs: torch.Tensor,
                *, margin: float = 0.1, tau: float = 0.06
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(margin_loss, infonce_loss), each (B,), through the
    ``fused_contrastive`` op: its forward and backward kernels on a
    card, the plain version on the CPU."""
    return contrastive(src, dst, negs, margin=margin, tau=tau)


def uncertainty_combine(task_losses: Dict[str, torch.Tensor],
                        log_vars) -> torch.Tensor:
    """Kendall et al.: sum_k exp(-s_k) L_k + s_k, in the order of
    ``task_losses`` (missing tasks skipped)."""
    total = None
    for name, loss in task_losses.items():
        s = log_vars[name].to(torch.float32)
        term = torch.exp(-s) * loss.to(torch.float32) + s
        total = term if total is None else total + term
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    return total
