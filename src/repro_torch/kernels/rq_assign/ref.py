"""Plain PyTorch residual-quantization assignment (Eq. 9/10): the
readable spec the CUDA kernel is held against."""
from __future__ import annotations

from typing import Sequence, Tuple

import torch


def rq_assign_ref(x: torch.Tensor, codebooks: Sequence[torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, d); codebooks list of (n_l, d).

    Returns (codes (B, L) int32, recon (B, d) float32).  Ties go to the
    lowest index (``torch.argmin`` returns the first minimum).
    """
    resid = x.to(torch.float32)
    recon = torch.zeros_like(resid)
    codes = []
    for C in codebooks:
        C = C.to(torch.float32)
        d2 = ((resid * resid).sum(1, keepdim=True)
              - 2.0 * (resid @ C.T) + (C * C).sum(1)[None, :])
        k = torch.argmin(d2, dim=1)
        sel = C[k]
        resid = resid - sel
        recon = recon + sel
        codes.append(k.to(torch.int32))
    return torch.stack(codes, dim=1), recon
