"""Public op: fused PPR walk + first-occurrence visit counts.

The path follows the tensors' device: CUDA tensors launch the CUDA
kernel (or raise), CPU tensors take the plain version.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.ppr_walk.ppr_walk import (WalkLayout,
                                                   ppr_walk as ppr_walk_kernel,
                                                   walk_layout)
from repro_torch.kernels.ppr_walk.ref import last_valid_cols, ppr_walk_ref


def ppr_walk(nbrs: torch.Tensor, cum: torch.Tensor, starts: torch.Tensor,
             uniforms: torch.Tensor, *, restart: float,
             last: Optional[torch.Tensor] = None,
             layout: Optional[WalkLayout] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Monte-Carlo PPR steps + per-start visit counts in one pass.

    ``nbrs``/``cum`` (N, D2) padded adjacency (unified id space),
    ``starts`` (n,) start ids, ``uniforms`` (n, n_walks, 2*walk_len) f32
    (the shared stream of ``core.ppr.walk_uniforms``), ``last`` the
    optional precomputed ``last_valid_cols(cum)`` and ``layout`` the
    optional precomputed ``walk_layout(nbrs, cum, last)`` the kernel
    reads (pass both when walking the same adjacency chunk after chunk).
    Returns (visited, counts), each (n, n_walks*walk_len) int32 on
    ``nbrs``' device.
    """
    dev = nbrs.device
    if last is None:
        last = last_valid_cols(cum)
    if dev.type == "cuda":
        if layout is None:
            layout = walk_layout(nbrs, cum, last)
        return ppr_walk_kernel(
            layout, starts.to(dev, torch.int32).contiguous(),
            uniforms.to(dev, torch.float32).contiguous(), restart=restart)
    if dev.type == "cpu":
        return ppr_walk_ref(nbrs, cum, starts, uniforms, restart=restart,
                            last=last)
    raise ValueError(f"ppr_walk runs on cuda or cpu, not {dev}")
