"""Public EmbeddingBag op, differentiable (``EmbeddingBag``).

The path follows the tensors' device: on CUDA tensors the forward comes
from the forward kernel and the gradients from the backward kernel; on
CPU tensors both come from the plain versions in ``ref.py``.  Either
way the backward is ``repro/kernels/embedding_bag/ops.py::_bwd``'s:
a dense f32 segment-sum rounded once to the compute type, not autograd
through the gather.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.embedding_bag.embedding_bag import (
    embedding_bag_bwd, embedding_bag_fwd)
from repro_torch.kernels.embedding_bag.ref import (embedding_bag_bwd_ref,
                                                   embedding_bag_ref)


def _on_card(table: torch.Tensor) -> bool:
    dev = table.device.type
    if dev not in ("cuda", "cpu"):
        raise ValueError(f"embedding_bag runs on cuda or cpu, not "
                         f"{table.device}")
    return dev == "cuda"


class EmbeddingBag(torch.autograd.Function):
    """(table, ids, weights, mode, compute_dtype) -> (B, D) in the
    compute type; gradients for the table (in its type) and the
    weights."""

    @staticmethod
    def forward(ctx, table, ids, weights, mode: str,
                compute_dtype: torch.dtype):
        ctx.save_for_backward(table, ids, weights)
        ctx.mode, ctx.compute_dtype = mode, compute_dtype
        fwd = embedding_bag_fwd if _on_card(table) else embedding_bag_ref
        return fwd(table, ids, weights, mode, compute_dtype)

    @staticmethod
    def backward(ctx, g):
        table, ids, weights = ctx.saved_tensors
        g = g.to(ctx.compute_dtype).contiguous()
        want_table, _, want_w = ctx.needs_input_grad[:3]
        if _on_card(table):
            d_table, d_w = embedding_bag_bwd(
                g, table, ids, weights, ctx.mode, ctx.compute_dtype,
                table_grad=want_table, weight_grad=want_w)
        else:
            d_table, d_w = embedding_bag_bwd_ref(
                g, table, ids, weights, ctx.mode, ctx.compute_dtype)
        return (d_table if want_table else None, None,
                d_w if want_w else None, None, None)


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  weights: Optional[torch.Tensor] = None,
                  mode: str = "sum",
                  compute_dtype: Optional[torch.dtype] = None
                  ) -> torch.Tensor:
    """table (V, D), ids (B, L) int (-1 pad), weights (B, L) -> (B, D) in
    ``compute_dtype`` (default: the table's type)."""
    if _on_card(table):
        ids = ids.to(torch.int32).contiguous()
        if weights is not None:
            weights = weights.to(torch.float32).contiguous()
        table = table.contiguous()
    return EmbeddingBag.apply(table, ids, weights, mode,
                              compute_dtype or table.dtype)
