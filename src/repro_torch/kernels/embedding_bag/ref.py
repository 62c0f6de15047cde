"""Plain PyTorch EmbeddingBag, forward and backward: the readable spec
the CUDA kernels (``csrc/embedding_bag.cu``) are held against.

  * ``embedding_bag_ref``: per bag, the weighted sum (or mean over the
    valid entries) of table rows, ids < 0 as padding, as
    ``repro/kernels/embedding_bag/ref.py::embedding_bag_ref`` and the
    Pallas kernel compute it: f32 accumulation, one rounding to the
    compute type at the end;
  * ``embedding_bag_bwd_ref``: what ``repro/kernels/embedding_bag/
    ops.py::_bwd`` returns: the dense segment-sum of the weighted
    upstream gradient into the table (f32, rounded once to the compute
    type, returned in the table's type) and, with weights, d weights.

``compute_dtype`` stands for the JAX model path's
``tables.astype(compute)`` before the op: rows are gathered in the
stored type and rounded to the compute type after the gather, which
gives the same values (the cast is elementwise) without casting the
whole table.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _weights(ids: torch.Tensor, weights: Optional[torch.Tensor]):
    """(mask, w): w = 1{ids >= 0} * weights in f32."""
    mask = ids >= 0
    w = mask.to(torch.float32)
    if weights is not None:
        w = w * weights.to(torch.float32)
    return mask, w


def _rows(table: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor,
          compute_dtype: torch.dtype) -> torch.Tensor:
    """(B, L, D) f32 rows, padding read as row 0, rounded through the
    compute type."""
    safe = torch.where(mask, ids, 0).long()
    return table[safe].to(compute_dtype).to(torch.float32)


def _count(w: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(w.sum(dim=1, keepdim=True), 1e-9)


def embedding_bag_ref(table: torch.Tensor, ids: torch.Tensor,
                      weights: Optional[torch.Tensor] = None,
                      mode: str = "sum",
                      compute_dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    """table (V, D), ids (B, L) int (-1 = pad), weights (B, L) optional.
    Returns (B, D) in ``compute_dtype`` (default: the table's type)."""
    compute_dtype = compute_dtype or table.dtype
    mask, w = _weights(ids, weights)
    out = (_rows(table, ids, mask, compute_dtype) * w[..., None]).sum(dim=1)
    if mode == "mean":
        out = out / _count(w)
    return out.to(compute_dtype)


def embedding_bag_bwd_ref(g: torch.Tensor, table: torch.Tensor,
                          ids: torch.Tensor,
                          weights: Optional[torch.Tensor] = None,
                          mode: str = "sum",
                          compute_dtype: Optional[torch.dtype] = None
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Cotangent ``g`` (B, D) of the output -> (d_table (V, D) in the
    table's type, d_weights (B, L) in the weights' type or None).

    d_table[v] = sum over (b, l) with ids[b, l] = v of g[b] * w_eff[b, l]
    (w_eff = w, or w / cnt in mean mode), summed in f32 and rounded once
    to the compute type; d_weights[b, l] = g[b] . row (sum) or
    g[b] . (row - out[b]) / cnt (mean), 0 at padding."""
    compute_dtype = compute_dtype or table.dtype
    V, D = table.shape
    B, L = ids.shape
    mask, w = _weights(ids, weights)
    cnt = _count(w)
    w_eff = w / cnt if mode == "mean" else w
    g32 = g.to(torch.float32)
    contrib = (g32[:, None, :] * w_eff[:, :, None]).reshape(B * L, D)
    flat = torch.where(mask, ids, V).reshape(-1).long()   # pads -> row V
    dtab = torch.zeros((V + 1, D), dtype=torch.float32, device=g.device)
    dtab.index_add_(0, flat, contrib)
    d_table = dtab[:V].to(compute_dtype).to(table.dtype)
    if weights is None:
        return d_table, None
    rows = _rows(table, ids, mask, compute_dtype)
    if mode == "mean":
        out = (rows * w_eff[..., None]).sum(dim=1)
        dw = torch.einsum("bd,bld->bl", g32,
                          (rows - out[:, None, :]) / cnt[..., None])
    else:
        dw = torch.einsum("bd,bld->bl", g32, rows)
    return d_table, (dw * mask).to(weights.dtype)
