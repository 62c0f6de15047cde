"""RankGraph-2 model (paper §4.3, Figure 2B), as ``repro/core/model.py``.

Multi-head type-aware feature encoders ``f_U``, ``f_I`` + heterogeneous
aggregator ``AGG_t`` over exactly K pre-computed user and item
neighbours (Eq. 4).  Parameters live in ``cfg.param_dtype``; activations
are cast to ``cfg.dtype`` where the JAX package casts (the encoder
input, and every parameter to its input's type).  Heads are averaged
and l2-normalised at inference.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import RankGraph2Config
from repro_torch.kernels.common import resolve_device
from repro_torch.nn import core as nn

USER, ITEM = 0, 1

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class Encoder(torch.nn.Module):
    """Type encoder f_t: (..., d_in) -> (..., H, d_embed)."""

    def __init__(self, l1: torch.nn.Linear, l2: torch.nn.Linear,
                 n_heads: int, d_embed: int):
        super().__init__()
        self.l1, self.l2 = l1, l2
        self.n_heads, self.d_embed = n_heads, d_embed

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = nn.linear(self.l2, gelu(nn.linear(self.l1, x)))
        return h.reshape(*x.shape[:-1], self.n_heads, self.d_embed)


class Aggregator(torch.nn.Module):
    """AGG_t: per-head combine of [self, user-nbr-mean, item-nbr-mean],
    ``w`` (H, 3d, d), ``b`` (H, d); output l2-normalised per head."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = torch.nn.Parameter(w)
        self.b = torch.nn.Parameter(b)

    def forward(self, self_e, unbr_e, inbr_e) -> torch.Tensor:
        x = torch.cat([self_e, unbr_e, inbr_e], dim=-1)        # (B,H,3d)
        y = torch.einsum("bhk,hkd->bhd", x, self.w.to(x.dtype))
        y = y + self.b.to(x.dtype)
        return nn.l2_normalize(gelu(y), dim=-1)


def _encoder_init(g: torch.Generator, d_in: int, d_hidden: int,
                  n_heads: int, d_embed: int, dtype) -> Encoder:
    return Encoder(nn.linear_init(g, d_in, d_hidden, dtype=dtype),
                   nn.linear_init(g, d_hidden, n_heads * d_embed,
                                  dtype=dtype),
                   n_heads, d_embed)


def _agg_init(g: torch.Generator, n_heads: int, d_embed: int,
              dtype) -> Aggregator:
    w = nn.lecun_normal(g, (n_heads, 3 * d_embed, d_embed), dtype,
                        in_axes=(1,), out_axes=(2,))
    return Aggregator(w, torch.zeros((n_heads, d_embed), dtype=dtype))


def init_params(cfg: RankGraph2Config, *, generator: torch.Generator,
                device=None) -> torch.nn.ModuleDict:
    """Encoders and aggregators, keyed as the JAX params tree
    (``f_user``, ``f_item``, ``agg_user``, ``agg_item``), drawn from
    ``generator`` and moved to ``device``."""
    dtype = DTYPES[cfg.param_dtype]
    g = generator
    params = torch.nn.ModuleDict({
        "f_user": _encoder_init(g, cfg.d_user_feat, cfg.d_hidden,
                                cfg.n_heads, cfg.d_embed, dtype),
        "f_item": _encoder_init(g, cfg.d_item_feat, cfg.d_hidden,
                                cfg.n_heads, cfg.d_embed, dtype),
        "agg_user": _agg_init(g, cfg.n_heads, cfg.d_embed, dtype),
        "agg_item": _agg_init(g, cfg.n_heads, cfg.d_embed, dtype),
    })
    return params.to(resolve_device(device)).requires_grad_(False)


def _masked_mean(e: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """e: (B, K, H, d), mask: (B, K) -> (B, H, d)"""
    m = mask.to(e.dtype)[:, :, None, None]
    tot = (e * m).sum(dim=1)
    cnt = torch.clamp_min(m.sum(dim=1), 1.0)
    return tot / cnt


def encode_nodes(params, cfg: RankGraph2Config, node_type: int,
                 feat: torch.Tensor) -> torch.Tensor:
    """Type encoder f_t only: (..., d_feat) -> (..., H, d_embed)."""
    f = params["f_user"] if node_type == USER else params["f_item"]
    return f(feat.to(DTYPES[cfg.dtype]))


def aggregate_nodes(params, cfg: RankGraph2Config, node_type: int,
                    self_e, unbr_e, unbr_mask, inbr_e, inbr_mask
                    ) -> torch.Tensor:
    """AGG_t over pre-encoded heads: self_e (B, H, d), neighbour heads
    (B, K, H, d) + masks -> (B, H, d) l2-normalised."""
    agg = params["agg_user"] if node_type == USER else params["agg_item"]
    return agg(self_e, _masked_mean(unbr_e, unbr_mask),
               _masked_mean(inbr_e, inbr_mask))


def embed_nodes(params, cfg: RankGraph2Config, node_type: int,
                feat, unbr_feat, unbr_mask, inbr_feat, inbr_mask
                ) -> torch.Tensor:
    """Eq. 4.  Per-head embeddings (B, H, d_embed), l2-normalised.

    feat: (B, d_feat) raw features of the node itself; unbr_feat /
    inbr_feat: (B, K, d_*) features of its user / item neighbours, with
    masks flagging padding."""
    self_e = encode_nodes(params, cfg, node_type, feat)
    u_e = encode_nodes(params, cfg, USER, unbr_feat)
    i_e = encode_nodes(params, cfg, ITEM, inbr_feat)
    return aggregate_nodes(params, cfg, node_type, self_e, u_e, unbr_mask,
                           i_e, inbr_mask)


def primary_embedding(head_emb: torch.Tensor) -> torch.Tensor:
    """Inference embedding = l2-normalised mean over heads."""
    return nn.l2_normalize(head_emb.mean(dim=-2), dim=-1)


def embed_side(params, cfg: RankGraph2Config, side: Dict[str, torch.Tensor],
               node_type: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(heads (B, H, d), primary (B, d)) for one sub-batch with keys
    feat / unbr_feat / unbr_mask / inbr_feat / inbr_mask."""
    heads = embed_nodes(params, cfg, node_type, side["feat"],
                        side["unbr_feat"], side["unbr_mask"],
                        side["inbr_feat"], side["inbr_mask"])
    return heads, primary_embedding(heads)
