"""RankGraph-2 model (paper §4.3, Figure 2B), as ``repro/core/model.py``.

Multi-head type-aware feature encoders ``f_U``, ``f_I`` + heterogeneous
aggregator ``AGG_t`` over exactly K pre-computed user and item
neighbours (Eq. 4).  Parameters live in ``cfg.param_dtype``; activations
are cast to ``cfg.dtype`` where the JAX package casts (the encoder
input, and every parameter to its input's type).  Heads are averaged
and l2-normalised at inference.

Under a mesh (``ctx``, a ``ShardingCtx`` over a ``DeviceMesh``) the
reference's specs split the encoders' hidden layer over ``mlp`` and
the aggregators over ``heads`` (``param_specs``; ``param_layout`` lays
them out under the rules, a dim the axis does not divide whole, and
``shard_params`` cuts a rank's shards).  A rank then runs them as
manual SPMD over its model group (``distributed.collectives``'
tensor-parallel pair): the encoder's ``l1`` split by columns (its bias
too), GELU on the shard, ``l2`` by rows, its partial outputs summed
over the group before ``l2``'s bias, which every rank holds whole; the
aggregator takes this rank's heads of its inputs, applies its heads'
``w`` and ``b`` and gathers the heads back, so its output is whole on
every rank of the group, as the reference's constraint ``(batch, None,
None)`` leaves it.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import RankGraph2Config
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import (ShardingCtx, mesh_sizes,
                                              param_spec, shard_of,
                                              spec_groups)
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

    def forward(self, x: torch.Tensor, group=None) -> torch.Tensor:
        """``group``: the model group ``l1``'s columns and ``l2``'s rows
        are split over (module docstring)."""
        if group is None:
            h = nn.linear(self.l2, gelu(nn.linear(self.l1, x)))
        else:
            h = gelu(nn.linear(self.l1, C.enter_split(x, group)))
            h = C.leave_split(nn.mm_f32(h, self.l2.weight.to(h.dtype).T),
                              group)
            h = (h + self.l2.bias.to(h.dtype)).to(x.dtype)
        return h.reshape(*x.shape[:-1], self.n_heads, self.d_embed)


class Aggregator(torch.nn.Module):
    """AGG_t: per-head combine of [self, user-nbr-mean, item-nbr-mean],
    ``w`` (H, 3d, d), ``b`` (H, d); output l2-normalised per head."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = torch.nn.Parameter(w)
        self.b = torch.nn.Parameter(b)

    def forward(self, self_e, unbr_e, inbr_e, group=None) -> torch.Tensor:
        """``group``: the model group the heads are split over (module
        docstring)."""
        if group is not None:
            self_e, unbr_e, inbr_e = (C.split_of(e, 1, group)
                                      for e in (self_e, unbr_e, inbr_e))
        x = torch.cat([self_e, unbr_e, inbr_e], dim=-1)        # (B,H,3d)
        y = torch.einsum("bhk,hkd->bhd", x, self.w.to(x.dtype))
        y = y + self.b.to(x.dtype)
        y = nn.l2_normalize(gelu(y), dim=-1)
        return y if group is None else C.gather_split(y, 1, group)


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


def param_specs(cfg: RankGraph2Config) -> Dict[str, Tuple[tuple, tuple]]:
    """Name (``named_parameters``') -> (shape, logical spec) of the
    encoders' and aggregators' parameters: the reference's specs
    (``_encoder_init``: ``l1`` ``(embed, mlp)``, ``l2`` ``(mlp,
    heads_embed)``; ``_agg_init``: ``w`` ``(heads, None, embed)``, ``b``
    ``(heads, embed)``) in the port's layout (a linear weight ``(d_out,
    d_in)``)."""
    out = {}
    for f, d_in in (("f_user", cfg.d_user_feat), ("f_item", cfg.d_item_feat)):
        he = cfg.n_heads * cfg.d_embed
        out.update({f"{f}.l1.weight": ((cfg.d_hidden, d_in), ("mlp", "embed")),
                    f"{f}.l1.bias": ((cfg.d_hidden,), ("mlp",)),
                    f"{f}.l2.weight": ((he, cfg.d_hidden),
                                       ("heads_embed", "mlp")),
                    f"{f}.l2.bias": ((he,), ("heads_embed",))})
    H, d = cfg.n_heads, cfg.d_embed
    for a in ("agg_user", "agg_item"):
        out[f"{a}.w"] = ((H, 3 * d, d), ("heads", None, "embed"))
        out[f"{a}.b"] = ((H, d), ("heads", "embed"))
    return out


def param_layout(cfg: RankGraph2Config, ctx: Optional[ShardingCtx]
                 ) -> Dict[str, tuple]:
    """Each of ``param_specs``' parameters' spec under ``ctx``
    (``param_spec``); empty with no mesh."""
    if ctx is None or ctx.mesh is None:
        return {}
    sizes = mesh_sizes(ctx.mesh)
    return {k: param_spec(logical, ctx.rules, shape, sizes)
            for k, (shape, logical) in param_specs(cfg).items()}


def shard_groups(cfg: RankGraph2Config, ctx: Optional[ShardingCtx]
                 ) -> Dict[str, Tuple[Any, ...]]:
    """Name -> for each dim, the process group it is split over (None
    where whole), for each parameter split over axes of more than one
    rank (``optim.optimizers``' ``shards``)."""
    groups = {k: spec_groups(spec, ctx)
              for k, spec in param_layout(cfg, ctx).items()}
    return {k: g for k, g in groups.items() if any(x is not None for x in g)}


def shard_tensor(name: str, x: torch.Tensor, cfg: RankGraph2Config,
                 ctx: Optional[ShardingCtx]) -> torch.Tensor:
    """This rank's block of parameter ``name`` (or of a tensor laid out
    as it, an optimizer's moment) held whole in ``x``."""
    return shard_of(x, param_layout(cfg, ctx).get(name, ()), ctx)


@torch.no_grad()
def shard_params(params: torch.nn.ModuleDict, cfg: RankGraph2Config,
                 ctx: Optional[ShardingCtx]) -> torch.nn.ModuleDict:
    """Replace each split parameter of ``params`` (whole) by this rank's
    block, in place (new ``Parameter``s, with the old ones'
    ``requires_grad``); returns ``params``."""
    for name in param_layout(cfg, ctx):
        mod_name, attr = name.rsplit(".", 1)
        mod = params.get_submodule(mod_name)
        old = getattr(mod, attr)
        setattr(mod, attr, torch.nn.Parameter(
            shard_tensor(name, old.detach(), cfg, ctx),
            requires_grad=old.requires_grad))
    return params


def model_group(cfg: RankGraph2Config, ctx: Optional[ShardingCtx],
                logical: str):
    """The process group the encoders' hidden layer (``"mlp"``) or the
    aggregators' heads (``"heads"``) are split over under ``ctx``, None
    where a rank holds them whole."""
    name = {"mlp": "f_user.l1.bias", "heads": "agg_user.b"}[logical]
    spec = param_layout(cfg, ctx).get(name, (None,))
    if spec[0] is None:
        return None
    axes = (spec[0],) if isinstance(spec[0], str) else tuple(spec[0])
    return ctx.group(axes) if ctx.size(axes) > 1 else None


def _masked_mean(e: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """e: (B, K, H, d), mask: (B, K) -> (B, H, d)"""
    m = mask.to(e.dtype)[:, :, None, None]
    tot = (e * m).sum(dim=1)
    cnt = torch.clamp_min(m.sum(dim=1), 1.0)
    return tot / cnt


def encode_nodes(params, cfg: RankGraph2Config, node_type: int,
                 feat: torch.Tensor, ctx: Optional[ShardingCtx] = None
                 ) -> torch.Tensor:
    """Type encoder f_t only: (..., d_feat) -> (..., H, d_embed); under
    ``ctx`` split over ``mlp`` where the layout splits it (module
    docstring), the output whole on every rank."""
    f = params["f_user"] if node_type == USER else params["f_item"]
    return f(feat.to(DTYPES[cfg.dtype]), model_group(cfg, ctx, "mlp"))


def aggregate_nodes(params, cfg: RankGraph2Config, node_type: int,
                    self_e, unbr_e, unbr_mask, inbr_e, inbr_mask,
                    ctx: Optional[ShardingCtx] = None) -> torch.Tensor:
    """AGG_t over pre-encoded heads: self_e (B, H, d), neighbour heads
    (B, K, H, d) + masks -> (B, H, d) l2-normalised; under ``ctx`` split
    over ``heads`` where the layout splits them, the output whole on
    every rank."""
    agg = params["agg_user"] if node_type == USER else params["agg_item"]
    return agg(self_e, _masked_mean(unbr_e, unbr_mask),
               _masked_mean(inbr_e, inbr_mask),
               model_group(cfg, ctx, "heads"))


def embed_nodes(params, cfg: RankGraph2Config, node_type: int,
                feat, unbr_feat, unbr_mask, inbr_feat, inbr_mask,
                ctx: Optional[ShardingCtx] = None) -> torch.Tensor:
    """Eq. 4.  Per-head embeddings (B, H, d_embed), l2-normalised.

    feat: (B, d_feat) raw features of the node itself; unbr_feat /
    inbr_feat: (B, K, d_*) features of its user / item neighbours, with
    masks flagging padding."""
    self_e = encode_nodes(params, cfg, node_type, feat, ctx)
    u_e = encode_nodes(params, cfg, USER, unbr_feat, ctx)
    i_e = encode_nodes(params, cfg, ITEM, inbr_feat, ctx)
    return aggregate_nodes(params, cfg, node_type, self_e, u_e, unbr_mask,
                           i_e, inbr_mask, ctx)


def primary_embedding(head_emb: torch.Tensor) -> torch.Tensor:
    """Inference embedding = l2-normalised mean over heads."""
    return nn.l2_normalize(head_emb.mean(dim=-2), dim=-1)


def embed_side(params, cfg: RankGraph2Config, side: Dict[str, torch.Tensor],
               node_type: int, ctx: Optional[ShardingCtx] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(heads (B, H, d), primary (B, d)) for one sub-batch with keys
    feat / unbr_feat / unbr_mask / inbr_feat / inbr_mask."""
    heads = embed_nodes(params, cfg, node_type, side["feat"],
                        side["unbr_feat"], side["unbr_mask"],
                        side["inbr_feat"], side["inbr_mask"], ctx)
    return heads, primary_embedding(heads)
