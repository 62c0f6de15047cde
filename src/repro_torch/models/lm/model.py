"""The LM family on one card, dense and MoE, as the single-device path of
``repro/models/lm/model.py``.

  olmo-1b      non-parametric LayerNorm, SwiGLU, no grouping
  llama3.2-3b  RMSNorm, SwiGLU, GQA (kv 8)
  gemma-2b     RMSNorm(+1), GeGLU, MQA (kv 1), head_dim 256, sqrt(d)
               embedding scaling, tied head
  grok-1-314b  MoE, 8 experts top-2 (GeGLU, expert ff 32,768), GQA (kv 8)
  kimi-k2      MoE, 384 experts top-8 (SwiGLU, expert ff 2,048), GQA
               (kv 8), head dim 112

Parameters are the JAX package's tree in its layout (``x @ w``):
``embed`` (V, d), ``final_norm`` (d,), ``lm_head`` (d, V) unless tied,
and ``layers``, a list with one dict per layer (``wq`` (d, H*hd), ``wk``
and ``wv`` (d, Hkv*hd), ``wo`` (H*hd, d), ``w_gate`` / ``w_up`` (d, ff),
``w_down`` (ff, d), and ``ln1`` / ``ln2`` (d,) except under OLMo's
non-parametric norm; an MoE layer has ``router`` (d, E) and expert
weights ``w_gate`` / ``w_up`` (E, d, ff) and ``w_down`` (E, ff, d)
instead).  Every matrix is cast to the compute type where it
is used (``x @ w.to(x.dtype)``), as the reference does.  The final norm
is RMSNorm for every config, as in the reference (``model.py:524``).

Attention goes through ``kernels.flash_attention.ops.chunked_attention``:
the CUDA flash-attention kernel on the card, ``_chunked_attention``'s
plain loop on the CPU.  ``lm_loss`` trains through it: under autograd the
card's attention is ``FlashAttention`` (the forward saves each row's
logsumexp, the backward is the hand-written kernel), and with
``cfg.remat`` each layer runs under ``torch.utils.checkpoint``
(``use_reentrant=False``), as the reference's ``jax.checkpoint``;
``named_params`` gives the flat ``name -> tensor`` view that the
optimizers of ``optim/optimizers.py`` update in place.

KV caches are dicts ``{"k", "v"}`` of ``(L, B, T, Hkv, hd)`` tensors.
Two departures from the reference that keep its values and save memory:
``decode_step`` writes the new keys and values into the caches in place
(the reference's ``dynamic_update_slice`` builds new arrays), and
``prefill`` applies the final norm and the head to the last position
only (the reference computes logits for every position and keeps the
last: 8.4 GB of bf16 logits at llama's 32k).  ``forward`` keeps every
position.

An MoE layer routes each token to its top-k experts (``_router``: a
softmax over the router's logits in f32, top-k with the lower index first
among equal probabilities, as ``jax.lax.top_k``, gates renormalised, the
Switch load-balancing term as aux) and dispatches by capacity
(``_moe_scatter``: each expert takes at most ``max(int(k T / E *
capacity_factor) + 1, 8)`` of the T tokens' slots, in slot order; the
rest are dropped).  With no mesh the reference's ``_moe_block`` always
takes that path, and so does this one; ``_moe_dense`` (every expert over
every token, gate-masked) is its small-E alternative, kept as a function.
``lm_loss`` adds the layers' aux terms; ``forward``, ``prefill`` and
``decode_step`` drop them.  Expert parallelism over a mesh
(``_moe_shard_map``) is not ported.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LMConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.flash_attention.ops import chunked_attention
from repro_torch.nn import core as nn

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
Params = Dict[str, Any]
Caches = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (B, S, H, D), positions (B, S); rotation in f32, back to x's
    type."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].to(torch.float32) * freqs      # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------

def _layer_init(g: torch.Generator, cfg: LMConfig, dtype: torch.dtype,
                device) -> Dict[str, torch.Tensor]:
    hd = cfg.resolved_head_dim
    d, ff = cfg.d_model, cfg.d_ff
    init = nn.variance_scaling(1.0, "fan_in", "normal")

    def w(*shape):
        return init(g, shape, dtype, device=device)
    p = {"wq": w(d, cfg.n_heads * hd), "wk": w(d, cfg.n_kv_heads * hd),
         "wv": w(d, cfg.n_kv_heads * hd), "wo": w(cfg.n_heads * hd, d)}
    if cfg.norm != "layernorm_np":     # olmo: non-parametric -> no params
        fill = 0.0 if cfg.norm == "rmsnorm_p1" else 1.0
        p["ln1"] = torch.full((d,), fill, dtype=dtype, device=device)
        p["ln2"] = torch.full((d,), fill, dtype=dtype, device=device)
    if cfg.n_experts:
        E, ff = cfg.n_experts, cfg.moe_d_ff or cfg.d_ff
        p["router"] = w(d, E)
        p["w_gate"], p["w_up"] = (init(g, (E, d, ff), dtype, in_axes=(1,),
                                       out_axes=(2,), device=device)
                                  for _ in range(2))
        p["w_down"] = init(g, (E, ff, d), dtype, in_axes=(1,),
                           out_axes=(2,), device=device)
    else:
        p["w_gate"], p["w_up"], p["w_down"] = w(d, ff), w(d, ff), w(ff, d)
    return p


def init_params(cfg: LMConfig, *, generator: Optional[torch.Generator] = None,
                device=None) -> Params:
    """Random parameters in ``cfg.param_dtype`` on ``device``, drawn from
    ``generator`` (which must live there; by default one seeded 0):
    fan-in normal matrices, N(0, 1) * 0.02 embeddings and head, norms at
    their identity.  The values differ from the JAX package's draws."""
    dev = resolve_device(device)
    g = generator or torch.Generator(dev).manual_seed(0)
    if g.device.type != dev.type:
        raise ValueError(f"generator on {g.device}, parameters on {dev}: "
                         f"draw them where they live")
    dtype = DTYPES[cfg.param_dtype]

    def normal(*shape):
        return torch.empty(shape, dtype=dtype, device=dev).normal_(
            0.0, 1.0, generator=g).mul_(0.02)
    params = {"embed": normal(cfg.vocab_size, cfg.d_model),
              "layers": [_layer_init(g, cfg, dtype, dev)
                         for _ in range(cfg.n_layers)],
              "final_norm": torch.ones(cfg.d_model, dtype=dtype, device=dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal(cfg.d_model, cfg.vocab_size)
    return params


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def _norm(cfg: LMConfig, x: torch.Tensor,
          scale: Optional[torch.Tensor]) -> torch.Tensor:
    if cfg.norm == "layernorm_np":
        return nn.layernorm_apply(x)
    return nn.rmsnorm_apply(scale, x, plus_one=cfg.norm == "rmsnorm_p1")


def _act(cfg: LMConfig, g: torch.Tensor) -> torch.Tensor:
    """SiLU, or GELU in its tanh form (``jax.nn.gelu``'s default)."""
    return F.silu(g) if cfg.act == "silu" else F.gelu(g, approximate="tanh")


def _dense_mlp(p, cfg: LMConfig, x: torch.Tensor) -> torch.Tensor:
    g = x @ p["w_gate"].to(x.dtype)
    u = x @ p["w_up"].to(x.dtype)
    return (_act(cfg, g) * u) @ p["w_down"].to(x.dtype)


# ---------------------------------------------------------------------------
# mixture of experts
# ---------------------------------------------------------------------------

def _router(p, cfg: LMConfig, xt: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xt (T, d) -> (gate (T, k) f32, expert ids (T, k), aux () f32).  The
    top k of each token's probabilities in descending order, the lower
    index first among equal ones (``jax.lax.top_k``'s order: a stable
    descending sort cut at k; ``torch.topk`` promises none), renormalised;
    aux is the Switch term ``E * sum_e f_e p_e * router_aux_coef``."""
    E, k = cfg.n_experts, cfg.n_experts_per_tok
    T = xt.shape[0]
    if k > E:
        raise ValueError(f"k argument to top_k must be no larger than size "
                         f"along axis; got k={k} with {E} experts")
    logits = (xt @ p["router"].to(xt.dtype)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eid = srt.values[:, :k], srt.indices[:, :k]
    gate = gate / torch.clamp_min(torch.sum(gate, dim=-1, keepdim=True),
                                  1e-9)
    me = torch.mean(probs, dim=0)
    ce = torch.bincount(eid.reshape(-1), minlength=E).to(torch.float32) \
        / (T * k)
    aux = E * torch.sum(me * ce) * cfg.router_aux_coef
    return gate, eid, aux


def _pos_in_group(flat_e: torch.Tensor) -> torch.Tensor:
    """Rank of each slot within its expert's group, in slot order (int32):
    a stable argsort, then each slot's distance from its group's start."""
    n = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    start = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank = (torch.arange(n, device=flat_e.device) - start).to(torch.int32)
    return torch.empty_like(rank).index_put_((order,), rank)


def moe_capacity(cfg: LMConfig, T: int) -> int:
    """Slots an expert takes of T tokens' (``_moe_scatter``), formed in
    Python floats as the reference forms it."""
    k, E = cfg.n_experts_per_tok, cfg.n_experts
    return max(int(k * T / E * cfg.capacity_factor) + 1, 8)


def _moe_scatter(p, cfg: LMConfig, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity dispatch, x (B, S, d) -> (out, aux): the T k slots (token
    t's j-th choice is slot t k + j) fill an (E, cap, d) buffer in slot
    order; a slot past its expert's capacity is dropped (it adds zeros at
    (E - 1, cap - 1), as the reference's scatter does); the experts' GLU
    runs as batched products over the buffer; each token sums its kept
    slots' outputs weighted by their gates."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.n_experts_per_tok
    T = B * S
    xt = x.reshape(T, d)
    gate, eid, aux = _router(p, cfg, xt)
    flat_e = eid.reshape(-1)
    pos = _pos_in_group(flat_e).long()
    cap = moe_capacity(cfg, T)
    keep = pos < cap
    src = torch.repeat_interleave(xt, k, dim=0) * keep[:, None].to(x.dtype)
    buf = torch.zeros((E, cap, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((torch.where(keep, flat_e, E - 1),
                         torch.where(keep, pos, cap - 1)), src,
                        accumulate=True)
    del src
    g = torch.bmm(buf, p["w_gate"].to(x.dtype))
    u = torch.bmm(buf, p["w_up"].to(x.dtype))
    eout = torch.bmm(_act(cfg, g) * u, p["w_down"].to(x.dtype))
    del g, u
    got = eout[torch.where(keep, flat_e, 0), torch.where(keep, pos, 0)]
    got = got * (keep[:, None].to(torch.float32)
                 * gate.reshape(-1)[:, None]).to(x.dtype)
    return torch.sum(got.reshape(T, k, d), dim=1).reshape(B, S, d), aux


def _moe_dense(p, cfg: LMConfig, x: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every expert over every token, weighted by a (T, E) gate mask (zero
    off each token's top k): no capacity, nothing dropped; E / k times
    the products of ``_moe_scatter``."""
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    gate, eid, aux = _router(p, cfg, xt)
    w = torch.zeros((T, cfg.n_experts), dtype=x.dtype, device=x.device
                    ).scatter_add(1, eid, gate.to(x.dtype))
    out = torch.zeros_like(xt)
    for e in range(cfg.n_experts):
        g = xt @ p["w_gate"][e].to(x.dtype)
        u = xt @ p["w_up"][e].to(x.dtype)
        out = out + ((_act(cfg, g) * u) @ p["w_down"][e].to(x.dtype)
                     ) * w[:, e:e + 1]
    return out.reshape(B, S, d), aux


def _moe_block(p, cfg: LMConfig, x: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-choice top-k MoE.  Without a mesh the reference's dispatch
    always takes the capacity scatter; so does the port's (its
    shard_map expert parallelism and its dense loop choose by mesh
    axes)."""
    return _moe_scatter(p, cfg, x)


def _attn_block(p, cfg: LMConfig, x: torch.Tensor, positions: torch.Tensor,
                kv: Optional[Tuple[torch.Tensor, torch.Tensor]],
                cache_len: int, causal: bool, block_q: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (out, k, v).  ``kv``: None (prefill from scratch) or one
    layer's caches (B, T, Hkv, hd), into which the new keys and values
    are written at ``cache_len`` (in place) before attending over the
    first ``cache_len + S`` positions."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    q = (x @ p["wq"].to(x.dtype)).reshape(B, S, H, hd)
    k = (x @ p["wk"].to(x.dtype)).reshape(B, S, Hkv, hd)
    v = (x @ p["wv"].to(x.dtype)).reshape(B, S, Hkv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if kv is not None:
        ck, cv = kv
        if cache_len + S > ck.shape[1]:
            raise ValueError(f"cache of {ck.shape[1]} positions cannot take "
                             f"{S} more at {cache_len}")
        ck[:, cache_len:cache_len + S] = k.to(ck.dtype)
        cv[:, cache_len:cache_len + S] = v.to(cv.dtype)
        out = chunked_attention(q, ck, cv, causal=False, q_offset=0,
                                kv_len=cache_len + S, block_q=block_q,
                                scale=hd ** -0.5)
        k, v = ck, cv
    else:
        out = chunked_attention(q, k, v, causal=causal, q_offset=0,
                                kv_len=None, block_q=block_q,
                                scale=hd ** -0.5)
    return out.reshape(B, S, H * hd) @ p["wo"].to(x.dtype), k, v


def _layer(p, cfg: LMConfig, x, positions, kv, cache_len, causal, block_q):
    """Returns (x, k, v, aux): aux the MoE load-balancing term, None for a
    dense layer (the reference's 0.0, which adds nothing)."""
    h = _norm(cfg, x, p.get("ln1"))
    attn, k, v = _attn_block(p, cfg, h, positions, kv, cache_len, causal,
                             block_q)
    x = x + attn
    h = _norm(cfg, x, p.get("ln2"))
    if cfg.n_experts:
        mlp, aux = _moe_block(p, cfg, h)
        return x + mlp, k, v, aux
    return x + _dense_mlp(p, cfg, h), k, v, None


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def _trunk(params: Params, cfg: LMConfig, tokens: torch.Tensor, *,
           positions: Optional[torch.Tensor], kv_caches: Optional[Caches],
           cache_len: int, causal: bool, block_q: int, keep_cache: bool,
           remat: bool = False
           ) -> Tuple[torch.Tensor, Optional[Caches], Optional[torch.Tensor]]:
    """tokens (B, S) -> (residual stream after the last layer (B, S, d),
    caches, aux): the given ``kv_caches`` (written in place), or with
    ``keep_cache`` new (L, B, S, Hkv, hd) ones in the compute type; aux
    the sum of the MoE layers' terms in layer order (None for a dense
    config).  With ``remat`` (no caches) each layer keeps only its input
    for the backward and runs again there."""
    compute = DTYPES[cfg.dtype]
    B, S = tokens.shape
    dev = tokens.device
    if positions is None:
        positions = torch.arange(S, device=dev)[None, :].expand(B, S)
    x = params["embed"][tokens].to(compute)
    if cfg.norm == "rmsnorm_p1":     # gemma scales embeddings by sqrt(d)
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=compute)
    caches = kv_caches
    if kv_caches is None and keep_cache:
        shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.resolved_head_dim)
        caches = {n: torch.empty(shape, dtype=compute, device=dev)
                  for n in ("k", "v")}
    aux = None
    for i, lp in enumerate(params["layers"]):
        kv = None if kv_caches is None else (kv_caches["k"][i],
                                             kv_caches["v"][i])
        if remat and kv is None and not keep_cache:
            x, a = checkpoint(lambda x_, lp_: _layer(
                lp_, cfg, x_, positions, None, cache_len, causal,
                block_q)[::3], x, lp, use_reentrant=False)
        else:
            x, k, v, a = _layer(lp, cfg, x, positions, kv, cache_len,
                                causal, block_q)
            if kv_caches is None and keep_cache:
                caches["k"][i] = k
                caches["v"][i] = v
        if a is not None:
            aux = a if aux is None else aux + a
    return x, caches, aux


def _head(params: Params, cfg: LMConfig, x: torch.Tensor) -> torch.Tensor:
    x = nn.rmsnorm_apply(params["final_norm"], x)
    head = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    return x @ head.to(x.dtype)


def forward(params: Params, cfg: LMConfig, tokens: torch.Tensor, *,
            block_q: int = 1024) -> torch.Tensor:
    """tokens (B, S) -> causal logits (B, S, V) in the compute type, for
    every position (``prefill`` and ``decode_step`` serve; the reference's
    cache options of ``forward`` live there).  An MoE config's aux term is
    ``lm_loss``'s: the logits are all this returns."""
    x, _, _ = _trunk(params, cfg, tokens, positions=None, kv_caches=None,
                  cache_len=0, causal=True, block_q=block_q,
                  keep_cache=False)
    return _head(params, cfg, x)


def lm_loss(params: Params, cfg: LMConfig, tokens: torch.Tensor, *,
            block_q: int = 1024) -> torch.Tensor:
    """Next-token cross-entropy of tokens (B, S), as the reference's
    ``lm_loss`` (``repro/models/lm/model.py:534``): causal logits in the
    compute type, positions ``[:-1]`` in f32, the mean of logsumexp minus
    the gold logit, plus the MoE layers' aux terms (a dense config's is 0
    and is not added).  Each layer is rematerialised under ``cfg.remat``
    when grad mode is on."""
    x, _, aux = _trunk(params, cfg, tokens, positions=None, kv_caches=None,
                       cache_len=0, causal=True, block_q=block_q,
                       keep_cache=False,
                       remat=cfg.remat and torch.is_grad_enabled())
    lg = _head(params, cfg, x)[:, :-1].to(torch.float32)
    gold = torch.gather(lg, -1, tokens[:, 1:, None].long())[..., 0]
    loss = torch.mean(torch.logsumexp(lg, dim=-1) - gold)
    return loss if aux is None else loss + aux


def named_params(params: Params) -> Dict[str, torch.Tensor]:
    """The parameters as a flat ``name -> tensor`` dict of the same
    tensors (``layers.<i>.<name>`` for a layer's), for the optimizers."""
    flat = {k: v for k, v in params.items() if k != "layers"}
    for i, lp in enumerate(params["layers"]):
        flat.update({f"layers.{i}.{k}": v for k, v in lp.items()})
    return flat


def init_kv_cache(cfg: LMConfig, batch: int, max_len: int, dtype=None,
                  device=None) -> Caches:
    """Zeroed (L, B, T, Hkv, hd) caches in ``dtype`` (default: the compute
    type) on ``device``."""
    dtype = dtype or DTYPES[cfg.dtype]
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    dev = resolve_device(device)
    return {n: torch.zeros(shape, dtype=dtype, device=dev)
            for n in ("k", "v")}


def decode_step(params: Params, cfg: LMConfig, tokens: torch.Tensor,
                kv_caches: Caches, cache_len: int
                ) -> Tuple[torch.Tensor, Caches]:
    """One decode step: tokens (B, 1) against caches filled to
    ``cache_len``.  Writes the step's keys and values into the caches in
    place at ``cache_len``; returns (logits (B, V), the caches)."""
    B = tokens.shape[0]
    positions = torch.full((B, 1), cache_len, dtype=torch.int64,
                           device=tokens.device)
    x, caches, _ = _trunk(params, cfg, tokens, positions=positions,
                          kv_caches=kv_caches, cache_len=cache_len,
                          causal=False, block_q=1, keep_cache=True)
    return _head(params, cfg, x[:, -1]), caches


def prefill(params: Params, cfg: LMConfig, tokens: torch.Tensor, *,
            block_q: int = 1024) -> Tuple[torch.Tensor, Caches]:
    """Prefill: returns (last-position logits (B, V), caches (L, B, S,
    Hkv, hd) in the compute type).  The head runs on the last position
    only."""
    x, caches, _ = _trunk(params, cfg, tokens, positions=None,
                          kv_caches=None, cache_len=0, causal=True,
                          block_q=block_q, keep_cache=True)
    return _head(params, cfg, x[:, -1]), caches

