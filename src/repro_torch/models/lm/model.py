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
``decode_step`` drop them.

Under a mesh (``ctx``, a ``ShardingCtx`` over a ``DeviceMesh``) every
rank passes its own rows of the batch (``rank_rows``: the rows split
over the data axes, which the rules' ``batch`` must split; the ranks of
a model group hold the same rows) and its own shards of the parameters:
``param_specs`` are the reference's logical specs (``_layer_init``,
``init_params``), ``param_layout`` lays them out under the rules
(``distributed.sharding.param_spec``: FSDP splits ``embed`` over
``data``, expert parallelism ``expert`` over ``model``, tensor
parallelism ``heads``, ``kv_heads``, ``mlp``, ``vocab`` and
``expert_mlp`` over ``model``; a dim the axis does not divide stays
whole), and ``shard_params`` cuts a whole tree to a rank's shards. An
FSDP leaf is gathered over the data axes where it is used (``_w``; under
remat again in the backward), cast to the compute type before it is
sent where the product casts it; its gradient comes back
reduce-scattered.  Its model-axis dims stay local.

Tensor parallelism (manual SPMD, the collectives of
``distributed.collectives``' tensor-parallel pair): ``wq``, ``wk`` and
``wv`` are split by columns (a rank's ``H / nm`` query heads over its
``Hkv / nm`` KV heads, or over the KV heads they use where the axis
does not divide ``Hkv``: gemma-2b's one head), ``wo`` by rows; the
dense MLP's ``w_gate`` and ``w_up`` by columns, ``w_down`` by rows, and
grok's experts the same way over ``expert_mlp``.  A block's input enters
its split products by ``enter_split`` and its partial sums leave by
``leave_split``; in bf16 a row-split product gives its partial sums in
f32 (``nn.mm_f32``), which are summed over the model group in f32 and
rounded once, where the one-process product rounds its one f32 sum.
The embedding is split by rows: a rank looks up the tokens of its rows
(zeros elsewhere) and the model group sums them.  The head is split by
columns (tied: the embedding's rows): ``lm_loss`` takes each position's
logsumexp and gold logit over the model group in f32 (the maximum, then
the sum of the exponentials), and ``forward``, ``prefill`` and
``decode_step`` gather the whole vocabulary's logits on every rank.
Under the train rules (``seq -> model``) the residual between blocks is
the rank's ``S / nm`` positions (sequence parallelism, where ``nm``
divides ``S``): ``seq_gather`` before a block's split products,
``seq_scatter`` after them; a block that runs whole (its weights
unsplit) and the MoE block get the whole sequence (``_moe_shard_map``'s
``in_specs``) and keep the rank's block of their output.  A norm's
scale applied to the rank's positions enters by ``enter_split``, so its
gradient is the whole sequence's.  Under the prefill rules a rank's
caches are its own KV heads (``init_kv_cache(ctx=)``).

The decode rules keep heads whole and split the caches' sequence over
``kv_seq`` (``model``, or ``("data", "model")`` with the batch whole at a
global batch of 1: ``repro/launch/steps.py:162-169``): a rank holds
``(L, B_loc, T / n, Hkv, hd)``, block ``j`` of the positions, ``j`` its
coordinate along those axes with ``data`` the major one
(``shard_caches``, ``init_kv_cache(ctx=)``).  ``decode_step`` writes the
new key and value only into the block that holds ``cache_len``; each rank
attends over its block (``kernels.flash_attention.ops.
decode_attention_lse``: the decode kernel's f32 rows and each row's
logsumexp) and ``collectives.fold_seq`` folds the ranks' partials.
Departures: the reference forms the softmax over the sharded axis under
GSPMD; the port folds the ranks' f32 outputs by their lse in rank order
and rounds once, so an output may differ from the one-process one by the
order of the f32 sums.  A rank whose block holds no key yet does not
launch: its partial is out 0 and lse -inf, which weighs exactly 0.
Where the ``kv_seq`` ranks do not divide a cache's T positions, the
reference keeps it whole (``_safe``), and so does the port: every rank
holds the whole cache, writes the new key and value and attends over it
with no fold.  Which of the two a rank holds is read from the whole
cache's length, which ``init_kv_cache`` and ``shard_caches`` keep on the
caches they return (``KVCaches.positions``), never from the local
block's shape (a whole cache of T' positions and a block of T / n look
alike).  Moving from the prefill's caches
(by heads) to these blocks is the reference's cell boundary (``jit``
reshards), not a step of its own.

``_moe_block`` takes the reference's dispatch (``moe_dispatch``, its
conditions at ``repro/models/lm/model.py:357-369``): ``_moe_shard_map``
(each model rank routes its ``1 / nm`` of the tokens, packs an ``(nm,
E_loc, cap, d)`` buffer, two ``all_to_all``s over the model group run
its own ``E / nm`` experts, an ``all_gather`` puts the slices back, aux
is ``pmean``ed), then ``_moe_dense`` when ``E <= 16`` and a data rank
has 1,024 tokens or more, else ``_moe_scatter``; these two see the whole
batch's router statistics, capacity and slot order through collectives
over the data group, as the reference's global arrays, and run the
experts split over ``expert_mlp`` where the rules say so (grok).
``_moe_shard_map_plain`` is the shard_map dispatch in one process (the
``nm`` slices in turn on the whole experts), for tests and checks only.
Without a ``ctx`` every path is the one-process path.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LMConfig
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import (ShardingCtx, mesh_sizes,
                                              param_spec, shard_of,
                                              spec_groups, split_axes)
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.flash_attention.ops import (chunked_attention,
                                                     decode_attention_lse)
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
# parameter specs and shards under a mesh
# ---------------------------------------------------------------------------

def _layer_leaves(cfg: LMConfig) -> Dict[str, Tuple[tuple, tuple]]:
    """name -> (shape, logical spec) of one layer's parameters, as the
    reference's ``_layer_init`` makes and annotates them."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    out = {"wq": ((d, cfg.n_heads * hd), ("embed", "heads")),
           "wk": ((d, cfg.n_kv_heads * hd), ("embed", "kv_heads")),
           "wv": ((d, cfg.n_kv_heads * hd), ("embed", "kv_heads")),
           "wo": ((cfg.n_heads * hd, d), ("heads", "embed"))}
    if cfg.norm != "layernorm_np":
        out["ln1"] = out["ln2"] = ((d,), ("embed",))
    if cfg.n_experts:
        E, ff = cfg.n_experts, cfg.moe_d_ff or cfg.d_ff
        out["router"] = ((d, E), ("embed", None))
        out["w_gate"] = out["w_up"] = ((E, d, ff),
                                       ("expert", "embed", "expert_mlp"))
        out["w_down"] = ((E, ff, d), ("expert", "expert_mlp", "embed"))
    else:
        out["w_gate"] = out["w_up"] = ((d, cfg.d_ff), ("embed", "mlp"))
        out["w_down"] = ((cfg.d_ff, d), ("mlp", "embed"))
    return out


def _leaves(cfg: LMConfig) -> Dict[str, Any]:
    """The tree of (shape, logical spec) pairs, as ``init_params``'s."""
    d, V = cfg.d_model, cfg.vocab_size
    tree = {"embed": ((V, d), ("vocab", "embed")),
            "layers": [_layer_leaves(cfg) for _ in range(cfg.n_layers)],
            "final_norm": ((d,), ("embed",))}
    if not cfg.tie_embeddings:
        tree["lm_head"] = ((d, V), ("embed", "vocab"))
    return tree


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def param_specs(cfg: LMConfig) -> Dict[str, Any]:
    """The logical spec of every parameter, in ``init_params``'s tree (a
    list of per-layer dicts): the reference's specs
    (``repro/models/lm/model.py::_layer_init`` and ``init_params``)
    without the ``stack`` axis of its scanned layers."""
    return _tree_map(lambda leaf: leaf[1], _leaves(cfg))


def param_layout(cfg: LMConfig, ctx: ShardingCtx) -> Dict[str, Any]:
    """Each parameter's spec under ``ctx`` (``param_spec``: one mesh
    axis, a tuple of them, or None for each dim)."""
    sizes = mesh_sizes(ctx.mesh)
    return _tree_map(lambda leaf: param_spec(leaf[1], ctx.rules, leaf[0],
                                             sizes), _leaves(cfg))


def shard_params(params: Params, cfg: LMConfig, ctx: ShardingCtx
                 ) -> Params:
    """This rank's shards of a whole parameter tree, laid out by
    ``param_layout`` (each split dim cut into equal blocks in the order
    of the rank's coordinate along its axes)."""
    lay = param_layout(cfg, ctx)
    out = {k: shard_of(v, lay[k], ctx) for k, v in params.items()
           if k != "layers"}
    out["layers"] = [{k: shard_of(v, ll[k], ctx) for k, v in lp.items()}
                     for lp, ll in zip(params["layers"], lay["layers"])]
    return out


def shard_groups(cfg: LMConfig, ctx: ShardingCtx,
                 lay: Optional[Dict[str, Any]] = None
                 ) -> Dict[str, Tuple[Any, ...]]:
    """``named_params``' names -> for each dim, the process group it is
    split over (None where a rank holds it whole), for the optimizers
    and the clipping of ``optim/optimizers.py``.  Axes of size 1 split
    nothing.  ``lay``: ``param_layout(cfg, ctx)`` where the caller has
    it."""
    flat = named_params(param_layout(cfg, ctx) if lay is None else lay)
    return {k: spec_groups(v, ctx) for k, v in flat.items()}


def _w(p: Dict[str, Any], name: str, lay: Optional[Dict[str, Any]],
       ctx: Optional[ShardingCtx], dtype: Optional[torch.dtype] = None,
       model: bool = False) -> Optional[torch.Tensor]:
    """Parameter ``name`` of ``p`` as the product uses it: cast to
    ``dtype``, and under a mesh gathered over the axes its spec splits
    other than ``model`` (axes of size 1 split nothing), cast before it is
    sent.  A dim split over ``model`` stays local, unless ``model``: then
    it is gathered too, for a product every model rank runs alike (its
    gradient scaled by ``1 / nm``, the reduce-scatter's sum of the ranks'
    equal cotangents)."""
    x = p.get(name)
    if x is None or lay is None:
        return x if x is None or dtype is None else x.to(dtype)
    for dim, ax in split_axes(lay[name]):
        n = ctx.size(ax)
        if n == 1 or ("model" in ax and not model):
            continue
        x = C.gather_dim(x, dim, ctx.group(ax), dtype=dtype,
                         grad_scale=1.0 / n if "model" in ax else 1.0)
    return x if dtype is None else x.to(dtype)


def _on_model(lay: Optional[Dict[str, Any]], name: str, dim: int) -> bool:
    """Whether dim ``dim`` of leaf ``name`` is split over ``model``."""
    if lay is None or name not in lay:
        return False
    s = lay[name][dim]
    return s is not None and "model" in ((s,) if isinstance(s, str) else s)


@dataclasses.dataclass(frozen=True)
class _TP:
    """A mesh's model group, for tensor parallelism: ``nm`` ranks, this
    rank's index ``mi``, the ``group``; ``seq``: the residual between
    blocks is this rank's ``S / nm`` positions (dim 1)."""
    nm: int
    mi: int
    group: Any
    seq: bool

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """The residual as the input of split products."""
        return C.seq_gather(x, 1, self.group) if self.seq \
            else C.enter_split(x, self.group)

    def leave(self, y: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """Split products' partial sums back into the residual's layout,
        summed in their own type and then cast to ``dtype``."""
        y = C.seq_scatter(y, 1, self.group) if self.seq \
            else C.leave_split(y, self.group)
        return y.to(dtype)

    def whole(self, x: torch.Tensor) -> torch.Tensor:
        """The residual whole, for a block every rank runs alike."""
        return C.gather_split(x, 1, self.group) if self.seq else x

    def part(self, y: torch.Tensor) -> torch.Tensor:
        """A block's whole output in the residual's layout."""
        return C.split_of(y, 1, self.group) if self.seq else y

    def scale(self, w: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """A norm's scale as it applies to the residual: under ``seq`` to
        the rank's positions, so that its gradient is summed over the
        group."""
        return C.enter_split(w, self.group) if self.seq and w is not None \
            else w


def _tp(ctx: Optional[ShardingCtx], S: int, seq: bool) -> Optional[_TP]:
    """The model group of ``ctx`` where the mesh's ``model`` axis has more
    than one rank (None otherwise); sequence parallelism where ``seq``
    (no caches), the rules map ``seq`` to ``model`` and ``nm`` divides
    ``S``."""
    if ctx is None or ctx.mesh is None \
            or "model" not in ctx.mesh.mesh_dim_names:
        return None
    nm = ctx.size("model")
    if nm == 1:
        return None
    sp = seq and "model" in ctx.mesh_axes("seq") and S % nm == 0
    return _TP(nm, ctx.axis_index("model"), ctx.group("model"), sp)


@dataclasses.dataclass(frozen=True)
class _Seq:
    """The ranks a decode cache's sequence is split over (the rules'
    ``kv_seq``): ``n`` blocks of ``T / n`` positions, this rank's block
    ``j`` (its coordinate along the ``kv_seq`` axes, the first axis
    slowest, as ``P(("data", "model"))`` splits a dim: block ``di * nm +
    mi`` under ``("data", "model")``), and their ``group`` (its rank order
    the blocks' order)."""
    n: int
    j: int
    group: Any


def _kv_seq(ctx: Optional[ShardingCtx]) -> Optional[_Seq]:
    """The ``kv_seq`` split of a decode cache under ``ctx``, None where
    its axes hold one rank (or no mesh)."""
    if ctx is None or ctx.mesh is None:
        return None
    axes = ctx.mesh_axes("kv_seq")
    if not axes or ctx.size(axes) == 1:
        return None
    return _Seq(ctx.size(axes), ctx.axis_index(axes), ctx.group(axes))


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


def _dense_mlp(p, cfg: LMConfig, x: torch.Tensor,
               ctx: Optional[ShardingCtx] = None, lay=None,
               tp: Optional[_TP] = None) -> torch.Tensor:
    """The GLU MLP of the residual ``x``; under ``tp`` (module docstring)
    split by columns, then rows, where the layout splits ``mlp``."""
    if tp is None or not _on_model(lay, "w_gate", 1):
        h = x if tp is None else tp.whole(x)
        g = h @ _w(p, "w_gate", lay, ctx, h.dtype)
        u = h @ _w(p, "w_up", lay, ctx, h.dtype)
        out = (_act(cfg, g) * u) @ _w(p, "w_down", lay, ctx, h.dtype)
        return out if tp is None else tp.part(out)
    h = tp.enter(x)
    g = h @ _w(p, "w_gate", lay, ctx, h.dtype)
    u = h @ _w(p, "w_up", lay, ctx, h.dtype)
    return tp.leave(nn.mm_f32(_act(cfg, g) * u,
                              _w(p, "w_down", lay, ctx, h.dtype)), x.dtype)


# ---------------------------------------------------------------------------
# mixture of experts
# ---------------------------------------------------------------------------

def _router(p, cfg: LMConfig, xt: torch.Tensor, group=None
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xt (T, d) -> (gate (T, k) f32, expert ids (T, k), aux () f32).  The
    top k of each token's probabilities in descending order, the lower
    index first among equal ones (``jax.lax.top_k``'s order: a stable
    descending sort cut at k; ``torch.topk`` promises none), renormalised;
    aux is the Switch term ``E * sum_e f_e p_e * router_aux_coef``.  With
    ``group`` (the data ranks, each with its own T rows of the batch) the
    means ``f_e`` and ``p_e`` are the whole batch's."""
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
    counts = torch.bincount(eid.reshape(-1), minlength=E).to(torch.float32)
    if group is None:
        me = torch.mean(probs, dim=0)
    else:
        T = T * C.group_size(group)
        me = C.all_sum(torch.sum(probs, dim=0), group) / T
        C.sum_across_(counts, group)
    ce = counts / (T * k)
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


def shard_map_capacity(cfg: LMConfig, T_my: int) -> int:
    """Slots an expert takes of one model rank's ``T_my`` tokens in
    ``_moe_shard_map`` (the reference's body: a multiple of 8, at least
    8)."""
    k, E = cfg.n_experts_per_tok, cfg.n_experts
    return max(8, -(-int(k * T_my / E * cfg.capacity_factor) // 8) * 8)


def _mesh_data_axes(ctx: Optional[ShardingCtx]) -> Tuple[str, ...]:
    """The mesh's data axes (the reference's ``pod`` and ``data``); none
    with no mesh."""
    if ctx is None or ctx.mesh is None:
        return ()
    names = tuple(ctx.mesh.mesh_dim_names)
    return tuple(a for a in ("pod", "data") if a in names)


def data_axes(ctx: Optional[ShardingCtx]) -> Tuple[str, ...]:
    """The mesh axes the batch's rows are split over: the mesh's ``pod``
    and ``data`` axes that the rules' ``batch`` maps to (none with no
    mesh, and none under the 500k decode rules, which keep the batch
    whole: every data rank then holds the same rows, and each collective
    over "the data ranks" sees a group of one)."""
    batch = ctx.mesh_axes("batch") if ctx is not None else ()
    return tuple(a for a in _mesh_data_axes(ctx) if a in batch)


def _data_group(ctx: Optional[ShardingCtx]):
    """The group of the data ranks, or None with one data rank."""
    axes = data_axes(ctx)
    return ctx.group(axes) if axes and ctx.size(axes) > 1 else None


def rank_rows(tokens: torch.Tensor, ctx: Optional[ShardingCtx]
              ) -> torch.Tensor:
    """This rank's rows of a whole batch (B, ...): its data rank's ``B /
    dp`` (the ranks of a model group take the same rows); the whole batch
    with one data rank or no mesh."""
    axes = data_axes(ctx)
    dp = ctx.size(axes) if axes else 1
    if dp == 1:
        return tokens
    if tokens.shape[0] % dp:
        raise ValueError(f"a batch of {tokens.shape[0]} rows cannot be "
                         f"split over {dp} data ranks")
    rows = tokens.shape[0] // dp
    di = ctx.axis_index(axes)
    return tokens[di * rows:(di + 1) * rows]


def _moe_scatter(p, cfg: LMConfig, x: torch.Tensor,
                 ctx: Optional[ShardingCtx] = None, lay=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity dispatch, x (B, S, d) -> (out, aux): the T k slots (token
    t's j-th choice is slot t k + j) fill an (E, cap, d) buffer in slot
    order; a slot past its expert's capacity is dropped (it adds zeros at
    (E - 1, cap - 1), as the reference's scatter does); the experts' GLU
    runs as batched products over the buffer; each token sums its kept
    slots' outputs weighted by their gates.  Under a mesh with several
    data ranks the slot order, the capacity and the router's statistics
    are the whole batch's (the rows of lower data ranks first), and
    where the layout splits ``expert_mlp`` over the model group the
    experts' products are split by columns, then rows (``_expert_glu``)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.n_experts_per_tok
    T = B * S
    xt = x.reshape(T, d)
    group = _data_group(ctx)
    gate, eid, aux = _router({"router": _w(p, "router", lay, ctx)}, cfg, xt,
                             group)
    flat_e = eid.reshape(-1)
    pos = _pos_in_group(flat_e).long()
    T_all = T
    if group is not None:
        counts = C.gather_rows(torch.bincount(flat_e, minlength=E)[None],
                               group)
        pos = pos + counts[:ctx.axis_index(data_axes(ctx))].sum(0)[flat_e]
        T_all = T * C.group_size(group)
    cap = moe_capacity(cfg, T_all)
    keep = pos < cap
    src = torch.repeat_interleave(xt, k, dim=0) * keep[:, None].to(x.dtype)
    buf = torch.zeros((E, cap, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((torch.where(keep, flat_e, E - 1),
                         torch.where(keep, pos, cap - 1)), src,
                        accumulate=True)
    del src
    eout = _expert_glu(p, cfg, buf, ctx, lay)
    got = eout[torch.where(keep, flat_e, 0), torch.where(keep, pos, 0)]
    got = got * (keep[:, None].to(torch.float32)
                 * gate.reshape(-1)[:, None]).to(x.dtype)
    return torch.sum(got.reshape(T, k, d), dim=1).reshape(B, S, d), aux


def _expert_tp(ctx: Optional[ShardingCtx], lay) -> Optional[_TP]:
    """The model group the experts' ff dim is split over, or None."""
    tp = _tp(ctx, 1, False)
    return tp if tp is not None and _on_model(lay, "w_gate", 2) else None


def _expert_glu(p, cfg: LMConfig, buf: torch.Tensor,
                ctx: Optional[ShardingCtx], lay) -> torch.Tensor:
    """The experts' GLU over their (E, cap, d) buffers, as batched
    products.  Split over ``expert_mlp`` (``_expert_tp``): the buffer
    enters the split products, ``w_down``'s f32 partial sums leave summed
    over the model group; else the experts whole (gathered over the
    model axis where ``expert`` splits them there)."""
    tp = _expert_tp(ctx, lay)
    whole = _on_model(lay, "w_gate", 0)
    wg, wu, wd = (_w(p, n, lay, ctx, buf.dtype, model=whole)
                  for n in ("w_gate", "w_up", "w_down"))
    if tp is None:
        return _experts(cfg, buf, wg, wu, wd)
    b = C.enter_split(buf, tp.group)
    h = _act(cfg, torch.bmm(b, wg)) * torch.bmm(b, wu)
    return C.leave_split(nn.mm_f32(h, wd), tp.group).to(buf.dtype)


def _moe_dense(p, cfg: LMConfig, x: torch.Tensor,
               ctx: Optional[ShardingCtx] = None, lay=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every expert over every token, weighted by a (T, E) gate mask (zero
    off each token's top k): no capacity, nothing dropped; E / k times
    the products of ``_moe_scatter``.  Under a mesh the router's
    statistics are the whole batch's; split over ``expert_mlp``
    (``_expert_tp``) each expert's products are split by columns, then
    rows, and the gate-weighted sum of their f32 partial sums is summed
    over the model group once."""
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    gate, eid, aux = _router({"router": _w(p, "router", lay, ctx)}, cfg, xt,
                             _data_group(ctx))
    w = torch.zeros((T, cfg.n_experts), dtype=x.dtype, device=x.device
                    ).scatter_add(1, eid, gate.to(x.dtype))
    tp = _expert_tp(ctx, lay)
    whole = _on_model(lay, "w_gate", 0)
    wg, wu, wd = (_w(p, n, lay, ctx, model=whole)
                  for n in ("w_gate", "w_up", "w_down"))
    if tp is not None:
        xt, w = C.enter_split(xt, tp.group), C.enter_split(w, tp.group)
        out = torch.zeros((T, d), dtype=torch.float32, device=x.device)
    else:
        out = torch.zeros_like(xt)
    for e in range(cfg.n_experts):
        g = xt @ wg[e].to(x.dtype)
        u = xt @ wu[e].to(x.dtype)
        if tp is None:
            out = out + ((_act(cfg, g) * u) @ wd[e].to(x.dtype)) \
                * w[:, e:e + 1]
        else:
            out = out + nn.mm_f32(_act(cfg, g) * u, wd[e].to(x.dtype)) \
                * w[:, e:e + 1].to(torch.float32)
    if tp is not None:
        out = C.leave_split(out, tp.group).to(x.dtype)
    return out.reshape(B, S, d), aux


def _shard_map_slots(cfg: LMConfig, gate, eid, nm: int, T_my: int):
    """One model rank's routing of its ``T_my`` tokens in the shard_map
    dispatch: (owner rank, expert on it, position, kept, cap) a slot."""
    E_loc = cfg.n_experts // nm
    flat_e = eid.reshape(-1)
    pos = _pos_in_group(flat_e).long()
    cap = shard_map_capacity(cfg, T_my)
    keep = pos < cap
    return (torch.where(keep, flat_e // E_loc, 0),
            torch.where(keep, flat_e % E_loc, 0),
            torch.where(keep, pos, cap - 1), keep, cap)


def _pack(x_my, slots, nm: int, E_loc: int, k: int) -> torch.Tensor:
    """The (nm, E_loc, cap, d) send buffer: each kept slot's token at its
    (owner, expert, position); a dropped slot adds zeros at (0, 0,
    cap - 1), as the reference's scatter does."""
    owner, e_loc, pos, keep, cap = slots
    src = torch.repeat_interleave(x_my, k, dim=0) \
        * keep[:, None].to(x_my.dtype)
    send = torch.zeros((nm, E_loc, cap, x_my.shape[1]), dtype=x_my.dtype,
                       device=x_my.device)
    return send.index_put((owner, e_loc, pos), src, accumulate=True)


def _experts(cfg: LMConfig, tok, wg, wu, wd) -> torch.Tensor:
    """The experts' GLU as batched products: tok (E', n, d) -> (E', n, d)."""
    h = _act(cfg, torch.bmm(tok, wg)) * torch.bmm(tok, wu)
    return torch.bmm(h, wd)


def _combine(ret, slots, gate, T_my: int, k: int) -> torch.Tensor:
    """Each token's kept slots' outputs, weighted by their gates, summed."""
    owner, e_loc, pos, keep, _ = slots
    got = ret[owner, e_loc, pos]
    got = got * (keep[:, None].to(torch.float32)
                 * gate.reshape(-1)[:, None]).to(ret.dtype)
    return torch.sum(got.reshape(T_my, k, -1), dim=1)


def _moe_shard_map(p, cfg: LMConfig, x: torch.Tensor, ctx: ShardingCtx,
                   lay: Dict[str, Any]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert parallelism over the model axis, the reference's
    ``_moe_shard_map`` body on this rank: x (B, S, d) is the data rank's
    rows (the same on every rank of the model group), and ``p`` holds
    this rank's ``E / nm`` experts.  The FSDP gathers of the router and
    the experts over the other axes; this rank's ``T / nm`` token slice;
    the local router and ``_pos_in_group``; the body's capacity
    (``shard_map_capacity``); the (nm, E_loc, cap, d) pack;
    ``all_to_all``, the experts' GLU as batched products, ``all_to_all``
    back; the gate-weighted combine, the ``all_gather`` of the slices and
    the ``pmean`` of aux over the model group.  ``lay``: the layer's
    entry of ``param_layout(cfg, ctx)``."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.n_experts_per_tok
    nm, mi, mg = ctx.size("model"), ctx.axis_index("model"), \
        ctx.group("model")
    E_loc, T_my = E // nm, B * S // nm
    x_my = C.slice_rows(x.reshape(B * S, d), mi, nm, mg)
    router = _w({"router": C.enter_split(p["router"], mg)}, "router", lay,
                ctx)
    wg, wu, wd = (_w(p, n, lay, ctx, x.dtype)
                  for n in ("w_gate", "w_up", "w_down"))
    gate, eid, aux = _router({"router": router}, cfg, x_my)
    slots = _shard_map_slots(cfg, gate, eid, nm, T_my)
    recv = C.all_to_all(_pack(x_my, slots, nm, E_loc, k), mg)
    cap = slots[4]
    tok = recv.transpose(0, 1).reshape(E_loc, nm * cap, d)
    eout = _experts(cfg, tok, wg, wu, wd)
    back = eout.reshape(E_loc, nm, cap, d).transpose(0, 1)
    ret = C.all_to_all(back, mg)
    out_my = _combine(ret, slots, gate, T_my, k)
    out = C.gather_dim(out_my, 0, mg, grad_scale=1.0 / nm)
    return out.reshape(B, S, d), C.mean_across(aux, mg)


def _moe_shard_map_plain(p, cfg: LMConfig, x: torch.Tensor, nm: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_moe_shard_map`` of one data rank's rows in one process, on the
    whole expert tensors: the ``nm`` token slices routed and packed in
    turn, each owner's experts run over the buffers the slices send it in
    the order the ``all_to_all`` lays them out, the slices' outputs
    concatenated and their aux terms averaged.  For tests and checks;
    never on the main path."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.n_experts_per_tok
    E_loc, T_my = E // nm, B * S // nm
    xt = x.reshape(B * S, d)
    routed, sends, auxes = [], [], []
    for mi in range(nm):
        x_my = xt[mi * T_my:(mi + 1) * T_my]
        gate, eid, aux = _router(p, cfg, x_my)
        slots = _shard_map_slots(cfg, gate, eid, nm, T_my)
        routed.append((gate, slots))
        sends.append(_pack(x_my, slots, nm, E_loc, k))
        auxes.append(aux)
    cap = routed[0][1][4]
    # (source, owner, E_loc, cap, d) -> each owner's experts over
    # (source, cap) rows, as the owner's received buffer
    tok = torch.stack(sends).permute(1, 2, 0, 3, 4).reshape(
        E, nm * cap, d)
    del sends
    eout = _experts(cfg, tok, *(p[n].to(x.dtype)
                                for n in ("w_gate", "w_up", "w_down")))
    eout = eout.reshape(nm, E_loc, nm, cap, d)
    outs = [_combine(eout[:, :, mi], slots, gate, T_my, k)
            for mi, (gate, slots) in enumerate(routed)]
    aux = torch.sum(torch.stack(auxes)) / nm
    return torch.cat(outs).reshape(B, S, d), aux


def moe_dispatch(cfg: LMConfig, T: int, ctx: Optional[ShardingCtx]) -> str:
    """The branch of ``_moe_block`` for a rank with T tokens (its data
    rank's rows), under the reference's conditions on the whole batch's
    T_all (``repro/models/lm/model.py:357-369``, dp the mesh's data
    ranks, whether or not the rules split the batch over them): "shard_map"
    where a mesh has a model axis, the rules split ``expert`` over it, nm
    divides E and T_all / dp, and T_all / dp >= nm; else "dense" where
    E <= 16 and T_all / dp >= 1,024; else "scatter" (decode, no
    mesh)."""
    if ctx is None or ctx.mesh is None \
            or "model" not in ctx.mesh.mesh_dim_names:
        return "scatter"
    E, nm = cfg.n_experts, ctx.size("model")
    dp = ctx.size(_mesh_data_axes(ctx)) if _mesh_data_axes(ctx) else 1
    T_all = T * (ctx.size(data_axes(ctx)) if data_axes(ctx) else 1)
    if ((ctx.rules or {}).get("expert") == "model" and E % nm == 0
            and T_all % (dp * nm) == 0 and T_all // dp >= nm):
        return "shard_map"
    if E <= 16 and T_all // max(dp, 1) >= 1024:
        return "dense"
    return "scatter"


def _moe_block(p, cfg: LMConfig, x: torch.Tensor,
               ctx: Optional[ShardingCtx] = None, lay=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-choice top-k MoE by ``moe_dispatch``'s branch; without a
    mesh the capacity scatter.  ``lay``: under a mesh the layer's entry
    of ``param_layout(cfg, ctx)``."""
    kind = moe_dispatch(cfg, x.shape[0] * x.shape[1], ctx)
    if kind == "scatter":
        return _moe_scatter(p, cfg, x, ctx, lay)
    if kind == "dense":
        return _moe_dense(p, cfg, x, ctx, lay)
    return _moe_shard_map(p, cfg, x, ctx, lay)


def _kv_used(cfg: LMConfig, tp: _TP, H: int) -> slice:
    """The KV heads (of all ``Hkv``) that this rank's ``H`` query heads
    use, where the model axis splits the query heads but not the KV heads
    (gemma-2b's single KV head)."""
    r = cfg.n_heads // cfg.n_kv_heads
    q0 = tp.mi * H
    used = slice(q0 // r, (q0 + H - 1) // r + 1)
    if H % r and r % H:
        raise ValueError(f"{H} query heads a rank cannot keep the groups of "
                         f"{r} that share a KV head")
    return used


def _write_kv(ck: torch.Tensor, cv: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor, cache_len: int, lo: int = 0) -> None:
    """Writes the S new positions ``[cache_len, cache_len + S)`` of ``k``
    and ``v`` (B, S, Hkv, hd) into caches (B, T', Hkv, hd) that hold
    positions ``[lo, lo + T')``: the part that falls there, in place."""
    S, T = k.shape[1], ck.shape[1]
    a, b = max(cache_len, lo), min(cache_len + S, lo + T)
    if a < b:
        ck[:, a - lo:b - lo] = k[:, a - cache_len:b - cache_len].to(ck.dtype)
        cv[:, a - lo:b - lo] = v[:, a - cache_len:b - cache_len].to(cv.dtype)


def _seq_attention(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                   cache_len: int, seq: _Seq, scale: float) -> torch.Tensor:
    """Attention of q (B, S, H, hd) over keys ``[0, cache_len + S)`` of a
    cache whose sequence is split over ``seq``, this rank holding block
    ``j`` (B, T / n, H', hd): the rank attends over its ``kv_len_j =
    clamp(cache_len + S - j T / n, 0, T / n)`` keys (f32 output and lse;
    a rank with none launches nothing and gives out 0 and lse -inf, which
    weigh 0), then ``fold_seq`` over the group.  f32 (B, S, H, hd)."""
    T_loc = ck.shape[1]
    kv_len = min(max(cache_len + q.shape[1] - seq.j * T_loc, 0), T_loc)
    if kv_len > 0:
        out, lse = decode_attention_lse(q, ck, cv, kv_len=kv_len,
                                        scale=scale)
    else:
        out = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        lse = torch.full(q.shape[:3], float("-inf"), dtype=torch.float32,
                         device=q.device)
    return C.fold_seq(out, lse, seq.group)


def _attn_block(p, cfg: LMConfig, x: torch.Tensor, positions: torch.Tensor,
                kv: Optional[Tuple[torch.Tensor, torch.Tensor]],
                cache_len: int, causal: bool, block_q: int,
                ctx: Optional[ShardingCtx] = None, lay=None,
                tp: Optional[_TP] = None, seq: Optional[_Seq] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (out, k, v).  ``kv``: None (prefill from scratch) or one
    layer's caches (B, T, Hkv, hd), into which the new keys and values
    are written at ``cache_len`` (in place) before attending over the
    first ``cache_len + S`` positions.  Under ``tp`` where the layout
    splits ``heads`` and ``nm`` divides ``H``: this rank's query heads
    over its KV heads where ``nm`` divides ``Hkv`` (else over those of all
    that they use, ``wk`` and ``wv`` gathered over the model axis where
    the layout splits them within a head), ``wo`` by rows; ``k`` and
    ``v`` are the heads a rank's caches hold (``cache_heads``).  Where
    ``nm`` does not divide ``H`` every rank runs the whole attention (its
    weights gathered over the model axis).  ``seq``: the caches are this
    rank's block of a sequence split over ``kv_seq`` (``_seq_attention``;
    the new keys and values go only into the block that holds their
    positions)."""
    hd = cfg.resolved_head_dim
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    split = tp is not None and _on_model(lay, "wq", 1) and H % tp.nm == 0
    h = x if tp is None else (tp.enter(x) if split else tp.whole(x))
    B, S, _ = h.shape
    wq = _w(p, "wq", lay, ctx, h.dtype, model=not split)
    if split and not _on_model(lay, "wk", 1):   # whole among split products
        wk, wv = (C.enter_split(_w(p, n, lay, ctx), tp.group).to(h.dtype)
                  for n in ("wk", "wv"))
    else:
        wk, wv = (_w(p, n, lay, ctx, h.dtype, model=not split)
                  for n in ("wk", "wv"))
    if split:
        H //= tp.nm
        if Hkv % tp.nm == 0:
            Hkv //= tp.nm
        elif _on_model(lay, "wk", 1):   # split within a head: every rank's
            wk, wv = (C.seq_gather(w, 1, tp.group) for w in (wk, wv))
    q = (h @ wq).reshape(B, S, H, hd)
    k = (h @ wk).reshape(B, S, Hkv, hd)
    v = (h @ wv).reshape(B, S, Hkv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if kv is not None:
        ck, cv = kv
        n = 1 if seq is None else seq.n
        if cache_len + S > ck.shape[1] * n:
            raise ValueError(f"cache of {ck.shape[1] * n} positions cannot "
                             f"take {S} more at {cache_len}")
        _write_kv(ck, cv, k, v, cache_len,
                  0 if seq is None else seq.j * ck.shape[1])
        k, v = ck, cv
    used = _kv_used(cfg, tp, H) if split and Hkv == cfg.n_kv_heads \
        else slice(None)
    if seq is not None and kv is not None:
        out = _seq_attention(q, k[:, :, used], v[:, :, used], cache_len,
                             seq, hd ** -0.5).to(q.dtype)
    else:
        out = chunked_attention(q, k[:, :, used], v[:, :, used],
                                causal=causal and kv is None, q_offset=0,
                                kv_len=None if kv is None
                                else cache_len + S,
                                block_q=block_q, scale=hd ** -0.5)
    out = out.reshape(B, S, H * hd)
    wo = _w(p, "wo", lay, ctx, h.dtype, model=not split)
    if split:
        return tp.leave(nn.mm_f32(out, wo), x.dtype), k, v
    out = out @ wo
    return (out if tp is None else tp.part(out)), k, v


def _layer(p, cfg: LMConfig, x, positions, kv, cache_len, causal, block_q,
           ctx: Optional[ShardingCtx] = None, lay=None,
           tp: Optional[_TP] = None, seq: Optional[_Seq] = None):
    """Returns (x, k, v, aux): aux the MoE load-balancing term, None for a
    dense layer (the reference's 0.0, which adds nothing).  ``tp``: the
    model group of tensor parallelism (``_tp``); ``seq``: the ``kv_seq``
    split of the caches (``_kv_seq``)."""
    def scale(name):
        w = _w(p, name, lay, ctx)
        return w if tp is None else tp.scale(w)
    h = _norm(cfg, x, scale("ln1"))
    attn, k, v = _attn_block(p, cfg, h, positions, kv, cache_len, causal,
                             block_q, ctx, lay, tp, seq)
    x = x + attn
    h = _norm(cfg, x, scale("ln2"))
    if cfg.n_experts:
        if tp is None:
            mlp, aux = _moe_block(p, cfg, h, ctx, lay)
        else:
            mlp, aux = _moe_block(p, cfg, tp.whole(h), ctx, lay)
            mlp = tp.part(mlp)
        return x + mlp, k, v, aux
    return x + _dense_mlp(p, cfg, h, ctx, lay, tp), k, v, None


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def _embed(params: Params, cfg: LMConfig, tokens: torch.Tensor,
           ctx: Optional[ShardingCtx], lay, tp: Optional[_TP]
           ) -> torch.Tensor:
    """The tokens' embedding rows in the compute type, in the residual's
    layout.  Split over ``vocab``: this rank's rows for the tokens they
    hold (zeros for the others), summed over the model group in f32 (one
    term is not zero: exact)."""
    compute = DTYPES[cfg.dtype]
    emb = _w(params, "embed", lay, ctx)
    if tp is not None and _on_model(lay, "embed", 0):
        rows = emb.shape[0]
        idx = tokens - tp.mi * rows
        inside = (idx >= 0) & (idx < rows)
        x = emb[torch.where(inside, idx, 0)].to(torch.float32) \
            * inside[..., None].to(torch.float32)
        x = tp.leave(x, compute)
    else:
        x = emb[tokens].to(compute)
        if tp is not None:
            x = tp.part(x)
    if cfg.norm == "rmsnorm_p1":     # gemma scales embeddings by sqrt(d)
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=compute)
    return x


def _trunk(params: Params, cfg: LMConfig, tokens: torch.Tensor, *,
           positions: Optional[torch.Tensor], kv_caches: Optional[Caches],
           cache_len: int, causal: bool, block_q: int, keep_cache: bool,
           remat: bool = False, ctx: Optional[ShardingCtx] = None,
           lay=None
           ) -> Tuple[torch.Tensor, Optional[Caches], Optional[torch.Tensor],
                      Optional[_TP]]:
    """tokens (B, S) -> (residual stream after the last layer (B, S, d),
    caches, aux, tp): the given ``kv_caches`` (written in place), or with
    ``keep_cache`` new (L, B, S, Hkv, hd) ones in the compute type (a
    rank's own KV heads under tensor parallelism); aux the sum of the MoE
    layers' terms in layer order (None for a dense config); tp the model
    group (``_tp``; sequence parallelism only without caches, and the
    residual then this rank's ``S / nm`` positions).  Given caches are
    the rank's block of a sequence split over ``kv_seq`` where the rules
    split it and its ranks divide the whole length (``_cache_seq``), else
    whole.  With ``remat`` (no
    caches) each layer keeps only its input for the backward and runs
    again there, its gathers too.  ``lay``: ``param_layout(cfg, ctx)``
    under a mesh."""
    compute = DTYPES[cfg.dtype]
    B, S = tokens.shape
    dev = tokens.device
    if positions is None:
        positions = torch.arange(S, device=dev)[None, :].expand(B, S)
    seq = None
    if kv_caches is not None:
        T = cache_length(kv_caches, ctx)
        n = _seq_blocks(T, ctx)
        if kv_caches["k"].shape[2] != T // n:
            raise ValueError(f"caches of {T} positions hold {T // n} a "
                             f"rank here, not {kv_caches['k'].shape[2]}")
        seq = _cache_seq(ctx, T) if n > 1 else None
    tp = _tp(ctx, S, kv_caches is None and not keep_cache)
    x = _embed(params, cfg, tokens, ctx, lay, tp)
    caches = kv_caches
    aux = None
    for i, lp in enumerate(params["layers"]):
        ll = None if lay is None else lay["layers"][i]
        kv = None if kv_caches is None else (kv_caches["k"][i],
                                             kv_caches["v"][i])
        if remat and kv is None and not keep_cache:
            x, a = checkpoint(lambda x_, lp_, ll_=ll: _layer(
                lp_, cfg, x_, positions, None, cache_len, causal,
                block_q, ctx, ll_, tp)[::3], x, lp, use_reentrant=False)
        else:
            x, k, v, a = _layer(lp, cfg, x, positions, kv, cache_len,
                                causal, block_q, ctx, ll, tp, seq)
            if kv_caches is None and keep_cache:
                if caches is None:
                    caches = {n: torch.empty((cfg.n_layers,) + k.shape,
                                             dtype=compute, device=dev)
                              for n in ("k", "v")}
                caches["k"][i] = k
                caches["v"][i] = v
        if a is not None:
            aux = a if aux is None else aux + a
    return x, caches, aux, tp


def _head(params: Params, cfg: LMConfig, x: torch.Tensor,
          ctx: Optional[ShardingCtx] = None, lay=None,
          tp: Optional[_TP] = None) -> Tuple[torch.Tensor, bool]:
    """(logits, split): the final norm and the head on the residual ``x``;
    ``split`` where the head is split over ``vocab`` (the logits are then
    this rank's columns, every position's), else the whole vocabulary's
    (every position's under sequence parallelism)."""
    w = _w(params, "final_norm", lay, ctx)
    x = nn.rmsnorm_apply(w if tp is None else tp.scale(w), x)
    name, dim = ("embed", 0) if cfg.tie_embeddings else ("lm_head", 1)
    split = tp is not None and _on_model(lay, name, dim)
    h = x if tp is None else (tp.enter(x) if split else tp.whole(x))
    w = _w(params, name, lay, ctx, h.dtype)
    return h @ (w.T if cfg.tie_embeddings else w), split


def _whole_vocab(logits: torch.Tensor, split: bool, tp: Optional[_TP]
                 ) -> torch.Tensor:
    return C.gather_split(logits, -1, tp.group) if split else logits


def _layout(cfg: LMConfig, ctx: Optional[ShardingCtx], lay=None,
            decode: bool = False):
    """``param_layout(cfg, ctx)`` (``lay`` where the caller has it), None
    with no mesh.  Except for ``decode`` (``decode_step``), raises where
    the rules keep the batch whole over data ranks (the reference's 500k
    decode, at a global batch of 1): no reference cell runs ``forward``,
    ``prefill`` or ``lm_loss`` under those rules.  ``decode_step`` runs
    there with every data rank holding the same rows, and every
    collective "over the data ranks" (``rank_rows``, the MoE dispatch's
    router statistics, capacity and slot order) sees a group of one
    (``data_axes``)."""
    if ctx is None or ctx.mesh is None:
        return None
    batch = ctx.mesh_axes("batch")
    whole = [a for a in _mesh_data_axes(ctx)
             if ctx.size(a) > 1 and a not in batch]
    if whole and not decode:
        raise ValueError(f"the rules keep the batch whole over the data "
                         f"axes {whole}: each data rank must hold rows of "
                         f"its own (run with those axes of size 1)")
    return param_layout(cfg, ctx) if lay is None else lay


def forward(params: Params, cfg: LMConfig, tokens: torch.Tensor, *,
            block_q: int = 1024, ctx: Optional[ShardingCtx] = None
            ) -> torch.Tensor:
    """tokens (B, S) -> causal logits (B, S, V) in the compute type, for
    every position (``prefill`` and ``decode_step`` serve; the reference's
    cache options of ``forward`` live there).  An MoE config's aux term is
    ``lm_loss``'s: the logits are all this returns.  Under ``ctx`` tokens
    are this rank's rows and ``params`` its shards (module docstring);
    every rank of a model group returns the whole vocabulary's logits."""
    lay = _layout(cfg, ctx)
    x, _, _, tp = _trunk(params, cfg, tokens, positions=None, kv_caches=None,
                         cache_len=0, causal=True, block_q=block_q,
                         keep_cache=False, ctx=ctx, lay=lay)
    return _whole_vocab(*_head(params, cfg, x, ctx, lay, tp), tp)


def _vocab_ce(lg: torch.Tensor, tgt: torch.Tensor, split: bool,
              tp: Optional[_TP]) -> torch.Tensor:
    """The mean over positions of logsumexp minus the gold logit of f32
    logits (B, S, V') and targets (B, S).  ``split``: ``lg`` is this
    rank's block of the vocabulary: the maximum, the sum of the
    exponentials and the gold logit (on the rank that holds it, zero on
    the others) are taken over the model group."""
    if not split:
        gold = torch.gather(lg, -1, tgt[..., None])[..., 0]
        return torch.mean(torch.logsumexp(lg, dim=-1) - gold)
    rows = lg.shape[-1]
    m = torch.amax(lg.detach(), dim=-1)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=tp.group)
    se = C.leave_split(torch.sum(torch.exp(lg - m[..., None]), dim=-1),
                       tp.group)
    idx = tgt - tp.mi * rows
    inside = (idx >= 0) & (idx < rows)
    gold = torch.gather(lg, -1, torch.where(inside, idx, 0)[..., None])[..., 0]
    gold = C.leave_split(gold * inside.to(lg.dtype), tp.group)
    return torch.mean(torch.log(se) + m - gold)


def lm_loss(params: Params, cfg: LMConfig, tokens: torch.Tensor, *,
            block_q: int = 1024, ctx: Optional[ShardingCtx] = None,
            lay: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """Next-token cross-entropy of tokens (B, S), as the reference's
    ``lm_loss`` (``repro/models/lm/model.py:534``): causal logits in the
    compute type, positions ``[:-1]`` in f32, the mean of logsumexp minus
    the gold logit, plus the MoE layers' aux terms (a dense config's is 0
    and is not added).  Each layer is rematerialised under ``cfg.remat``
    when grad mode is on.  Under ``ctx``: the mean over this rank's rows
    plus its aux terms (``launch.steps.lm_train_step`` averages over the
    data ranks), the same on every rank of a model group; ``lay``:
    ``param_layout(cfg, ctx)`` where the caller has it."""
    lay = _layout(cfg, ctx, lay)
    x, _, aux, tp = _trunk(params, cfg, tokens, positions=None,
                           kv_caches=None, cache_len=0, causal=True,
                           block_q=block_q, keep_cache=False,
                           remat=cfg.remat and torch.is_grad_enabled(),
                           ctx=ctx, lay=lay)
    lg, split = _head(params, cfg, x, ctx, lay, tp)
    loss = _vocab_ce(lg[:, :-1].to(torch.float32), tokens[:, 1:].long(),
                     split, tp)
    return loss if aux is None else loss + aux


def named_params(params: Params) -> Dict[str, torch.Tensor]:
    """The parameters as a flat ``name -> tensor`` dict of the same
    tensors (``layers.<i>.<name>`` for a layer's), for the optimizers."""
    flat = {k: v for k, v in params.items() if k != "layers"}
    for i, lp in enumerate(params["layers"]):
        flat.update({f"layers.{i}.{k}": v for k, v in lp.items()})
    return flat


def cache_heads(cfg: LMConfig, ctx: Optional[ShardingCtx] = None) -> int:
    """The KV heads a rank's caches hold: ``Hkv / nm`` where attention is
    split by heads over a model axis of ``nm > 1`` ranks (``_attn_block``)
    and ``nm`` divides ``Hkv``, else all ``Hkv``.  Reads sizes only, no
    process group."""
    if ctx is None or ctx.mesh is None \
            or "model" not in ctx.mesh.mesh_dim_names \
            or ctx.size("model") == 1:
        return cfg.n_kv_heads
    nm = ctx.size("model")
    lay = {n: param_spec(logical, ctx.rules, shape, mesh_sizes(ctx.mesh))
           for n, (shape, logical) in _layer_leaves(cfg).items()
           if n in ("wq", "wk")}
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    return Hkv // nm if _on_model(lay, "wq", 1) and H % nm == 0 \
        and _on_model(lay, "wk", 1) and Hkv % nm == 0 else Hkv


class KVCaches(dict):
    """Caches ``{"k", "v"}`` (a rank's block or the whole) that keep the
    whole cache's positions (``positions``), from which ``decode_step``
    tells a block of a split cache from a whole one."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor, positions: int):
        super().__init__(k=k, v=v)
        self.positions = int(positions)


def _kv_seq_size(ctx: Optional[ShardingCtx]) -> int:
    """The ranks the rules' ``kv_seq`` maps to (1 with no mesh); reads
    sizes only, no process group."""
    if ctx is None or ctx.mesh is None:
        return 1
    axes = ctx.mesh_axes("kv_seq")
    return ctx.size(axes) if axes else 1


def _cache_seq(ctx: Optional[ShardingCtx], max_len: int) -> Optional[_Seq]:
    """The ``kv_seq`` split of a cache of ``max_len`` positions under
    ``ctx``: None where the rules do not split it or where the ranks do
    not divide ``max_len`` (the cache is then whole on every rank, as
    ``_safe`` keeps it)."""
    n = _kv_seq_size(ctx)
    return _kv_seq(ctx) if n > 1 and max_len % n == 0 else None


def _seq_blocks(max_len: int, ctx: Optional[ShardingCtx]) -> int:
    """The ``kv_seq`` blocks of a cache of ``max_len`` positions under
    ``ctx`` (1 where the rules do not split it or the ranks do not divide
    it)."""
    n = _kv_seq_size(ctx)
    return n if n > 1 and max_len % n == 0 else 1


def init_kv_cache(cfg: LMConfig, batch: int, max_len: int, dtype=None,
                  device=None, ctx: Optional[ShardingCtx] = None) -> Caches:
    """Zeroed (L, B, T, Hkv, hd) caches in ``dtype`` (default: the compute
    type) on ``device``; under ``ctx`` a rank's ``cache_heads`` and, where
    the rules split ``kv_seq`` over ranks that divide ``max_len``, its
    block of ``max_len / n`` positions, else all of them (``batch``: the
    rows the rank holds).  The caches keep ``max_len``
    (``KVCaches``)."""
    dtype = dtype or DTYPES[cfg.dtype]
    shape = (cfg.n_layers, batch, max_len // _seq_blocks(max_len, ctx),
             cache_heads(cfg, ctx), cfg.resolved_head_dim)
    dev = resolve_device(device)
    return KVCaches(*(torch.zeros(shape, dtype=dtype, device=dev)
                      for _ in range(2)), max_len)


def shard_caches(caches: Caches, cfg: LMConfig, ctx: ShardingCtx) -> Caches:
    """This rank's part of whole caches (L, B, T, Hkv, hd): its rows
    (``rank_rows``), its ``cache_heads`` (the model rank's block of the KV
    heads where attention is split by heads) and, where the rules split
    ``kv_seq`` over ``n`` ranks that divide T, its block ``j`` of
    positions ``[j T / n, (j + 1) T / n)``, ``j`` its coordinate along
    the ``kv_seq`` axes with the first slowest (under ``("data",
    "model")``: ``di * nm + mi``); where they do not divide T, every
    position.  Contiguous copies, which keep T (``KVCaches``)."""
    out = {}
    T = caches["k"].shape[2]
    n = _seq_blocks(T, ctx)
    h = cache_heads(cfg, ctx)
    for name in ("k", "v"):
        c = rank_rows(caches[name].transpose(0, 1), ctx).transpose(0, 1)
        if n > 1:
            j = ctx.axis_index(ctx.mesh_axes("kv_seq"))
            c = c[:, :, j * (T // n):(j + 1) * (T // n)]
        if h < c.shape[3]:
            mi = ctx.axis_index("model")
            c = c[:, :, :, mi * h:(mi + 1) * h]
        c = c.contiguous()
        # a copy also where the block is already contiguous in the
        # caller's storage (every row, position and head, or one block)
        shared = (c.untyped_storage().data_ptr()
                  == caches[name].untyped_storage().data_ptr())
        out[name] = c.clone() if shared else c
    return KVCaches(out["k"], out["v"], T)


def cache_length(caches: Caches, ctx: Optional[ShardingCtx] = None) -> int:
    """The positions of the whole caches whose block (or whole) a rank
    holds: ``caches.positions`` where the caches keep it (``KVCaches``),
    else their own length, which is whole where the rules do not split
    ``kv_seq``.  Plain caches under a ``kv_seq`` split raise: their
    length alone cannot tell a block from a whole cache."""
    positions = getattr(caches, "positions", None)
    if positions is not None:
        return positions
    if _kv_seq_size(ctx) > 1:
        raise ValueError("caches under a kv_seq split must keep their whole "
                         "length: make them with init_kv_cache(ctx=) or "
                         "shard_caches")
    return caches["k"].shape[2]


def decode_step(params: Params, cfg: LMConfig, tokens: torch.Tensor,
                kv_caches: Caches, cache_len: int, *,
                ctx: Optional[ShardingCtx] = None
                ) -> Tuple[torch.Tensor, Caches]:
    """One decode step: tokens (B, 1) against caches filled to
    ``cache_len``.  Writes the step's keys and values into the caches in
    place at ``cache_len``; returns (logits (B, V), the caches).  Under
    ``ctx`` the caches are the rank's (``init_kv_cache(ctx=)``,
    ``shard_caches``: under the decode rules its block of the sequence, or
    the whole cache where the ``kv_seq`` ranks do not divide it;
    ``cache_len`` the whole sequence's position) and every rank of a model
    group returns the whole vocabulary's logits.  Under the 500k decode
    rules (the batch whole) every data rank passes the whole batch."""
    B = tokens.shape[0]
    positions = torch.full((B, 1), cache_len, dtype=torch.int64,
                           device=tokens.device)
    lay = _layout(cfg, ctx, decode=True)
    x, caches, _, tp = _trunk(params, cfg, tokens, positions=positions,
                              kv_caches=kv_caches, cache_len=cache_len,
                              causal=False, block_q=1, keep_cache=True,
                              ctx=ctx, lay=lay)
    return _whole_vocab(*_head(params, cfg, x[:, -1], ctx, lay, tp), tp), \
        caches


def prefill(params: Params, cfg: LMConfig, tokens: torch.Tensor, *,
            block_q: int = 1024, ctx: Optional[ShardingCtx] = None
            ) -> Tuple[torch.Tensor, Caches]:
    """Prefill: returns (last-position logits (B, V), caches (L, B, S,
    Hkv, hd) in the compute type).  The head runs on the last position
    only.  Under ``ctx`` the caches hold the rank's ``cache_heads`` and
    every rank of a model group returns the whole vocabulary's logits."""
    lay = _layout(cfg, ctx)
    x, caches, _, tp = _trunk(params, cfg, tokens, positions=None,
                              kv_caches=None, cache_len=0, causal=True,
                              block_q=block_q, keep_cache=True, ctx=ctx,
                              lay=lay)
    return _whole_vocab(*_head(params, cfg, x[:, -1], ctx, lay, tp), tp), \
        caches
