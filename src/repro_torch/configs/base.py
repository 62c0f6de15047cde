"""Config dataclasses, field for field as in the JAX package
(``repro/configs/base.py``): the LM family's ``LMConfig``, the recsys
family's ``RecsysConfig`` and RankGraph-2's own, their shape tables, and
the architecture registry (``--arch <id>`` -> ``ArchSpec``) for the
archs the port has: the five LMs (``olmo-1b``, ``llama3.2-3b``,
``gemma-2b`` and the MoE ``grok-1-314b`` and ``kimi-k2-1t-a32b``), the
four recsys archs and ``rankgraph2``."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str = "lm"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: Optional[int] = None          # default d_model // n_heads
    d_ff: int = 1024
    vocab_size: int = 1024
    act: str = "silu"                        # silu (swiglu) | gelu (geglu)
    norm: str = "rmsnorm"                    # rmsnorm | layernorm_np (olmo)
    rope_theta: float = 500000.0
    tie_embeddings: bool = False
    # MoE (n_experts == 0 -> dense)
    n_experts: int = 0
    n_experts_per_tok: int = 2
    moe_d_ff: Optional[int] = None           # expert hidden dim
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # execution
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True
    scan_layers: bool = True
    unroll_chunks: bool = False               # cost-probe mode: no scans
    decode_chunk: int = 2048                  # KV chunk for long decode
    optimizer: str = "adamw"                  # adafactor for the giants

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def _n(self, experts: int) -> int:
        hd = self.resolved_head_dim
        attn = self.d_model * hd * (2 * self.n_heads + 2 * self.n_kv_heads)
        if self.n_experts:
            ff = 3 * self.d_model * (self.moe_d_ff or self.d_ff) * experts
        else:
            ff = 3 * self.d_model * self.d_ff
        per_layer = attn + ff + 2 * self.d_model
        emb = self.vocab_size * self.d_model * (1 if self.tie_embeddings
                                                else 2)
        return self.n_layers * per_layer + emb + self.d_model

    def n_params(self) -> int:
        n = self._n(self.n_experts)
        if self.n_experts:                    # router
            n += self.n_layers * self.d_model * self.n_experts
        return n

    def n_active_params(self) -> int:
        if not self.n_experts:
            return self.n_params()
        return self._n(self.n_experts_per_tok)


# ---------------------------------------------------------------------------
# RecSys family
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str = "dlrm-rm2"
    kind: str = "dlrm"          # dlrm | wide_deep | sasrec | bst
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 64
    vocab_sizes: Tuple[int, ...] = ()        # per sparse field
    default_vocab: int = 10_000_000
    multi_hot: int = 1                       # ids per field (bag size)
    bot_mlp: Tuple[int, ...] = (512, 256, 64)
    top_mlp: Tuple[int, ...] = (512, 512, 256, 1)
    interaction: str = "dot"                 # dot | concat | self_attn | transformer
    # sequence models (sasrec / bst)
    seq_len: int = 50
    n_blocks: int = 2
    n_heads: int = 1
    dtype: str = "bfloat16"
    param_dtype: str = "float32"


# ---------------------------------------------------------------------------
# RankGraph-2 (the paper's own architecture)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RQConfig:
    codebook_sizes: Tuple[int, ...] = (5000, 50)
    zeta1: float = 10.0
    zeta2: float = 0.01
    hist_len: int = 1000         # rolling batches for p-hat
    commit_coef: float = 0.25
    biased_selection: bool = True
    regularize: bool = True
    # utilization balancing + self-healing (dead-code reset)
    util_coef: float = 1.0       # weight of the soft-usage entropy gap
    usage_ema: float = 0.99      # decay of the per-code EMA usage counter
    dead_floor: float = 0.25     # dead if usage < dead_floor / n_codes
    reset_every: int = 0         # burst steps between reset passes (0=off)
    reset_probe: int = 512       # nodes embedded per reset/repair probe


@dataclasses.dataclass(frozen=True)
class RankGraph2Config:
    name: str = "rankgraph2"
    d_user_feat: int = 64
    d_item_feat: int = 64
    d_embed: int = 256
    n_heads: int = 4             # multi-head embeddings (neg augmentation)
    d_hidden: int = 512
    k_imp: int = 50              # pre-computed PPR neighbors
    k_train: int = 10            # sampled per training edge
    n_negatives: int = 100
    n_pool_neg: int = 32         # from rolling out-of-batch pool
    margin: float = 0.1
    tau: float = 0.06
    # training hot path
    use_fused_contrastive: bool = False   # fused loss kernel (fwd + bwd)
    reuse_lprime_negatives: bool = True   # share negs between L and L'
    rq: RQConfig = dataclasses.field(default_factory=RQConfig)
    # graph construction
    alpha_pop: float = 0.3       # popularity bias exponent
    c_u: int = 2                 # min common items for U-U edge
    c_i: int = 2                 # min common users for I-I edge
    k_cap: int = 64              # top-K edges kept per node
    ppr_walks: int = 64
    ppr_len: int = 5
    ppr_restart: float = 0.15
    dtype: str = "bfloat16"
    param_dtype: str = "float32"


# ---------------------------------------------------------------------------
# Shapes + registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    step: str                     # "train" | "prefill" | "decode" | "serve"
    dims: Dict[str, int]


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                   # "lm" | "recsys" | "rankgraph2"
    config: Any
    shapes: Tuple[ShapeSpec, ...]
    source: str = ""

    def shape(self, name: str) -> ShapeSpec:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.arch_id} has no shape {name!r}; "
                       f"have {[s.name for s in self.shapes]}")


_REGISTRY: Dict[str, ArchSpec] = {}


def register(spec: ArchSpec) -> ArchSpec:
    _REGISTRY[spec.arch_id] = spec
    return spec


def get_arch(arch_id: str) -> ArchSpec:
    _ensure_loaded()
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]


def list_archs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


LM_SHAPES = (
    ShapeSpec("train_4k", "train", dict(seq_len=4096, global_batch=256)),
    ShapeSpec("prefill_32k", "prefill", dict(seq_len=32768, global_batch=32)),
    ShapeSpec("decode_32k", "decode", dict(seq_len=32768, global_batch=128)),
    ShapeSpec("long_500k", "decode", dict(seq_len=524288, global_batch=1)),
)

RECSYS_SHAPES = (
    ShapeSpec("train_batch", "train", dict(batch=65536)),
    ShapeSpec("serve_p99", "serve", dict(batch=512)),
    ShapeSpec("serve_bulk", "serve", dict(batch=262144)),
    ShapeSpec("retrieval_cand", "serve", dict(batch=1, n_candidates=1_000_000)),
)

RANKGRAPH2_SHAPES = (
    ShapeSpec("train_batch", "train", dict(batch=32768)),
    ShapeSpec("serve_p99", "serve", dict(batch=512)),
    ShapeSpec("serve_bulk", "serve", dict(batch=262144)),
    ShapeSpec("retrieval_cand", "serve", dict(batch=1, n_candidates=1_000_000)),
)


_LOADED = False


def _ensure_loaded() -> None:
    """Import every config module so that its ``register`` call runs."""
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    from repro_torch.configs import (  # noqa: F401
        bst, dlrm_rm2, gemma_2b, grok_1_314b, kimi_k2_1t_a32b, llama3_2_3b,
        olmo_1b, rankgraph2, sasrec, wide_deep)
