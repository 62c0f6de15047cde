"""Config dataclasses, field for field as in the JAX package
(``repro/configs/base.py``): the recsys family's ``RecsysConfig`` and
RankGraph-2's own, their shape tables, and the architecture registry
(``--arch <id>`` -> ``ArchSpec``) for the archs the port has: the four
recsys archs and ``rankgraph2``."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple


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
    step: str                     # "train" | "serve"
    dims: Dict[str, int]


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                   # "recsys" | "rankgraph2"
    config: Any
    shapes: Tuple[ShapeSpec, ...]
    source: str = ""


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
        bst, dlrm_rm2, rankgraph2, sasrec, wide_deep)
