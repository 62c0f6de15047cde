"""RankGraph-2 config dataclasses, field for field as in the JAX package
(``repro/configs/base.py``), plus the rankgraph2 shape table."""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


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


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    step: str                     # "train" | "serve"
    dims: Dict[str, int]


RANKGRAPH2_SHAPES = (
    ShapeSpec("train_batch", "train", dict(batch=32768)),
    ShapeSpec("serve_p99", "serve", dict(batch=512)),
    ShapeSpec("serve_bulk", "serve", dict(batch=262144)),
    ShapeSpec("retrieval_cand", "serve", dict(batch=1, n_candidates=1_000_000)),
)
