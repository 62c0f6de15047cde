"""rankgraph2 — the paper's own architecture (production hyperparameters
from §5.1: batch 32768, embed 256, RQ codebooks 5000 x 50, K_IMP=50,
K'=10, 100 negatives)."""
from repro_torch.configs.base import RQConfig, RankGraph2Config

CONFIG = RankGraph2Config(
    name="rankgraph2", d_user_feat=256, d_item_feat=256, d_embed=256,
    n_heads=4, d_hidden=1024, k_imp=50, k_train=10, n_negatives=100,
    n_pool_neg=32,
    # self-healing index: utilization-balancing on by default plus an
    # in-burst dead-code reset cadence (EMA floor, keyed-uniform reseed)
    rq=RQConfig(codebook_sizes=(5000, 50), util_coef=1.0,
                usage_ema=0.99, dead_floor=0.25, reset_every=100))
