"""dlrm-rm2 [arXiv:1906.00091]: 13 dense, 26 sparse, embed 64,
bot 13-512-256-64, top 512-512-256-1, dot interaction."""
from repro_torch.configs.base import (ArchSpec, RECSYS_SHAPES, RecsysConfig,
                                      register)

CONFIG = RecsysConfig(
    name="dlrm-rm2", kind="dlrm", n_dense=13, n_sparse=26, embed_dim=64,
    default_vocab=10_000_000, bot_mlp=(512, 256, 64),
    top_mlp=(512, 512, 256, 1), interaction="dot")

register(ArchSpec("dlrm-rm2", "recsys", CONFIG, RECSYS_SHAPES,
                  source="arXiv:1906.00091"))
