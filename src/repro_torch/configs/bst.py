"""bst [arXiv:1905.06874] (Alibaba Behavior Sequence Transformer):
embed 32, seq 20, 1 block, 8 heads, MLP 1024-512-256."""
from repro_torch.configs.base import (ArchSpec, RECSYS_SHAPES, RecsysConfig,
                                      register)

CONFIG = RecsysConfig(
    name="bst", kind="bst", n_sparse=8, embed_dim=32, seq_len=20,
    n_blocks=1, n_heads=8, default_vocab=10_000_000,
    top_mlp=(1024, 512, 256, 1), interaction="transformer")

register(ArchSpec("bst", "recsys", CONFIG, RECSYS_SHAPES,
                  source="arXiv:1905.06874"))
