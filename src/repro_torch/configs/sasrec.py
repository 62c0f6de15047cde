"""sasrec [arXiv:1808.09781]: embed 50, 2 blocks, 1 head, seq 50,
self-attention sequence interaction."""
from repro_torch.configs.base import (ArchSpec, RECSYS_SHAPES, RecsysConfig,
                                      register)

CONFIG = RecsysConfig(
    name="sasrec", kind="sasrec", n_sparse=0, embed_dim=50, seq_len=50,
    n_blocks=2, n_heads=1, default_vocab=10_000_000,
    interaction="self_attn")

register(ArchSpec("sasrec", "recsys", CONFIG, RECSYS_SHAPES,
                  source="arXiv:1808.09781"))
