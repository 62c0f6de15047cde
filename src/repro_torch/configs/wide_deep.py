"""wide-deep [arXiv:1606.07792]: 40 sparse fields, embed 32,
deep MLP 1024-512-256, concat interaction + linear wide part."""
from repro_torch.configs.base import (ArchSpec, RECSYS_SHAPES, RecsysConfig,
                                      register)

CONFIG = RecsysConfig(
    name="wide-deep", kind="wide_deep", n_dense=0, n_sparse=40, embed_dim=32,
    default_vocab=10_000_000, bot_mlp=(1024, 512, 256),
    interaction="concat")

register(ArchSpec("wide-deep", "recsys", CONFIG, RECSYS_SHAPES,
                  source="arXiv:1606.07792"))
