"""gemma-2b [arXiv:2403.08295; hf]: 18L d=2048 8H MQA (kv=1) ff=16384
vocab=256000 — GeGLU, head_dim=256, embeddings tied + sqrt(d) scaling."""
from repro_torch.configs.base import ArchSpec, LMConfig, LM_SHAPES, register

CONFIG = LMConfig(
    name="gemma-2b", n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1,
    head_dim=256, d_ff=16384, vocab_size=256000, act="gelu",
    norm="rmsnorm_p1", rope_theta=10000.0, tie_embeddings=True,
    optimizer="adamw")

register(ArchSpec("gemma-2b", "lm", CONFIG, LM_SHAPES,
                  source="arXiv:2403.08295"))
