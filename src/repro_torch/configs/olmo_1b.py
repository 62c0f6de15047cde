"""olmo-1b [arXiv:2402.00838; hf]: 16L d=2048 16H (GQA kv=16) ff=8192
vocab=50304 — non-parametric LayerNorm."""
from repro_torch.configs.base import ArchSpec, LMConfig, LM_SHAPES, register

CONFIG = LMConfig(
    name="olmo-1b", n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab_size=50304, act="silu", norm="layernorm_np",
    tie_embeddings=True, optimizer="adamw")

register(ArchSpec("olmo-1b", "lm", CONFIG, LM_SHAPES,
                  source="arXiv:2402.00838"))
