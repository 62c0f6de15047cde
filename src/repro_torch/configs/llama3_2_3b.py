"""llama3.2-3b [hf:meta-llama]: 28L d=3072 24H (GQA kv=8) ff=8192
vocab=128256."""
from repro_torch.configs.base import ArchSpec, LMConfig, LM_SHAPES, register

CONFIG = LMConfig(
    name="llama3.2-3b", n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=8192, vocab_size=128256, act="silu", norm="rmsnorm",
    rope_theta=500000.0, optimizer="adamw")

register(ArchSpec("llama3.2-3b", "lm", CONFIG, LM_SHAPES,
                  source="hf:meta-llama/Llama-3.2-3B"))
